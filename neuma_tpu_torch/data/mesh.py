"""Triangle-mesh I/O and geometry without trimesh: OBJ/PLY loading,
ray-parity point-in-mesh, area-weighted surface sampling, OBJ
export and a procedural icosphere.

Counterpart of ``neuma_tpu/data/mesh.py`` (``TriMesh``, ``load_obj``,
``load_ply_mesh``, ``load_mesh``, ``make_icosphere``), the same numpy
code, so both packages sample the same points from one ``default_rng``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (F, 3) int64

    @property
    def bounds(self) -> np.ndarray:
        return np.stack([self.vertices.min(0), self.vertices.max(0)])

    @property
    def triangles(self) -> np.ndarray:
        return self.vertices[self.faces]  # (F, 3, 3)

    @property
    def area(self) -> np.ndarray:
        t = self.triangles
        return 0.5 * np.linalg.norm(
            np.cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]), axis=1
        )

    def contains(self, points: np.ndarray, chunk: int = 2048) -> np.ndarray:
        """Ray-parity point-in-mesh test: count +x ray crossings
        (watertight assumption, matching trimesh.contains semantics for
        the reference's uniform sampler, tune/utils.py:157-168)."""
        points = np.asarray(points, np.float64)
        tris = self.triangles
        v0, v1, v2 = tris[:, 0], tris[:, 1], tris[:, 2]
        e1 = v1 - v0
        e2 = v2 - v0
        # Ray direction: slightly irrational to dodge edge-on hits.
        d = np.array([0.57735027, 0.30028311, 0.76095269])
        h = np.cross(d, e2)  # (F, 3)
        a = np.einsum("fi,fi->f", e1, h)
        valid_tri = np.abs(a) > 1e-12
        inv_a = np.where(valid_tri, 1.0 / np.where(valid_tri, a, 1.0), 0.0)

        inside = np.zeros(len(points), bool)
        for i in range(0, len(points), chunk):
            p = points[i : i + chunk]  # (C, 3)
            s = p[:, None, :] - v0[None, :, :]  # (C, F, 3)
            u = np.einsum("cfi,fi->cf", s, h) * inv_a[None, :]
            q = np.cross(s, e1[None, :, :])  # (C, F, 3)
            v = np.einsum("cfi,i->cf", q, d) * inv_a[None, :]
            t = np.einsum("cfi,fi->cf", q, e2) * inv_a[None, :]
            hit = (
                valid_tri[None, :]
                & (u >= 0)
                & (v >= 0)
                & (u + v <= 1)
                & (t > 1e-9)
            )
            inside[i : i + chunk] = (hit.sum(1) % 2) == 1
        return inside

    def sample_surface(self, n: int, rng=None) -> np.ndarray:
        """Area-weighted uniform surface sampling (reference
        ``surface_sampling`` uses trimesh.sample_surface_even;
        area-weighted uniform is the behavioral equivalent)."""
        rng = rng or np.random.default_rng(0)
        area = self.area
        probs = area / area.sum()
        idx = rng.choice(len(self.faces), size=n, p=probs)
        t = self.triangles[idx]
        r1 = np.sqrt(rng.random(n))[:, None]
        r2 = rng.random(n)[:, None]
        return (
            (1 - r1) * t[:, 0]
            + r1 * (1 - r2) * t[:, 1]
            + r1 * r2 * t[:, 2]
        )

    def export_obj(self, path) -> None:
        with open(path, "w") as f:
            for v in self.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for face in self.faces + 1:
                f.write(f"f {face[0]} {face[1]} {face[2]}\n")


def load_obj(path) -> TriMesh:
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return TriMesh(
        vertices=np.array(verts, np.float64),
        faces=np.array(faces, np.int64),
    )


def load_ply_mesh(path) -> TriMesh:
    """PLY with vertex + face elements (ascii or binary_little_endian,
    uchar-count int-index face lists)."""
    import struct

    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements = []  # (name, count, props) props: list of (type, name) or ('list', ctype, itype, name)
        while True:
            tokens = f.readline().decode("ascii").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append([tokens[1], int(tokens[2]), []])
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(
                        ("list", tokens[2], tokens[3], tokens[4])
                    )
                else:
                    elements[-1][2].append((tokens[1], tokens[2]))
            elif tokens[0] == "end_header":
                break

        type_fmt = {
            "char": "b", "int8": "b", "uchar": "B", "uint8": "B",
            "short": "h", "int16": "h", "ushort": "H", "uint16": "H",
            "int": "i", "int32": "i", "uint": "I", "uint32": "I",
            "float": "f", "float32": "f", "double": "d", "float64": "d",
        }
        verts = None
        faces = []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    verts = np.array(
                        [[float(r[i]) for i in range(3)] for r in rows]
                    )
                elif name == "face":
                    for r in rows:
                        n = int(r[0])
                        idx = [int(x) for x in r[1 : 1 + n]]
                        for k in range(1, n - 1):
                            faces.append([idx[0], idx[k], idx[k + 1]])
            else:
                if name == "vertex":
                    fmt_str = "<" + "".join(
                        type_fmt[p[0]] for p in props
                    )
                    sz = struct.calcsize(fmt_str)
                    data = [
                        struct.unpack(fmt_str, f.read(sz))
                        for _ in range(count)
                    ]
                    verts = np.array(
                        [row[:3] for row in data], np.float64
                    )
                elif name == "face":
                    ctype, itype = props[0][1], props[0][2]
                    cfmt, ifmt = type_fmt[ctype], type_fmt[itype]
                    csz = struct.calcsize(cfmt)
                    isz = struct.calcsize(ifmt)
                    for _ in range(count):
                        (n,) = struct.unpack(
                            "<" + cfmt, f.read(csz)
                        )
                        idx = struct.unpack(
                            f"<{n}{ifmt}", f.read(isz * n)
                        )
                        for k in range(1, n - 1):
                            faces.append(
                                [idx[0], idx[k], idx[k + 1]]
                            )
    return TriMesh(
        vertices=verts, faces=np.array(faces, np.int64)
    )


def load_mesh(path) -> TriMesh:
    path = Path(path)
    if path.suffix.lower() == ".obj":
        return load_obj(path)
    if path.suffix.lower() == ".ply":
        return load_ply_mesh(path)
    raise ValueError(f"unsupported mesh format: {path.suffix}")


def make_icosphere(radius: float = 1.0, subdivisions: int = 2) -> TriMesh:
    """Procedural test mesh (watertight)."""
    phi = (1 + 5 ** 0.5) / 2
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts = verts.tolist()

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (np.array(verts[a]) + np.array(verts[b])) / 2
                verts.append(m.tolist())
                edge_mid[key] = len(verts) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [
                [a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]
            ]
        verts = np.array(verts)
        faces = np.array(new_faces, np.int64)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True) * radius
    return TriMesh(vertices=verts, faces=faces)
