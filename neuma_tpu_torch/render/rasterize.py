"""Tile-based 3D Gaussian splatting rasterizer on the tile-composite kernels.

Counterpart of ``neuma_tpu/render/rasterize.py``: ``RasterConfig``,
``_project`` (EWA projection with the 1.3x tan-fov clamp and the +0.3
low-pass), ``_sh_colors``, ``_tile_ranges``, ``_build_aligned_pairs``
(with ``max_per_tile``, also ``_build_tile_lists``'s cut), the
pair-feature gather ``_gather_pair_feats``, ``rasterize_with_aux`` and
``rasterize`` (the same without the aux). Pairs are binned by one
stable sort by tile id over depth-ordered pairs, each tile range is
padded to a multiple of ``CHUNK`` = 32, and the composite runs in K4
forward and K5 backward (``raster_kernel.composite_pairs``) on every
backend.

The transpose of the pair-feature gather (many pairs per Gaussian) is
the JAX package's scatter-free ``pair_grad='segsum'`` reduction: the pair
cotangents are gathered back into the depth-sorted pre-binned order,
where each Gaussian's pairs form one contiguous run, each run is summed
by a segmented doubling in a fixed order, and the depth sort is undone
by a gather. No atomics, so the gradient repeats bit for bit on the card.

``RasterConfig.backend`` says where the composite runs and on which
pair lists: ``"auto"`` runs K4/K5 on CUDA tensors and their plain
versions on CPU tensors, over every tile's whole depth list, as the TPU
path computes; the port is held to that path. ``"jnp"`` is the JAX
package's jnp backend, which that package runs on every device that is
not a TPU (an H100 included): each tile's depth-ordered list is cut
after its first ``max_per_tile`` pairs (``_build_tile_lists``) and
``overflow`` also fires when a tile held more; the same K4/K5 (plain
versions on CPU tensors) composite and differentiate the cut lists, to
rounding the jnp scan's function (it forms the transmittance by prefix
products where K4 walks the slots). A user who wants the JAX package's
images on a GPU asks for ``"jnp"``. ``"pallas"`` asks for the kernels
and raises on CPU tensors; ``"pallas_interpret"`` asks for the plain
versions (the JAX package's interpreter for debugging its kernels) and
raises on CUDA tensors.

The other knobs of the JAX package's ``RasterConfig`` are accepted,
validated with its messages, and compute nothing different:
``pair_binning`` (that package states that its counting and sort
binners give identical tile lists; the port keeps its one stable sort),
``pair_grad`` (its ``scatter`` and ``segsum`` transposes give the same
gradient; the port runs the ordered segmented sum above for both,
since a scatter-add on the card would be a float atomic and break the
bitwise rerun), ``segment`` (the jnp scan's remat length, which changes
no value; K4/K5 rematerialise nothing per segment) and
``scale_modifier`` (stored and read nowhere, as in that package).

``RasterConfig.tile_sharding`` (``parallel.sharding.tile_sharding(mesh,
axis)``) splits the image tiles over a mesh axis on every backend,
where the JAX package splits its jnp composite: every rank of the axis
builds the same pairs (the Gaussian tables stay replicated), composites
its contiguous range of tiles and gathers T and C over the axis, so
every rank gets the whole image, bit for bit one process's. Its
backward gives every rank of the axis the gradient of the whole image,
as GSPMD does: K5 runs on the rank's own tiles with its own cotangent
rows and the ranges' pair rows are gathered, not added
(``raster_kernel.composite_pairs_sharded`` states why). Every rank of
the axis must render, with the same inputs and the same loss of the
image.

Every ``argsort``/``sort`` passes ``stable=True``: ties (invisible
Gaussians at +inf depth, equal tile ids) must keep index order, or
``last`` and the image change.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

import torch

from ..ops.sh import sh_basis
from ..utils.profiling import span
from .camera import Camera
from .raster_kernel import CHUNK, PIX, composite_pairs, composite_pairs_sharded

if TYPE_CHECKING:
    from ..parallel.sharding import TileSharding

TILE = 16
BACKENDS = ("auto", "jnp", "pallas", "pallas_interpret")


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterization bounds and backend choice (per scene); the
    JAX package's fields, defaults and order (module docstring)."""

    max_pairs: int = 262144  # total (gaussian, tile) pairs after culling
    max_per_tile: int = 1024  # compositing depth per tile (jnp backend)
    segment: int = 32  # the JAX package's jnp scan remat length; changes no value
    scale_modifier: float = 1.0  # stored, read nowhere (as in the JAX package)
    backend: str = "auto"  # 'auto' | 'jnp' | 'pallas' | 'pallas_interpret'
    # 'scatter' | 'segsum': the same gradient; both run the ordered segmented sum.
    pair_grad: str = "scatter"
    # 'auto' | 'counting' | 'sort': the same tile lists; all run the one stable sort.
    pair_binning: str = "auto"
    # Image-tile sharding over a mesh axis (parallel/sharding.py::tile_sharding;
    # module docstring). None: one process composites every tile.
    tile_sharding: Optional["TileSharding"] = None

    def __post_init__(self):
        if not self.max_pairs < (1 << 24):
            raise ValueError(
                f"max_pairs ({self.max_pairs}) must stay below 2^24: pair "
                "placement relies on exact f32 integer arithmetic in the reference"
            )
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend: {self.backend!r}")
        if self.pair_binning not in ("auto", "counting", "sort"):
            raise ValueError(f"unknown pair_binning: {self.pair_binning!r}")
        if self.pair_grad not in ("scatter", "segsum"):
            raise ValueError(f"unknown pair_grad: {self.pair_grad!r}")


def _project(means3d: torch.Tensor, cov3d: torch.Tensor, camera: Camera):
    """(depth, visible, mean2d, conic, radius), as CUDA ``preprocess``."""
    n = means3d.shape[0]
    hom = torch.cat([means3d, torch.ones((n, 1), dtype=means3d.dtype, device=means3d.device)], 1)
    p_view = hom @ camera.world_view
    depth = p_view[:, 2]
    in_frustum = depth > 0.2

    p_hom = hom @ camera.full_proj
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    mean2d = torch.stack(
        [
            ((p_proj[:, 0] + 1.0) * camera.width - 1.0) * 0.5,
            ((p_proj[:, 1] + 1.0) * camera.height - 1.0) * 0.5,
        ],
        dim=1,
    )

    focal_x, focal_y = camera.focal_x, camera.focal_y
    tx, ty, tz = p_view[:, 0], p_view[:, 1], p_view[:, 2]
    tz = torch.where(torch.abs(tz) < 1e-6, 1e-6, tz)
    limx = 1.3 * camera.tan_fov_x
    limy = 1.3 * camera.tan_fov_y
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz

    j00 = focal_x / tz
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = focal_y / tz
    j12 = -(focal_y * ty) / (tz * tz)
    W = camera.world_view[:3, :3].T
    t0 = [j00 * W[0, c] + j02 * W[2, c] for c in range(3)]
    t1 = [j11 * W[1, c] + j12 * W[2, c] for c in range(3)]

    sxx, sxy, sxz = cov3d[:, 0], cov3d[:, 1], cov3d[:, 2]
    syy, syz, szz = cov3d[:, 3], cov3d[:, 4], cov3d[:, 5]

    def sig_row(u):
        return (
            u[0] * sxx + u[1] * sxy + u[2] * sxz,
            u[0] * sxy + u[1] * syy + u[2] * syz,
            u[0] * sxz + u[1] * syz + u[2] * szz,
        )

    s0 = sig_row(t0)
    s1 = sig_row(t1)
    a = s0[0] * t0[0] + s0[1] * t0[1] + s0[2] * t0[2] + 0.3
    b = s0[0] * t1[0] + s0[1] * t1[1] + s0[2] * t1[2]
    c = s1[0] * t1[0] + s1[1] * t1[1] + s1[2] * t1[2] + 0.3
    det = a * c - b * b
    det_ok = det != 0.0
    det_inv = 1.0 / torch.where(det_ok, det, 1.0)
    conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], dim=1)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))
    radius = torch.where(in_frustum & det_ok, radius, 0.0)
    return depth, in_frustum & det_ok, mean2d, conic, radius


def _sh_colors(shs, means3d, campos, sh_degree: int) -> torch.Tensor:
    """SH -> RGB with the +0.5 offset and clamp at zero."""
    d = means3d - campos[None, :]
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)
    k = (sh_degree + 1) ** 2
    rgb = torch.einsum("nkc,nk->nc", shs[:, :k, :], sh_basis(sh_degree, d))
    return torch.clamp(rgb + 0.5, min=0.0)


def _tile_ranges(mean2d, radius, width: int, height: int):
    """Tile rect per Gaussian (inclusive-exclusive), CUDA ``getRect``."""
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE

    def tdiv(v, hi):  # float -> int truncation toward zero, then clip
        return torch.clamp((v / TILE).to(torch.int32).to(torch.int64), 0, hi)

    x0 = tdiv(mean2d[:, 0] - radius, tiles_x)
    y0 = tdiv(mean2d[:, 1] - radius, tiles_y)
    x1 = tdiv(mean2d[:, 0] + radius + TILE - 1, tiles_x)
    y1 = tdiv(mean2d[:, 1] + radius + TILE - 1, tiles_y)
    return x0, y0, x1, y1, tiles_x, tiles_y


def _build_aligned_pairs(
    depth, visible, mean2d, radius, width, height, cfg: RasterConfig, with_glue: bool = False,
    max_per_tile: Optional[int] = None,
):
    """Per-tile contiguous pair ranges in depth order, each padded to a
    multiple of CHUNK. Returns (pair_gid (P,), counts (T,), tile_start
    (T+1,), tiles_x, tiles_y, overflow) with P = max_pairs + CHUNK * T
    (max_pairs rounded up to CHUNK); pad slots hold gaussian 0 and are
    masked by the counts. With ``with_glue`` a seventh item carries the
    integer layout of the gather's transpose: the final slot of each
    pre-binned pair (P where it was dropped), its run id, each
    depth-sorted Gaussian's run bounds and the inverse depth order.

    With ``max_per_tile`` (the jnp backend) each tile keeps its first
    ``max_per_tile`` pairs in depth order, as the JAX package's
    ``_build_tile_lists`` cuts them: a cut pair goes to the dropped slot,
    ``counts`` are the kept counts and ``overflow`` also fires when any
    tile held more. Without it every tile keeps all its pairs, and
    ``max_pairs`` must be a multiple of CHUNK (the guard of the JAX
    package's ``_build_aligned_pairs``)."""
    if max_per_tile is None and cfg.max_pairs % CHUNK:
        raise ValueError(
            f"max_pairs ({cfg.max_pairs}) must be a multiple of the kernel "
            f"CHUNK ({CHUNK}) so tile ranges stay CHUNK-aligned"
        )
    dev = depth.device
    n = depth.shape[0]
    x0, y0, x1, y1, tiles_x, tiles_y = _tile_ranges(mean2d, radius, width, height)
    num_tiles = tiles_x * tiles_y

    inf = torch.full((), float("inf"), device=dev)  # a fill, not a host copy
    order = torch.argsort(torch.where(visible, depth, inf), stable=True)
    x0s, x1s, y0s, y1s = x0[order], x1[order], y0[order], y1[order]
    vis_s = visible[order] & (radius[order] > 0)
    w_t = torch.where(vis_s, x1s - x0s, 0)
    h_t = torch.where(vis_s, y1s - y0s, 0)
    area = w_t * h_t
    offsets = torch.cumsum(area, 0)
    starts = offsets - area

    # Pair j belongs to the depth-sorted gaussian whose run holds it.
    pair_idx = torch.arange(cfg.max_pairs, device=dev)
    valid_pair = pair_idx < offsets[-1]
    g = torch.clamp(torch.searchsorted(offsets, pair_idx, right=True), max=n - 1)
    k = pair_idx - starts[g]
    tw = torch.clamp(w_t[g], min=1)
    ky = torch.div(k, tw, rounding_mode="floor")
    tile_id = torch.where(
        valid_pair, (y0s[g] + ky) * tiles_x + x0s[g] + (k - ky * tw), num_tiles
    )
    pair_orig = order[g]

    sorted_tile, pair_order = torch.sort(tile_id, stable=True)
    sorted_gid = pair_orig[pair_order]
    raw_start = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, device=dev), right=False
    )
    counts = raw_start[1:] - raw_start[:-1]
    overflow = offsets[-1] > cfg.max_pairs
    valid_s = sorted_tile < num_tiles
    ts = torch.clamp(sorted_tile, max=num_tiles - 1)
    slot = pair_idx - raw_start[ts]  # each pair's depth rank within its tile
    if max_per_tile is not None:
        overflow = overflow | (counts > max_per_tile).any()
        counts = torch.clamp(counts, max=max_per_tile)
        valid_s = valid_s & (slot < max_per_tile)

    aligned = ((counts + CHUNK - 1) // CHUNK) * CHUNK
    tile_start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(aligned, 0)])
    P = -(-cfg.max_pairs // CHUNK) * CHUNK + CHUNK * num_tiles
    dest = torch.where(valid_s, tile_start[ts] + slot, P)
    # Live pairs land on distinct slots; the rest share the dropped slot P.
    pair_gid = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    pair_gid[dest] = sorted_gid
    out = (pair_gid[:P], counts, tile_start, tiles_x, tiles_y, overflow)
    if not with_glue:
        return out
    final_of_orig = torch.empty_like(dest)
    final_of_orig[pair_order] = dest  # a permutation: no collisions
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, device=dev)
    return out + ((final_of_orig, starts[g], starts, offsets, inv_order),)


class _GatherPairFeats(torch.autograd.Function):
    """``feats[pair_gid]`` whose backward is the segmented-sum transpose
    of ``neuma_tpu/render/rasterize.py::_gather_pair_feats``. Only live
    pair slots (below ``tile_start[-1]``) are referenced by the glue, so
    the rows past it are dropped."""

    @staticmethod
    def forward(ctx, feats, pair_gid, glue):
        ctx.glue = glue
        ctx.n = feats.shape[0]
        return feats[pair_gid]

    @staticmethod
    @span("raster.composite.bwd")
    def backward(ctx, d_pf):
        final_of_orig, run_id, g_starts, g_ends, inv_order = ctx.glue
        max_pairs = final_of_orig.shape[0]
        ch = d_pf.shape[1]
        d_pad = torch.cat([d_pf, torch.zeros((1, ch), dtype=d_pf.dtype, device=d_pf.device)])
        s = d_pad[final_of_orig]  # (max_pairs, ch), pre-binned order
        # Segmented suffix doubling: s[i] becomes the tree sum of its run
        # from i to the run's end, so s[run start] is the Gaussian's sum.
        step = 1
        while step < max_pairs:
            s_shift = torch.cat([s[step:], torch.zeros((step, ch), dtype=s.dtype, device=s.device)])
            r_shift = torch.cat([run_id[step:], torch.full((step,), -1, dtype=run_id.dtype,
                                                           device=run_id.device)])
            s = s + torch.where((run_id == r_shift)[:, None], s_shift, 0.0)
            step *= 2
        live = (g_ends > g_starts) & (g_starts < max_pairs)
        sums = torch.where(live[:, None], s[torch.clamp(g_starts, max=max_pairs - 1)], 0.0)
        return sums[inv_order], None, None


def _gather_pair_feats(feats, pair_gid, glue):
    return _GatherPairFeats.apply(feats, pair_gid, glue)


def rasterize(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacity: torch.Tensor,
    camera: Camera,
    bg_color: torch.Tensor,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    sh_degree: int = 3,
    cfg: RasterConfig = RasterConfig(),
) -> torch.Tensor:
    """``rasterize_with_aux`` without the aux."""
    img, _ = rasterize_with_aux(
        means3d, cov3d, opacity, camera, bg_color, shs=shs, colors_precomp=colors_precomp,
        sh_degree=sh_degree, cfg=cfg,
    )
    return img


@span("raster.view")
def rasterize_with_aux(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    opacity: torch.Tensor,
    camera: Camera,
    bg_color: torch.Tensor,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    sh_degree: int = 3,
    cfg: RasterConfig = RasterConfig(),
) -> Tuple[torch.Tensor, dict]:
    """Render a (3, H, W) image; ``aux["overflow"]`` is a device bool
    that fires when pairs were dropped: past ``max_pairs``, or (backend
    ``"jnp"``) past ``max_per_tile`` in a tile.

    With ``cfg.tile_sharding`` every rank of its axis must call this with
    the same inputs: each composites its range of the tiles, and each
    returns the whole image, bit for bit one process's. Differentiated
    through a loss that every rank of the axis computes alike, every rank
    gets one process's gradient of every input (the module docstring)."""
    if cfg.backend.startswith("pallas") and means3d.is_cuda != (cfg.backend == "pallas"):
        want = "CUDA" if cfg.backend == "pallas" else "CPU"
        raise RuntimeError(
            f"RasterConfig(backend={cfg.backend!r}) needs {want} tensors: 'pallas' runs the "
            "CUDA kernels K4/K5, 'pallas_interpret' their plain versions, 'auto' and 'jnp' pick "
            "by device"
        )
    with span("raster.pairs"):
        opacity = opacity.reshape(-1)
        depth, visible, mean2d, conic, radius = _project(means3d, cov3d, camera)
        if colors_precomp is not None:
            colors = colors_precomp
        else:
            assert shs is not None, "need shs or colors_precomp"
            colors = _sh_colors(shs, means3d, camera.camera_center, sh_degree)

        # The gather's transpose glue is built only when a backward may run.
        with_glue = torch.is_grad_enabled()
        pairs = _build_aligned_pairs(
            depth, visible, mean2d, radius, camera.width, camera.height, cfg, with_glue=with_glue,
            max_per_tile=cfg.max_per_tile if cfg.backend == "jnp" else None,
        )
        pair_gid, counts, tile_start, tiles_x, tiles_y, overflow = pairs[:6]
        feats = torch.cat([mean2d, conic, opacity[:, None], colors], dim=1)
        pair_feats = _gather_pair_feats(feats, pair_gid, pairs[6]) if with_glue else feats[pair_gid]
        composite_args = (pair_feats.contiguous(), tile_start.to(torch.int32),
                          counts.to(torch.int32), tiles_x)
    with span("raster.composite"):
        if cfg.tile_sharding is None:
            T, Cflat = composite_pairs(*composite_args)
        else:
            T, Cflat = composite_pairs_sharded(*composite_args, cfg.tile_sharding.mesh,
                                               cfg.tile_sharding.axis)

    def assemble(flat):  # (num_tiles, PIX) -> (H', W')
        t = flat.reshape(tiles_y, tiles_x, TILE, TILE)
        return t.permute(0, 2, 1, 3).reshape(tiles_y * TILE, tiles_x * TILE)

    img = torch.stack(
        [assemble(Cflat[:, c * PIX : (c + 1) * PIX] + T * bg_color[c]) for c in range(3)]
    )
    return img[:, : camera.height, : camera.width], {"overflow": overflow}
