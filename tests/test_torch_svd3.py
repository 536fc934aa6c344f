"""The batched 3x3 SVD's surroundings on the CPU (``ops/svd3.py``).

On CPU tensors ``svd3c`` and every material run the component code and
never build or launch a kernel. The autograd Function's kernel branch,
with the plain versions standing in for K6 and K7, gives the component
path's factors and gradients bit for bit: one saved buffer, ``None``
cotangents, the strided views of one (N, 9) buffer, an expanded
cotangent. The kernel wrappers refuse CPU tensors. K6 and K7 themselves
run on the card (``test_torch_kernels_cuda.py``), which imports this
file's material list, so the file imports no JAX.
"""
import importlib

import numpy as np
import pytest
import torch

from neuma_tpu_torch import kernels
from neuma_tpu_torch import materials as tm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

svd3m = importlib.import_module("neuma_tpu_torch.ops.svd3")

SPLINE_CFG = {"num_side_points": 4, "xk_max": 2.0, "yk_max": 0.5, "alpha": 1e-2}
# every family of the port, with the configurations the parity tests use
MATERIALS = [
    ("InvariantFullMetaElasticity", None), ("InvariantFullMetaPlasticity", None),
    ("PolarMetaElasticity", None), ("PolarMetaPlasticity", None),
    ("InvariantMetaElasticity", None), ("SVDMetaElasticity", None), ("SVDMetaPlasticity", None),
    ("PlainMetaElasticity", None), ("PlainMetaPlasticity", None),
    ("SplineMetaElasticity", SPLINE_CFG), ("SplineMetaPlasticity", SPLINE_CFG),
    ("CorotatedElasticity", {"E": 2e5, "nu": 0.3}),
    ("StVKElasticity", {"E": 1e5, "nu": 0.25}),
    ("VolumeElasticity", {"E": 1e5, "nu": 0.3, "mode": "taichi"}),
    ("SigmaElasticity", {"E": 1e5, "nu": 0.3}),
    ("IdentityPlasticity", {}), ("SigmaPlasticity", {}),
    ("VonMisesPlasticity", {"E": 1e5, "nu": 0.3, "sigma_y": 1e3}),
    ("DruckerPragerPlasticity", {"E": 1e5, "nu": 0.3, "friction_angle": 30.0}),
]
MATERIAL_IDS = [name for name, _ in MATERIALS]


def make_material(name, cfg, device="cpu"):
    """A material of the family ``name``: meta families with (16, 16)
    hidden widths and LoRA r 4 whose B is drawn nonzero, so every term
    counts; splines and presets from their configurations."""
    cls = getattr(tm, name)
    if name.startswith("Spline"):
        return cls.init(cfg, device=device)
    if "Meta" in name:
        gen = torch.Generator().manual_seed(MATERIAL_IDS.index(name))
        mat = cls.init(tm.MetaMaterialConfig(layer_widths=(16, 16), alpha=1e-2), gen)
        mat.init_lora(gen, 4, 8.0)
        with torch.no_grad():
            for n, p in mat.named_parameters():
                if n.endswith("lora_b"):
                    p.copy_(0.2 * torch.randn(p.shape, generator=gen))
        return mat.to(device)
    return cls(cfg).to(device)


def near_identity(n, seed=0, scale=0.05):
    """I + scale N, det > 0.2: the sim's regime of F."""
    rng = np.random.default_rng(seed)
    F = np.eye(3, dtype=np.float32) + scale * rng.standard_normal((4 * n, 3, 3)).astype(np.float32)
    return torch.as_tensor(F[np.linalg.det(F) > 0.2][:n])


def value_and_grad(fn, F, W):
    """``fn(F)`` and the gradient of sum(fn(F) W) at F."""
    F = F.clone().requires_grad_(True)
    out = fn(F)
    (g,) = torch.autograd.grad((out * W).sum(), F)
    return out.detach(), g


def use_plain_kernels(monkeypatch):
    """From here on, the Function's kernel branch on CPU tensors, with
    the plain versions of K6 and K7 in the kernels' places. Returns the
    list that collects the cotangents each adjoint receives."""
    seen = []

    def bwd(saved, cots):
        seen.append(cots)
        return svd3m.svd3_bwd_plain(saved, cots)

    monkeypatch.setattr(svd3m, "_on_card", lambda F9: True)
    monkeypatch.setattr(svd3m, "run_svd3_fwd", svd3m.svd3_fwd_plain)
    monkeypatch.setattr(svd3m, "run_svd3_bwd", bwd)
    return seen


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("name,cfg", MATERIALS, ids=MATERIAL_IDS)
def test_material_on_cpu_builds_and_launches_no_kernel(name, cfg):
    kernels.reset_launches()
    mat = make_material(name, cfg)
    out, g = value_and_grad(mat, near_identity(32), torch.ones(32, 3, 3))
    assert torch.isfinite(out).all() and torch.isfinite(g).all()
    assert not kernels.launches and kernels._lib is None


def test_svd3c_on_cpu_builds_and_launches_no_kernel():
    kernels.reset_launches()
    F = near_identity(16, scale=0.3).requires_grad_(True)
    u9, s3, vh9 = svd3m.svd3c(svd3m.unpack33(F))
    sum(c.sum() for c in (*u9, *s3, *vh9)).backward()
    assert F.grad is not None and not kernels.launches and kernels._lib is None


# Each loss reads some of the 21 factors (these rows), so the others'
# cotangents are None; "s0" sums sigma[0] unweighted, whose cotangent is
# then an expanded tensor.
LOSSES = {"all": range(21), "u": range(9), "sigma": range(9, 12), "vh": range(12, 21),
          "s0": (9,)}


def _svd_value_and_grad(F, loss):
    """The 21 factors of ``svd3c`` on the views of F's (N, 9) buffer and
    the gradient at F of the sum of the factors ``loss`` reads, weighted."""
    F = F.clone().requires_grad_(True)
    W = torch.randn((21,) + F.shape[:1], generator=torch.Generator().manual_seed(4))
    u9, s3, vh9 = svd3m.svd3c(svd3m.unpack33(F))
    f = [*u9, *s3, *vh9]
    total = sum((f[k] if loss == "s0" else f[k] * W[k]).sum() for k in LOSSES[loss])
    (g,) = torch.autograd.grad(total, F)
    return torch.stack(f).detach(), g


@pytest.mark.parametrize("loss", sorted(LOSSES))
def test_kernel_branch_matches_the_component_path(loss, monkeypatch):
    F = near_identity(40, seed=3, scale=0.3)
    want = _svd_value_and_grad(F, loss)
    seen = use_plain_kernels(monkeypatch)
    got = _svd_value_and_grad(F, loss)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
    assert [c is not None for c in seen[0]] == [k in LOSSES[loss] for k in range(21)]


@pytest.mark.parametrize("name", ["InvariantFullMetaElasticity", "InvariantFullMetaPlasticity",
                                  "PolarMetaElasticity", "SVDMetaPlasticity",
                                  "VonMisesPlasticity"])
def test_kernel_branch_material_matches_the_component_path(name, monkeypatch):
    mat = make_material(name, dict(MATERIALS)[name])
    F = near_identity(48, seed=5, scale=0.2)
    W = torch.randn((48, 3, 3), generator=torch.Generator().manual_seed(6))
    want = value_and_grad(mat, F, W)
    seen = use_plain_kernels(monkeypatch)
    got = value_and_grad(mat, F, W)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want)) and len(seen) == 1


def test_svd3_wrappers_refuse_cpu_tensors():
    F9 = svd3m.unpack33(near_identity(4))
    with pytest.raises(ValueError, match="CUDA"):
        svd3m.run_svd3_fwd(F9)
    with pytest.raises(ValueError, match="CUDA"):
        svd3m.run_svd3_bwd(svd3m.svd3_fwd_plain(F9), [None] * 21)
    assert not kernels.launches and kernels._lib is None
