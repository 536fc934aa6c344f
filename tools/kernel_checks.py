"""Phases 1-2 of another tree's ``chip_smoke.py``, for before/after kernel
numbers in one call on the card.

    python3 tools/kernel_checks.py <tree> <out.json>

``<tree>`` holds a ``chip_smoke.py`` and its ``neuma_tpu_torch/`` (for
example a ``git archive`` of the parent commit unpacked under ``build/``).
The script builds that tree's kernels and runs its ``check_and_time`` at
both bench shapes: every kernel against its plain version, its CUDA-event
and device times and its work. Run it before and after the changed
tree's ``chip_smoke.py`` in the same call; the kernel records go to
``<out.json>`` with the card's ``nvidia-smi`` name and power limit.
"""
import json
import sys
from pathlib import Path

import torch


def main(root: Path, out: Path) -> int:
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from neuma_tpu_torch import kernels
    from neuma_tpu_torch.train.grounding import BENCH_SHAPES, build_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.library()
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    rec = {name: {} for name in cs.KERNELS}
    gen = torch.Generator().manual_seed(0)
    ok = True
    for tag in ("headline", "realworld"):
        p = BENCH_SHAPES[tag]
        scene = build_scene(**{k: v for k, v in p.items() if k != "frames"}, seed=0, device="cuda")
        ok &= cs.check_and_time(tag, cs.kernel_inputs(scene, gen), rec)
    out.write_text(json.dumps(dict(root=str(root), smi=smi, rec=rec), indent=1))
    print("[kernel_checks] ok" if ok else "[kernel_checks] FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    sys.exit(main(Path(sys.argv[1]).resolve(), Path(sys.argv[2])))
