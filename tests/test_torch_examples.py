"""The port's end-to-end example, ``neuma_tpu_torch/examples/smoke_e2e.py``
(the counterpart of the JAX package's ``examples/smoke_e2e.py``), on the
CPU at its smallest size: a 32x32 scene of 2 frames, one epoch per
stage, then the render CLI; and its refusal to run without a card unless
asked for the CPU. ``chip_smoke.py`` runs it on the card."""
import json

import numpy as np
import pytest
import torch

from neuma_tpu_torch.examples import smoke_e2e
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL = ["--size", "32", "--frames", "2", "--epochs", "1"]


def test_smoke_e2e_trains_and_renders_on_the_cpu(tmp_path, capsys):
    work = tmp_path / "smoke"
    out = smoke_e2e.main(["--device", "cpu", "--workdir", str(work), *SMALL])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == out
    assert out["ok"] and out["device"] == "cpu" and out["frames"] == 5 and out["launches"] == {}
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    exp = work / "logs" / "smoke"
    for name in ("config.yaml", "metrics.jsonl", "finetune/init.npz", "finetune/0001_lora.npz"):
        assert (exp / name).is_file(), name
    assert sorted(p.name for p in (exp / "results" / "smoke").glob("*.png")) == [
        f"d_0_{s:04d}.png" for s in range(1, 6)]


def test_smoke_e2e_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the no-device refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        smoke_e2e.main(["--workdir", str(tmp_path / "smoke"), *SMALL])
    assert not (tmp_path / "smoke").exists()
