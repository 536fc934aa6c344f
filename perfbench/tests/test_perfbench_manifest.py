"""BENCHMARK.json and the files it names, against the rules it must keep."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "perfbench/run.py"]
    assert manifest["paths"] == ["perfbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)


def test_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}


def test_every_cell_reports_what_it_must(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    for cell in cells:
        e2e = [m["name"] for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in manifest["per_layer"] if cell in m.get("workloads", [cell])]
        assert layers
        for m in layers:
            assert m["moves"] in e2e


def test_files_found_by_name(manifest):
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in manifest["workloads"]:
        assert (ROOT / "perfbench" / "configs" / f"{w['config']}.json").is_file()
        traffic = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert traffic["kind"] in ("train", "serve")
        limits = json.loads((ROOT / "perfbench" / "limits" / f"{w['name']}.json").read_text())
        assert all(v["limit"] > 0 for v in limits.values())
    for m in manifest["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def test_widths_are_published(manifest):
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        m = cfg["materials"]
        assert m["layer_widths"] == [64, 64] and m["lora_r"] == 16 and m["lora_alpha"] == 16
        assert not {"layer_widths", "lora_r", "sh_degree"} & set(c["reduced"])
