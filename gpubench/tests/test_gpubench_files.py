"""BENCHMARK.json against the contract's form, and the harness finding every
configuration, mix, cell and metric by name, a new one added as files too."""

import json
import re
import shutil
from pathlib import Path

import pytest

from gpubench import common

ROOT = Path(common.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = common.benchmark()


def test_benchmark_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"] and BENCH["command"][1] == "gpubench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        layers.setdefault(m["layer"], set())
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(pairs) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_and_reports(cell):
    files = common.cell_files(BENCH, cell)
    assert files["cell"]["why"] == files["workload"]["why"]
    assert callable(files["loop"].run)
    e2e = {m["name"] for m in common.metrics_for(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = common.metrics_for(BENCH, cell, "per_layer")
    assert per_layer and {m["moves"] for m in per_layer} <= e2e
    for m in per_layer:
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").is_file()


def test_new_cell_and_metric_from_added_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "unet3d-bf16.train-16vol", "config": "unet3d-bf16",
                               "traffic": "train-16vol", "chips": 1, "why": "16 host volumes"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("unet3d-bf16.train-16vol")
    bench["per_layer"].append({"name": "loader_wait_ms.train", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "trainer, host data",
                               "moves": "train_samples_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((ROOT / "gpubench/traffic/train-8vol.json").read_text())
    (root / "gpubench/traffic/train-16vol.json").write_text(json.dumps({**mix, "volumes": 16}))
    (root / "gpubench/cells/unet3d-bf16.train-16vol.json").write_text(
        json.dumps({"why": "16 host volumes", "limits": {"logit_err": 0.1}}))
    (root / "gpubench/metrics/loader_wait_ms.train.py").write_text(
        "def read(layer):\n    return 1.5 if layer['kind'] == 'train' else None\n")

    loaded = common.load_json(root / "BENCHMARK.json")
    files = common.cell_files(loaded, "unet3d-bf16.train-16vol", root / "gpubench")
    assert files["mix"]["volumes"] == 16 and files["cell"]["limits"] == {"logit_err": 0.1}
    assert callable(files["loop"].run)
    names = [m["name"] for m in common.metrics_for(loaded, "unet3d-bf16.train-16vol",
                                                    "per_layer")]
    assert "loader_wait_ms.train" in names and "device_idle_share.train" not in names
    # a metric without a list is read in every cell that reports what it moves
    assert "loader_wait_ms.train" in [m["name"] for m in
                                      common.metrics_for(loaded, "unet3d-bf16.train", "per_layer")]
    layer = {"kind": "train", "trace": None, "units": 0, "window_peak_bytes": 0}
    got = common.read_per_layer(loaded, "unet3d-bf16.train-16vol", layer, root / "gpubench")
    assert got == {"loader_wait_ms.train": {"value": 1.5, "unit": "ms"}}
