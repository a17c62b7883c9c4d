"""The harness's plumbing: files found by name, the import check, the device and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: a traffic mix, the parameters of one loop;
  its ``loop`` names ``loops/<loop>.py``, the code that drives that kind of
  traffic;
* ``cells/<cell>.json``: the cell's limits for ``correct`` and its ``why``;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(layer)``,
  which returns a number or None when the run has nothing for it to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_segmentation_project_tpu")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload '{name}' in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(bench: dict, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell's workload entry, configuration, traffic mix, cell file and loop module."""
    w = workload(bench, name)
    mix = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return {
        "workload": w,
        "config": load_json(bench_dir.parent / config_entry["file"]),
        "mix": mix,
        "cell": load_json(bench_dir / "cells" / f"{name}.json"),
        "loop": load_module(bench_dir / "loops" / f"{mix['loop']}.py", f"gpubench_loop_{mix['loop']}"),
    }


def metrics_for(bench: dict, name: str, kind: str) -> list:
    """The ``kind`` metrics ("end_to_end" or "per_layer") that cell ``name``
    reports: those that list it, and those without a list whose moved
    end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]}
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if m["name"] in e2e]
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def read_per_layer(bench: dict, name: str, layer: dict, bench_dir: Path = BENCH_DIR) -> dict:
    """{metric: {value, unit}} of each per-layer metric whose reader finds
    something to read."""
    out = {}
    for m in metrics_for(bench, name, "per_layer"):
        reader = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                             "gpubench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(layer)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout; keep
    transformers-style libraries from loading JAX."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
