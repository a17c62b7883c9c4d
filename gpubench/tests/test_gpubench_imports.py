"""Nothing the benchmark runs loads JAX or the JAX package; the reference
imports nothing of the program; a run without the devices it needs fails."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from gpubench import common, run

BENCH = Path(common.BENCH_DIR)


def test_forbidden_names_compare_whole_top_level_names():
    assert common.forbidden_modules(["multimodal_segmentation_project_tpu_torch.ops",
                                     "numpy", "jaxtyping"]) == []
    assert common.forbidden_modules(["multimodal_segmentation_project_tpu.engine.steps",
                                     "jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib", "multimodal_segmentation_project_tpu"]


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not {m for m in _imports(path) if m.startswith(("multimodal", "jax", "flax"))}, path


def test_a_whole_run_loads_no_jax():
    code = ("import sys, json, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from conftest import run_cpu, tiny\n"
            "res = run_cpu('unet3d-bf16.train', tiny())\n"
            "from gpubench import common\n"
            "print(json.dumps(common.forbidden_modules()))\n") % (str(common.ROOT),
                                                                  str(BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=common.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_device_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "unet3d-bf16.train", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""
