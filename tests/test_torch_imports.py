"""The port imports no JAX, and its GPU-only entry points refuse to run
without a GPU instead of quietly running the plain versions."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import multimodal_segmentation_project_tpu_torch as port
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.ops import _build, conv3, conv3_fused, head, pool
from multimodal_segmentation_project_tpu_torch.ops import upconv
from multimodal_segmentation_project_tpu_torch.workloads import test_model, train_unet
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

ROOT = Path(__file__).resolve().parents[1]
# the port's root entry points beside the package
ENTRY_SCRIPTS = ["examples/quickstart_torch.py",
                 "scripts/plotting/visualize_augmentations_torch.py"]
TORCH_RECIPES = ["run_training_torch.sh", "run_testing_torch.sh", "run_finetune_ct_torch.sh",
                 "run_distillation_torch.sh", "run_dann_torch.sh", "run_ablations_torch.sh"]


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def test_port_imports_without_jax_flax_optax():
    modules = _port_modules()
    for name in ("workloads.test_model", "workloads.train_unet", "workloads.finetune_ct",
                 "workloads.distill_unet", "workloads.train_dann", "workloads.main",
                 "models.discriminator", "ops.grl", "engine.msgpack_codec",
                 "engine.checkpoint", "data.resample", "workloads.resample"):
        assert f"{port.__name__}.{name}" in modules
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'flax', 'optax', 'msgpack'):\n"
        "    sys.modules[m] = None  # any import of them raises\n"
        f"for name in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "import importlib.util\n"
        f"for rel in {ENTRY_SCRIPTS!r}:\n"
        "    spec = importlib.util.spec_from_file_location(rel.replace('/', '_'), rel)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'msgpack')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_only_the_data_module_takes_code_from_the_jax_package():
    """No module of the port imports JAX, flax, optax, msgpack or anything of
    the JAX package (its data stack, resampling, checkpoint codec and CLI
    helpers are the port's own copies), and neither does chip_smoke.py."""
    imports = re.compile(
        r"^\s*(?:from|import)\s+(jax|flax|optax|msgpack|multimodal_segmentation_project_tpu)\b",
        re.M)
    pkg_dir = Path(port.__file__).parent
    borrowing = sorted(str(p.relative_to(pkg_dir)) for p in pkg_dir.rglob("*.py")
                       if imports.search(p.read_text()))
    assert borrowing == []
    assert (pkg_dir / "data" / "dataset.py").exists()
    assert not imports.search((ROOT / "chip_smoke.py").read_text())
    for rel in ENTRY_SCRIPTS:
        assert not imports.search((ROOT / rel).read_text()), rel


def test_the_torch_recipes_reach_the_ports_orchestrator_and_no_main_py():
    """Each _torch recipe runs the port's orchestrator (the ablations recipe
    the other _torch recipes), and none names main.py or a JAX recipe."""
    entry = "python -m multimodal_segmentation_project_tpu_torch.workloads.main"
    for name in TORCH_RECIPES:
        text = "\n".join(line for line in (ROOT / name).read_text().splitlines()
                         if not line.lstrip().startswith("#"))
        assert "main.py" not in text, name
        assert not re.search(r"run_\w+(?<!_torch)\.sh\b", text), name
        if name == "run_ablations_torch.sh":
            assert "python" not in text
            assert sorted(set(re.findall(r"run_\w+_torch\.sh", text))) == sorted(
                r for r in TORCH_RECIPES if r not in (name, "run_testing_torch.sh"))
        else:
            assert text.count(entry) == 1, name


def test_eval_cli_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot show")
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_model.resolve_device("cuda", "bf16")
    assert test_model.resolve_device("cpu", "fp32") == torch.device("cpu")


def test_train_cli_takes_the_jax_clis_flags_and_defaults():
    """The JAX train CLI's flags parse here with the same defaults, plus
    --device (default cuda) and --model (default unet3d, the JAX CLI's only
    model)."""
    from multimodal_segmentation_project_tpu.workloads import train_unet as jax_train

    argv = ["--data_root", "d"]
    mine = vars(train_unet.build_parser().parse_args(argv))
    ref = vars(jax_train.build_parser().parse_args(argv))
    assert mine.pop("device") == "cuda"
    assert mine.pop("model") == "unet3d"
    assert mine == ref


@pytest.mark.parametrize(
    "op,args",
    [
        (conv3.conv3x3x3_cf_relu, lambda t: (t(1, 2, 4, 4, 4), t(3, 3, 3, 2, 4), t(4))),
        (pool.max_pool2x_cf, lambda t: (t(1, 2, 4, 4, 4),)),
        (upconv.upconv2x_cf, lambda t: (t(1, 2, 4, 4, 4), t(2, 2, 2, 2, 4), t(4))),
        (head.head1x1_cf, lambda t: (t(1, 2, 4, 4, 4), t(2, 4), t(4))),
        (conv3.conv3x3x3_cf, lambda t: (t(1, 2, 4, 4, 4), t(3, 3, 3, 2, 4), t(4))),
        (conv3.conv3x3x3_cf_dx, lambda t: (t(1, 4, 4, 4, 4), t(3, 3, 3, 2, 4))),
        (conv3.conv3x3x3_cf_dw, lambda t: (t(1, 2, 4, 4, 4), t(1, 4, 4, 4, 4))),
        (pool.max_pool2x_cf_bwd, lambda t: (t(1, 2, 4, 4, 4), t(1, 2, 2, 2, 2), t(1, 2, 2, 2, 2))),
        (head.head1x1_cf_dx, lambda t: (t(1, 4, 4, 4, 4), t(2, 4), torch.bfloat16)),
        (head.head1x1_cf_dw, lambda t: (t(1, 2, 4, 4, 4), t(1, 4, 4, 4, 4))),
        (conv3_fused.conv3x3x3_cf_stats, lambda t: (t(1, 2, 4, 4, 4), t(3, 3, 3, 2, 4), t(4))),
        (conv3_fused.conv3x3x3_cf_boundary_stats,
         lambda t: (t(1, 2, 4, 4, 4), t(3, 3, 3, 2, 4), t(4), t(1, 2), t(1, 2))),
        (conv3_fused.conv3x3x3_cf_boundary,
         lambda t: (t(1, 2, 4, 4, 4), t(3, 3, 3, 2, 4), t(4), t(1, 2), t(1, 2))),
        (conv3_fused.conv3x3x3_cf_dx_epilogue,
         lambda t: (t(1, 4, 4, 4, 4), t(3, 3, 3, 2, 4), t(1, 2, 4, 4, 4), t(1, 2), t(1, 2))),
        (conv3_fused.conv3x3x3_cf_dw_prologue,
         lambda t: (t(1, 2, 4, 4, 4), t(1, 4, 4, 4, 4), t(1, 2), t(1, 2))),
    ],
)
def test_wrappers_take_the_plain_version_only_for_cpu_tensors(op, args):
    """A tensor that is not on the CPU gets the kernel or an error, never
    the plain version: here a 'meta' tensor, which no kernel takes."""
    ops.reset_launch_counts()

    def meta(*shape):
        return torch.empty(*shape, dtype=torch.bfloat16, device="meta")

    with pytest.raises(ValueError, match="CUDA tensors"):
        op(*args(meta))
    assert op.launches == 0


def test_kernel_build_raises_clearly_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if shutil.which("nvcc") is not None:
        pytest.skip("nvcc still reachable")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()


@pytest.mark.parametrize("alone", [False, True], ids=["in_checkout", "script_alone"])
def test_chip_smoke_fails_without_a_gpu_or_without_the_port(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
