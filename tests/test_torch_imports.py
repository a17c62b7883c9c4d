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

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, prefix=port.__name__ + "."):
        names.append(info.name)
    return names


def test_port_imports_without_jax_flax_optax():
    modules = _port_modules()
    for name in ("workloads.test_model", "workloads.train_unet", "workloads.finetune_ct",
                 "workloads.distill_unet", "workloads.train_dann", "workloads.main",
                 "models.discriminator", "ops.grl"):
        assert f"{port.__name__}.{name}" in modules
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'flax', 'optax'):\n"
        "    sys.modules[m] = None  # any import of them raises\n"
        f"for name in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax')\n"
        "             and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_only_the_data_module_takes_code_from_the_jax_package():
    """No module of the port imports JAX, flax, optax or anything of the JAX
    package (its data stack and CLI helpers are the port's own copies), and
    neither does chip_smoke.py."""
    imports = re.compile(
        r"^\s*(?:from|import)\s+(jax|flax|optax|multimodal_segmentation_project_tpu)\b", re.M)
    pkg_dir = Path(port.__file__).parent
    borrowing = sorted(str(p.relative_to(pkg_dir)) for p in pkg_dir.rglob("*.py")
                       if imports.search(p.read_text()))
    assert borrowing == []
    assert (pkg_dir / "data" / "dataset.py").exists()
    assert not imports.search((ROOT / "chip_smoke.py").read_text())


def test_eval_cli_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot show")
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_model.resolve_device("cuda", "bf16")
    assert test_model.resolve_device("cpu", "fp32") == torch.device("cpu")


def test_train_cli_takes_the_jax_clis_flags_and_defaults():
    """The JAX train CLI's flags parse here with the same defaults, plus
    --device (default cuda)."""
    from multimodal_segmentation_project_tpu.workloads import train_unet as jax_train

    argv = ["--data_root", "d"]
    mine = vars(train_unet.build_parser().parse_args(argv))
    ref = vars(jax_train.build_parser().parse_args(argv))
    assert mine.pop("device") == "cuda"
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
