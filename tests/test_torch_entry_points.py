"""The port's root entry points on the CPU: the ``_torch`` recipes, the
quickstart and the augmentation QA script.

* Each ``run_*_torch.sh`` recipe and its JAX twin run under bash with a stub
  ``python`` first on ``PATH`` that records its argv: the two argvs are
  equal but for the entry (``-m ..._torch.workloads.main`` against
  ``main.py``), and the port's orchestrator parses the argv.
  ``run_ablations_torch.sh`` calls its recipe once per n. With
  ``NPROC_PER_NODE`` above 1 (or as many devices in
  ``CUDA_VISIBLE_DEVICES``) a recipe launches the same argv through a stub
  ``torchrun --standalone --nproc_per_node N``; at 1, through ``python``.
* ``examples/quickstart_torch.py --device cpu --epochs 1`` writes the JAX
  quickstart's synthetic dataset voxel for voxel, trains in bf16 (the
  kernels' plain versions) and writes a best checkpoint and the eval
  results.
* ``scripts/plotting/visualize_augmentations_torch.py --device cpu`` writes
  its PNG; at ``--prob 0`` the augmented volumes are the inputs.
"""

import importlib.util
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_segmentation_project_tpu_torch.data import load_nifti
from multimodal_segmentation_project_tpu_torch.workloads import main as orchestrator
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

ROOT = Path(__file__).resolve().parents[1]
PORT_ENTRY = ["-m", "multimodal_segmentation_project_tpu_torch.workloads.main"]
# each recipe with the variables it requires, and those that add flags
RECIPES = {
    "run_training": {"N_SAMPLES": "5"},
    "run_testing": {"MODEL_PATH": "best_model_unet.msgpack"},
    "run_finetune_ct": {"PRETRAINED": "best_model_unet.msgpack"},
    "run_distillation": {"TEACHER": "best_model_unet.msgpack"},
    "run_dann": {"N_ADD": "5", "N_SAMPLES": "3", "PRETRAINED": "best_model_unet.msgpack"},
}
END = "--end-of-call--"


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _calls(script: str, env: dict, tmp: Path) -> list:
    """The argv of every ``python`` call ``bash script`` makes, through a stub."""
    stub_dir = tmp / "bin"
    stub_dir.mkdir(exist_ok=True)
    stub = stub_dir / "python"
    stub.write_text(f'#!/bin/sh\nfor a in "$@"; do printf "%s\\n" "$a"; done >> "$ARGV_LOG"\n'
                    f'echo {END} >> "$ARGV_LOG"\n')
    stub.chmod(0o755)
    launcher = stub_dir / "torchrun"  # records its own name, then its argv
    launcher.write_text(f'#!/bin/sh\necho torchrun >> "$ARGV_LOG"\n'
                        f'for a in "$@"; do printf "%s\\n" "$a"; done >> "$ARGV_LOG"\n'
                        f'echo {END} >> "$ARGV_LOG"\n')
    launcher.chmod(0o755)
    log = tmp / f"{script}.argv"
    log.unlink(missing_ok=True)
    full_env = {**os.environ, **env, "ARGV_LOG": str(log),
                "PATH": f"{stub_dir}:{os.environ['PATH']}"}
    proc = subprocess.run(["bash", str(ROOT / script)], cwd=ROOT, env=full_env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    calls, call = [], []
    for line in log.read_text().splitlines():
        if line == END:
            calls.append(call)
            call = []
        else:
            call.append(line)
    return calls


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_runs_its_jax_twins_flags_through_the_ports_orchestrator(recipe, tmp_path):
    env = RECIPES[recipe]
    (jax_argv,) = _calls(f"{recipe}.sh", env, tmp_path)
    (port_argv,) = _calls(f"{recipe}_torch.sh", env, tmp_path)
    assert jax_argv[0] == "main.py"
    assert port_argv[:2] == PORT_ENTRY
    assert port_argv[2:] == jax_argv[1:]
    for name, value in env.items():
        assert value in port_argv, name
    args = orchestrator.build_parser().parse_args(port_argv[2:])
    assert args.device == "cuda"  # the recipes run on the GPU


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_recipe_launches_one_process_per_gpu_through_torchrun(recipe, tmp_path):
    env = RECIPES[recipe]
    (one,) = _calls(f"{recipe}_torch.sh", {**env, "NPROC_PER_NODE": "1"}, tmp_path)
    (two,) = _calls(f"{recipe}_torch.sh", {**env, "NPROC_PER_NODE": "2"}, tmp_path)
    (three,) = _calls(f"{recipe}_torch.sh", {**env, "CUDA_VISIBLE_DEVICES": "0,1,2"}, tmp_path)
    assert one[:2] == PORT_ENTRY
    assert two == ["torchrun", "--standalone", "--nproc_per_node", "2", *one]
    assert three == ["torchrun", "--standalone", "--nproc_per_node", "3", *one]


def test_ablations_recipe_calls_its_torch_recipe_once_per_n(tmp_path):
    calls = _calls("run_ablations_torch.sh", {"MODE": "train", "NS": "1 5",
                                              "EXPERIMENT_DIR": "exp"}, tmp_path)
    assert len(calls) == 2
    for call, n in zip(calls, ("1", "5")):
        assert call[:2] == PORT_ENTRY
        args = orchestrator.build_parser().parse_args(call[2:])
        assert (args.experiment, args.n_samples, args.experiment_dir) == (
            "train", int(n), f"exp/train_n{n}")


@pytest.fixture(scope="module")
def quickstart_run(tmp_path_factory):
    """The quickstart on the CPU, one epoch; (its workdir, its return)."""
    workdir = tmp_path_factory.mktemp("quickstart")
    out = _load("examples/quickstart_torch.py").main(
        ["--workdir", str(workdir), "--epochs", "1", "--device", "cpu"])
    return workdir, out


def test_quickstart_trains_and_evaluates_on_the_cpu(quickstart_run, tmp_path):
    workdir, out = quickstart_run
    best = Path(out["best"])
    assert best.name.startswith("best_model") and best.suffix == ".msgpack"
    assert Path(f"{best}.json").exists()
    assert np.isfinite(out["eval"]["mean_dice_overall"])
    (results,) = (workdir / "experiments").glob("test_results_quickstart_*")
    assert (results / "metrics" / "metrics.json").exists()
    preds = sorted((results / "predictions").glob("*_pred.nii.gz"))
    assert len(preds) == 2
    assert all(load_nifti(str(p)).data.dtype == np.uint8 for p in preds)
    assert (workdir / "augmentation.png").stat().st_size > 0
    # the JAX quickstart's dataset, voxel for voxel
    _load("examples/quickstart.py").make_dataset(str(tmp_path))
    jax_files = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*.nii.gz"))
    port_files = sorted(p.relative_to(workdir / "data")
                        for p in (workdir / "data").rglob("*.nii.gz"))
    assert port_files == jax_files and len(jax_files) == 20
    for rel in jax_files:
        want, got = load_nifti(str(tmp_path / rel)), load_nifti(str(workdir / "data" / rel))
        assert got.data.dtype == want.data.dtype, rel
        np.testing.assert_array_equal(got.data, want.data, err_msg=str(rel))
        np.testing.assert_array_equal(got.affine, want.affine, err_msg=str(rel))


def test_qa_script_writes_its_png_and_prob_0_keeps_the_volumes(quickstart_run, tmp_path):
    workdir, _ = quickstart_run
    split = str(workdir / "data" / "train")
    qa = _load("scripts/plotting/visualize_augmentations_torch.py")
    png = tmp_path / "aug.png"
    qa.main([split, "--device", "cpu", "--save", str(png), "--index", "1", "--seed", "3"])
    assert png.stat().st_size > 0
    img, aug_img, lbl, aug_lbl = qa.augmented_pair(split, index=1, seed=3, prob=1.0,
                                                   device="cpu")
    assert img.shape == aug_img.shape == lbl.shape == aug_lbl.shape == (32, 32, 32)
    assert (img.dtype, aug_img.dtype, lbl.dtype, aug_lbl.dtype) == (
        torch.float32, torch.float32, torch.int32, torch.int32)
    assert not torch.equal(img, aug_img)
    assert set(torch.unique(aug_lbl).tolist()) <= {0, 1, 2, 3}
    same = qa.augmented_pair(split, index=1, seed=3, prob=0.0, device="cpu")
    assert torch.equal(same[1], same[0]) and torch.equal(same[3], same[2])
