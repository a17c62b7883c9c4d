"""The port's CLIs on several ranks, on the CPU: each rank a process with
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), which the CLIs' ``maybe_init_multihost`` reads (gloo with
``--device cpu``), through ``tests/torch_cli_worker.py``; and the DANN and
distillation steps on a 1 x 2 mesh against the JAX package's.

* Two ranks of the train CLI (batch 2: a 2 x 1 mesh, augmentation and
  dropout on) end with the same parameters bit for bit, and only rank 0
  writes (each rank is given its own ``--experiment_dir``, and rank 1's
  does not exist afterwards), as ``tests/test_multihost.py`` holds the JAX
  CLI.
* The eval CLI at batch 2 on two ranks (three test volumes: a full batch
  and a ragged one) writes the per-sample rows and per-organ means of one
  process at batch 2, and only rank 0 writes.
* A world of one (torchrun's environment, one rank) trains to the bits of
  a run with no process group.
* One DANN step and one distillation step at 1 x 2 against the JAX steps
  on the same mesh (the inputs of ``tests/test_torch_parallel.py``): the
  losses within 1e-4 relative, the gradients (the discriminator's too)
  within 1e-4 of max |jax| per parameter and the running statistics within
  1e-5; both sides step with unit-rate SGD, so the JAX steps' parameters
  give the gradients they applied.
"""

import csv
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_segmentation_project_tpu.engine.steps import make_dann_step as jax_dann_step
from multimodal_segmentation_project_tpu.engine.steps import (
    make_distill_step as jax_distill_step,
)
from multimodal_segmentation_project_tpu.models import DomainDiscriminator as JaxDisc
from multimodal_segmentation_project_tpu.ops.losses import distillation_loss as jax_kd
from multimodal_segmentation_project_tpu.ops.losses import get_loss_fn as jax_loss_fn
from multimodal_segmentation_project_tpu.parallel.mesh import replicate_state
from multimodal_segmentation_project_tpu.parallel.mesh import use_spatial_mesh as jax_use_mesh
from multimodal_segmentation_project_tpu_torch.engine.checkpoint import save_pth
from multimodal_segmentation_project_tpu_torch.engine.interop import (
    checkpoint_trees,
    discriminator_params_to_state_dict,
    trees_to_state_dict,
)
from multimodal_segmentation_project_tpu_torch.models import UNet3D
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)
from tests.test_torch_parallel import (
    ALPHA,
    LAMBDA,
    TEMPERATURE,
    _cases,
    _check_grads,
    _check_ranks_agree,
    _check_state_after,
    _dann_batch,
    _disc_params,
    _free_port,
    _jax_mesh,
    _jax_sgd_state,
    _jax_unet,
    _np,
    _put,
    _Ranks,
    _sgd_grads,
    _weights,
)
from tests.test_torch_train import _write_split

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_cli_worker.py"
CLI_TIMEOUT = 120  # seconds for a CLI process


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """16^3 synthetic CT and MRI cases: 2 train, 1 val and 3 test each."""
    root = tmp_path_factory.mktemp("parallel_cli_data")
    for i, (split, n) in enumerate((("train", 2), ("val", 1), ("test", 3))):
        _write_split(root, split, n, seed=10 * i)
    return root


def _start(module: str, args: list, rank: int | None = None, world: int = 1,
           port: int | None = None) -> subprocess.Popen:
    """A CLI process; with ``rank``, one of ``world`` ranks under torchrun's
    environment."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    if rank is not None:
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return subprocess.Popen([sys.executable, str(WORKER), module, *map(str, args)], env=env,
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(procs: list) -> list:
    """Each process's output; every one must exit 0."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=CLI_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
    return outs


def _train_args(data_root, exp, *extra) -> list:
    return ["--data_root", data_root, "--experiment_dir", exp, "--batch_size", "2",
            "--epochs", "1", "--features", "4,8", "--device", "cpu", "--mixed_precision", "no",
            "--loss", "ce_tversky", "--num_workers", "0", "--modalities", "ct", *extra]


def _digests(outs: list) -> dict:
    found = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("PARAMS "):
                _, rank, digest = line.split()
                found[int(rank)] = digest
    return found


def test_two_ranks_of_the_train_cli_end_alike_and_only_rank_0_writes(data_root, tmp_path):
    port = _free_port()
    procs = [_start("train_unet", _train_args(data_root, tmp_path / f"rank{r}"), r, 2, port)
             for r in range(2)]
    outs = _finish(procs)
    digests = _digests(outs)
    assert set(digests) == {0, 1} and digests[0] == digests[1], outs
    assert "[MESH] 2x1 mesh (data x spatial) over 2 of 2 ranks" in outs[0]
    assert "[EPOCH]" in outs[0] and "[EPOCH]" not in outs[1]
    (run,) = (tmp_path / "rank0").iterdir()
    with open(run / "logs" / "train_log.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and np.isfinite(float(rows[0]["train_loss"]))
    assert (run / "config.txt").exists()
    assert any(c.name.startswith("best_model_") for c in (run / "checkpoints").iterdir())
    assert not (tmp_path / "rank1").exists()


def _eval_rows(exp: Path) -> tuple[list, dict]:
    (results,) = exp.glob("test_results_*")
    with open(results / "metrics" / "per_sample_metrics.csv") as f:
        rows = [{k: v for k, v in r.items() if k != "inference_time"}
                for r in csv.DictReader(f)]
    with open(results / "metrics" / "metrics.json") as f:
        means = {k: v for k, v in json.load(f).items() if k.startswith("mean_")}
    return rows, means


def test_the_eval_cli_on_two_ranks_writes_the_rows_of_one_process(data_root, tmp_path):
    model = UNet3D(in_channels=1, out_channels=4, features=(4, 8), dropout_rate=0.0,
                   dtype=torch.float32, generator=torch.Generator().manual_seed(5))
    ckpt = tmp_path / "model.pth"
    save_pth(str(ckpt), model)

    def args(exp):
        return ["--model_path", ckpt, "--data_root", data_root, "--experiment_dir", exp,
                "--model_name", "m", "--batch_size", "2", "--precision", "fp32",
                "--features", "4,8", "--device", "cpu", "--no_visualizations",
                "--modalities", "ct"]

    port = _free_port()
    procs = [_start("test_model", args(tmp_path / f"rank{r}"), r, 2, port) for r in range(2)]
    procs.append(_start("test_model", args(tmp_path / "one")))
    outs = _finish(procs)
    assert "sharded over 2 device(s)" in outs[0]
    assert not (tmp_path / "rank1").exists() or not any((tmp_path / "rank1").iterdir())
    rows, means = _eval_rows(tmp_path / "rank0")
    want_rows, want_means = _eval_rows(tmp_path / "one")
    assert [r["filename"] for r in rows] == [r["filename"] for r in want_rows]
    assert len(rows) == 3
    for got, want in zip(rows, want_rows):
        for k, v in want.items():
            if k != "filename":
                assert float(got[k]) == pytest.approx(float(v), rel=1e-6, abs=1e-9), k
    assert means == pytest.approx(want_means, rel=1e-6, abs=1e-9)
    (preds,) = (tmp_path / "rank0").glob("test_results_*/predictions")
    assert len(list(preds.iterdir())) == 3


def test_a_world_of_one_trains_to_the_bits_of_no_process_group(data_root, tmp_path):
    port = _free_port()
    procs = [_start("train_unet", _train_args(data_root, tmp_path / "world1"), 0, 1, port),
             _start("train_unet", _train_args(data_root, tmp_path / "none"))]
    outs = _finish(procs)
    assert "[DIST] 1 rank(s) over gloo" in outs[0] and "[DIST]" not in outs[1]
    digests = [_digests([out])[0] for out in outs]
    assert digests[0] == digests[1]
    trees = []
    for exp in ("world1", "none"):
        (best,) = (tmp_path / exp).glob("*/checkpoints/best_model_*.msgpack")
        trees.append(checkpoint_trees(str(best)))
    want = trees_to_state_dict(*trees[1])
    for name, value in trees_to_state_dict(*trees[0]).items():
        assert torch.equal(value, want[name]), name


# ---- DANN and distillation -----------------------------------------------------------


@pytest.fixture(scope="module")
def dann_world(tmp_path_factory):
    ranks = _Ranks(2, {"dann_distill": _cases()["dann_distill"]},
                   tmp_path_factory.mktemp("parallel_dann"))
    yield ranks
    ranks.close()


def _kd(s, t, y):
    return jax_kd(s, t, y, alpha=ALPHA, temperature=TEMPERATURE)


def test_dann_and_distillation_steps_on_a_spatial_mesh_match_jax(dann_world):
    """Both sides step with unit-rate SGD, so each JAX step's parameters
    give the gradients it applied (``_sgd_grads``)."""
    params, stats = _weights(3)
    t_params, t_stats = _weights(4)
    dparams = _disc_params()
    src, lbl, tgt = _dann_batch()
    mesh = _jax_mesh(1, 2)
    model, disc = _jax_unet(), JaxDisc(dropout_rate=0.0)
    seg = replicate_state(mesh, _jax_sgd_state(model.apply, params, stats, lr=1.0))
    dstate = replicate_state(mesh, _jax_sgd_state(disc.apply, dparams, {}, lr=1.0))
    teacher_vars = replicate_state(mesh, {"params": t_params, "batch_stats": t_stats})
    with jax_use_mesh(mesh):
        j_src, j_lbl, j_tgt = _put(mesh, src, lbl, tgt)
        seg, dstate, m_dann = jax_dann_step(jax_loss_fn("ce_tversky"), LAMBDA, nan_guard=True)(
            seg, dstate, j_src, j_lbl, j_tgt, jax.random.key(0))
        want_dann = {k: float(m_dann[k]) for k in ("task_loss", "domain_loss", "loss")}
        want_seg = trees_to_state_dict(_np(seg.params), _np(seg.batch_stats))
        want_disc = discriminator_params_to_state_dict(_np(dstate.params))
        student = replicate_state(mesh, _jax_sgd_state(model.apply, params, stats, lr=1.0))
        student, m_kd = jax_distill_step(_kd, nan_guard=True)(
            student, teacher_vars, j_src, j_lbl, jax.random.key(0))
        want_kd_loss = float(m_kd["loss"])
        want_student = trees_to_state_dict(_np(student.params), _np(student.batch_stats))
    start = trees_to_state_dict(params, stats)
    start_disc = discriminator_params_to_state_dict(dparams)

    outs = dann_world.results("dann_distill")
    assert len(outs) == 2
    for out in outs:
        for k, v in want_dann.items():
            assert out["dann"]["metrics"][k] == pytest.approx(v, rel=1e-4), k
        assert out["distill"]["metrics"]["loss"] == pytest.approx(want_kd_loss, rel=1e-4)
    _check_ranks_agree([o["dann"] for o in outs])
    _check_ranks_agree([o["dann"]["disc"] for o in outs])
    _check_ranks_agree([o["distill"] for o in outs])
    dann, distill = outs[0]["dann"], outs[0]["distill"]
    names = list(dann["grads"])
    for got, (want, floors) in (
            (dann["grads"], _sgd_grads(start, {n: want_seg[n] for n in names})),
            (dann["disc"]["grads"], _sgd_grads(start_disc, want_disc)),
            (distill["grads"], _sgd_grads(start, {n: want_student[n] for n in names}))):
        _check_grads({n: g.numpy() for n, g in got.items()}, want, floors=floors)
    _check_state_after(dann, want_seg, params=False)
    _check_state_after(distill, want_student, params=False)
