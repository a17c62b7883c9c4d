"""The port's multi-device path on the CPU against the JAX package's sharded
model: meshes of 2 and 4 ranks over gloo in one world of 4 spawned
processes (``tests/torch_parallel_worker.py``, one process per rank; the
module's fixture starts them, and every case runs in that world, a 2-rank
mesh on ranks 0 and 1) beside the JAX package on the 8-virtual-device CPU
mesh of ``tests/conftest.py``, with the same weights carried across
(``engine.interop``).

* ``choose_mesh`` against a table read from the JAX trainer's choice
  (``engine/trainer.py:171-207``), and its refusals;
* ``halo_conv3`` of the plain conv at 2 and 4 ranks (mesh 1 x n), forward
  and autograd, against the JAX ``halo_conv3`` on the same mesh: rtol and
  atol 2e-4 (``tests/test_spatial_sharding.py:53``);
* one train step (features (4, 8), 16^3, batch 4, fp32, ce_tversky, dropout
  0, no augmentation, SGD as ``tests/test_sharding.py`` uses) at meshes
  2 x 1, 1 x 2 and 2 x 2 against the JAX ``make_train_step`` on the same
  mesh: the loss within 1e-4 relative, the parameters after the step within
  2e-5 absolute (``tests/test_sharding.py:71-74``), the BatchNorm running
  statistics within 1e-5 of max |jax|, the gradients each rank applied
  within 1e-4 of max |jax| per parameter against the JAX gradient of the
  global batch (a BN-fed conv bias, true gradient 0, below 1e-5 of the
  largest on both sides), and every rank's parameters the same bits;
* ``make_sharded_eval_step`` at 2 x 2 with a ragged last batch (its pad row
  weighted 0) against the JAX one on the same mesh, within 1e-5 relative;
* one DANN step and one distillation step at 1 x 2, whose inputs this
  module makes: ``tests/test_torch_parallel_cli.py`` runs them (this file
  keeps within its time).

The weights are the port's seeded initialisation, carried to the JAX trees
(``state_dict_to_trees``).
"""

import functools
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_segmentation_project_tpu.engine.state import TrainState as JaxTrainState
from multimodal_segmentation_project_tpu.engine.state import ones_mask
from multimodal_segmentation_project_tpu.engine.steps import (
    make_sharded_eval_step as jax_sharded_eval_step,
)
from multimodal_segmentation_project_tpu.engine.steps import make_train_step as jax_train_step
from multimodal_segmentation_project_tpu.models import UNet3D as JaxUNet3D
from multimodal_segmentation_project_tpu.ops.halo import halo_conv3 as jax_halo_conv3
from multimodal_segmentation_project_tpu.ops.losses import get_loss_fn as jax_loss_fn
from multimodal_segmentation_project_tpu.ops.pallas_conv import conv3x3x3_cf_reference
from multimodal_segmentation_project_tpu.parallel.mesh import (
    batch_sharding as jax_batch_sharding,
)
from multimodal_segmentation_project_tpu.parallel.mesh import make_mesh as jax_make_mesh
from multimodal_segmentation_project_tpu.parallel.mesh import replicate_state
from multimodal_segmentation_project_tpu.parallel.mesh import use_spatial_mesh as jax_use_mesh
from multimodal_segmentation_project_tpu_torch.engine.interop import (
    discriminator_params_to_state_dict,
    state_dict_to_discriminator_params,
    state_dict_to_trees,
    trees_to_state_dict,
)
from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator, UNet3D
from multimodal_segmentation_project_tpu_torch.parallel.mesh import choose_mesh, make_mesh
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_parallel_worker.py"
FEATURES = (4, 8)
SIZE = 16
LR = 1e-3
LAMBDA = 0.2
ALPHA, TEMPERATURE = 0.7, 2.0
WORLD = 4
RANK_TIMEOUT = 120  # seconds for the spawned world to finish


# ---- spawning ranks -----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """``world`` worker processes running ``cases``, started at once;
    :meth:`results` waits for them once (the JAX side runs meanwhile)."""

    def __init__(self, world: int, cases: dict, tmp: Path):
        self.tmp, self.world, self._outs = tmp, world, None
        torch.save(cases, tmp / "inputs.pt")
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (str(REPO), os.environ.get("PYTHONPATH", "")) if p)}
        port = str(_free_port())
        self.procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), port,
                                        str(tmp)], env=env, cwd=REPO,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True) for r in range(world)]

    def close(self) -> None:
        for p in self.procs:
            p.kill()
            p.wait()

    def results(self, case: str) -> list:
        """Each rank's output of ``case`` (the ranks of its mesh)."""
        if self._outs is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
            finally:
                self.close()
            for r, (p, log) in enumerate(zip(self.procs, logs)):
                assert p.returncode == 0, f"rank {r} failed:\n{log}"
            self._outs = [torch.load(self.tmp / f"out_{r}.pt", weights_only=False)
                          for r in range(self.world)]
        return [out[case] for out in self._outs if case in out]


# ---- the JAX side -----------------------------------------------------------------


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _close(got, want, tol, name="", floor=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale + floor, f"{name}: max err {err} > {tol} * {scale} + {floor}"


def _bn_fed_bias(name: str) -> bool:
    return name.endswith(("double_conv.0.bias", "double_conv.4.bias"))


def _check_grads(got: dict, want: dict, tol: float = 1e-4, floors: dict | None = None):
    """Per parameter within ``tol`` of max |want| (plus ``floors[name]``); a
    BN-fed bias below 1e-5 of the largest gradient on both sides (plus its
    floor)."""
    floors = floors or {}
    largest = max(float(np.abs(v).max()) for v in want.values())
    for name, w in want.items():
        floor = floors.get(name, 0.0)
        if _bn_fed_bias(name):
            for side in (got[name], w):
                assert float(np.abs(np.asarray(side)).max()) < 1e-5 * largest + floor, name
        else:
            _close(got[name], w, tol, name, floor)


@functools.cache
def _jax_unet():
    return JaxUNet3D(out_channels=4, features=FEATURES, dropout_rate=0.0, dtype=jnp.float32,
                     conv_impl="xla")


@functools.cache
def _weights(seed: int):
    """(params, batch_stats) in the JAX trees: the port's seeded UNet3D
    (flax's initialisers), with non-trivial running statistics."""
    model = UNet3D(in_channels=1, out_channels=4, features=FEATURES, dropout_rate=0.0,
                   dtype=torch.float32, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    for name, value in sd.items():
        if name.endswith("running_mean"):
            sd[name] = torch.from_numpy(rng.normal(0, 0.1, value.shape).astype(np.float32))
        elif name.endswith("running_var"):
            sd[name] = torch.from_numpy(rng.uniform(0.5, 1.5, value.shape).astype(np.float32))
    return state_dict_to_trees(sd)


@functools.cache
def _disc_params():
    disc = DomainDiscriminator(2 * FEATURES[-1], generator=torch.Generator().manual_seed(7))
    return state_dict_to_discriminator_params(disc.state_dict())


def _batch(seed: int, n: int = 4):
    rng = np.random.default_rng(seed)
    labels = np.zeros((n, SIZE, SIZE, SIZE), np.int32)
    labels[:, 2:9, 3:10, 4:12] = 2
    labels[:, 10:14, 2:6, 9:14] = 1
    labels[:, 9:13, 11:15, 1:5] = 3
    images = labels[:, None] * 0.3 + rng.normal(0, 0.2, (n, 1, SIZE, SIZE, SIZE))
    return images.astype(np.float32), labels


def _jax_mesh(n_data: int, n_spatial: int):
    return jax_make_mesh(n_data=n_data, n_spatial=n_spatial,
                         devices=jax.devices()[:n_data * n_spatial])


def _jax_sgd_state(apply_fn, params, stats, lr=LR):
    tx = optax.sgd(1.0)  # times the state's LR: p -= lr * g
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=tx.init(params), trainable_mask=ones_mask(params),
                         lr=jnp.asarray(lr, jnp.float32), apply_fn=apply_fn, tx=tx)


def _put(mesh, *arrays):
    out = tuple(jax.device_put(a, jax_batch_sharding(mesh, np.ndim(a))) for a in arrays)
    return out if len(out) > 1 else out[0]


def _torch_inputs(params, stats, mesh_shape, lr=LR, **extra) -> dict:
    return {"features": FEATURES, "mesh": mesh_shape, "lr": lr,
            "state_dict": trees_to_state_dict(params, stats), **extra}


def _check_ranks_agree(outs: list):
    for r, out in enumerate(outs[1:], 1):
        for name, value in outs[0]["state_dict"].items():
            assert torch.equal(out["state_dict"][name], value), f"rank {r}: {name}"


def _check_state_after(out: dict, want_sd: dict, params: bool = True):
    """Parameters within 2e-5 absolute (where ``params``), running
    statistics within 1e-5 of max |jax|."""
    for name, value in out["state_dict"].items():
        if "num_batches" in name:
            continue
        if "running" in name:
            _close(value, want_sd[name], 1e-5, name)
        elif params:
            np.testing.assert_allclose(value.numpy(), want_sd[name].numpy(), rtol=0, atol=2e-5,
                                       err_msg=name)


def _sgd_grads(before: dict, after: dict) -> tuple[dict, dict]:
    """The gradients a unit-rate SGD step applied, before - after in float64,
    and for each the rounding of ``after``: half an fp32 ulp of its largest
    entry."""
    grads = {n: before[n].double().numpy() - after[n].double().numpy() for n in after}
    floors = {n: float(np.spacing(np.abs(after[n].numpy()).max())) / 2 for n in after}
    return grads, floors


# ---- the mesh choice ----------------------------------------------------------------

# (world, batch, n_spatial, n_data, auto_spatial, D, levels) -> (n_data, n_spatial),
# as engine/trainer.py:171-207 computes it
CHOICES = [
    ((1, 1, 1, None, True, 192, 4), (1, 1)),
    ((2, 1, 1, None, True, 192, 4), (1, 2)),   # batch 1 on 2: auto-spatial
    ((2, 1, 1, None, False, 192, 4), (1, 1)),  # auto off: one rank idle
    ((2, 2, 1, None, True, 192, 4), (2, 1)),
    ((2, 4, 1, None, True, 16, 4), (2, 1)),
    ((4, 1, 1, None, True, 192, 4), (1, 4)),
    ((4, 2, 1, None, True, 192, 4), (2, 2)),
    ((4, 4, 1, None, True, 192, 4), (4, 1)),
    ((4, 1, 2, None, True, 192, 4), (1, 2)),   # n_spatial given: no auto-raise
    ((4, 2, 2, None, True, 192, 4), (2, 2)),
    ((4, 4, 1, 2, True, 192, 4), (2, 1)),      # n_data given: no auto-raise
    ((4, 1, 1, None, True, 16, 2), (1, 4)),    # D 16, 8, 4
    ((8, 1, 1, None, True, 192, 4), (1, 4)),   # 8 misses 12: halved to 4
    ((8, 2, 1, None, True, 192, 4), (2, 4)),
    ((8, 4, 1, None, True, 192, 4), (4, 2)),
    ((8, 4, 2, None, True, 192, 4), (4, 2)),
    ((8, 1, 1, None, True, 16, 4), (1, 1)),    # D 16 .. 1: no candidate divides 1
    ((8, 4, 1, None, False, 16, 4), (4, 1)),
]


def test_choose_mesh_follows_the_jax_trainers_table():
    for args, want in CHOICES:
        got = choose_mesh(*args)
        assert (got.n_data, got.n_spatial) == want, args
        assert got.auto_spatial == (want[1] > 1 and args[2] == 1 and args[3] is None), args
    for args, match in (((1, 1, 2, None, True, 192, 4), "torchrun"),   # more ranks than exist
                        ((2, 4, 1, 4, True, 192, 4), "torchrun"),
                        ((4, 3, 1, 2, True, 192, 4), "does not split"),
                        ((8, 8, 8, None, True, 192, 4), "does not divide")):
        with pytest.raises(ValueError, match=match):
            choose_mesh(*args)
    # with no process group, the world is this process: make_mesh's default
    # is the single-device 1x1 mesh, and a larger one is refused
    mesh = make_mesh()
    assert (mesh.n_data, mesh.n_spatial, mesh.member, mesh.group) == (1, 1, True, None)
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(n_spatial=2, n_data=1)


# ---- the inputs, and the world that runs them -------------------------------------------


def _halo_arrays(n_spatial: int) -> dict:
    rng = np.random.default_rng(n_spatial)
    return {"x": rng.normal(size=(2, 4, 16, 8, 8)).astype(np.float32),
            "w": (rng.normal(size=(3, 3, 3, 4, 8)) * 0.1).astype(np.float32),
            "b": (rng.normal(size=(8,)) * 0.1).astype(np.float32),
            "ct": rng.normal(size=(2, 8, 16, 8, 8)).astype(np.float32)}


TRAIN_MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}


def _eval_batch():
    """The ragged last batch: one volume, padded by itself with weight 0."""
    images, labels = _batch(2, n=1)
    return (np.concatenate([images, images]), np.concatenate([labels, labels]),
            np.array([1.0, 0.0], np.float32))


def _dann_batch():
    src, lbl = _batch(5, n=2)
    return src, lbl, (_batch(6, n=2)[0] * 0.7 + 0.3).astype(np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)


def _cases() -> dict:
    cases = {f"halo{n}": {"kind": "halo", "mesh": (1, n),
                          **{k: _t(v) for k, v in _halo_arrays(n).items()}} for n in (2, 4)}
    images, labels = _batch(1)
    for name, shape in TRAIN_MESHES.items():
        cases[f"train{name}"] = {"kind": "train", **_torch_inputs(
            *_weights(1), shape, images=_t(images), labels=_t(labels))}
    images, labels, weights = _eval_batch()
    cases["eval"] = {"kind": "eval", **_torch_inputs(
        *_weights(2), (2, 2), images=_t(images), labels=_t(labels), weights=_t(weights))}
    src, lbl, tgt = _dann_batch()
    cases["dann_distill"] = {"kind": "dann_distill", **_torch_inputs(
        *_weights(3), (1, 2), lr=1.0, images=_t(src), labels=_t(lbl), target=_t(tgt),
        teacher_state_dict=trees_to_state_dict(*_weights(4)),
        disc_state_dict=discriminator_params_to_state_dict(_disc_params()),
        lambda_domain=LAMBDA, alpha=ALPHA, temperature=TEMPERATURE)}
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _cases()
    del cases["dann_distill"]  # tests/test_torch_parallel_cli.py runs it, in a world of 2
    ranks = _Ranks(WORLD, cases, tmp_path_factory.mktemp("parallel"))
    yield ranks
    ranks.close()


# ---- the halo conv ------------------------------------------------------------------


@pytest.mark.parametrize("n_spatial", [2, 4])
def test_halo_conv3_matches_the_jax_halo_conv3(n_spatial, world):
    a = _halo_arrays(n_spatial)
    mesh = _jax_mesh(1, n_spatial)

    @jax.jit
    def fwd_bwd(x, w, b, ct):
        y, vjp = jax.vjp(lambda *args: jax_halo_conv3(conv3x3x3_cf_reference, *args, mesh),
                         x, w, b)
        return y, vjp(ct)

    y, (dx, dw, db) = fwd_bwd(_put(mesh, a["x"]), a["w"], a["b"], _put(mesh, a["ct"]))
    outs = world.results(f"halo{n_spatial}")
    assert len(outs) == n_spatial
    got = {"y": torch.cat([o["y"] for o in outs], dim=2),
           "dx": torch.cat([o["dx"] for o in outs], dim=2),
           "dw": sum(o["dw"] for o in outs), "db": sum(o["db"] for o in outs)}
    for name, want in (("y", y), ("dx", dx), ("dw", dw), ("db", db)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


# ---- the train step ----------------------------------------------------------------


@functools.cache
def _jax_global_grads():
    """The JAX gradient of the global batch's ce_tversky loss (train-mode
    forward, one device)."""
    model, loss_fn = _jax_unet(), jax_loss_fn("ce_tversky")

    @jax.jit
    def grads_of(p, bs, images, labels):
        def loss_of(p):
            logits, _ = model.apply({"params": p, "batch_stats": bs}, images, train=True,
                                    mutable=["batch_stats"])
            return loss_fn(logits, labels)
        return jax.grad(loss_of)(p)

    return grads_of


@pytest.mark.parametrize("mesh_name", list(TRAIN_MESHES))
def test_one_train_step_on_the_mesh_matches_jax(mesh_name, world):
    params, stats = _weights(1)
    images, labels = _batch(1)
    mesh = _jax_mesh(*TRAIN_MESHES[mesh_name])
    state = replicate_state(mesh, _jax_sgd_state(_jax_unet().apply, params, stats))
    with jax_use_mesh(mesh):
        state, metrics = jax_train_step(jax_loss_fn("ce_tversky"), nan_guard=True)(
            state, *_put(mesh, images, labels), jax.random.key(0))
        want_sd = trees_to_state_dict(_np(state.params), _np(state.batch_stats))
        want_loss = float(metrics["loss"])
    want_grads = trees_to_state_dict(
        _np(_jax_global_grads()(params, stats, jnp.asarray(images), jnp.asarray(labels))), stats)

    outs = world.results(f"train{mesh_name}")
    assert len(outs) == math.prod(TRAIN_MESHES[mesh_name])
    _check_ranks_agree(outs)
    for out in outs:
        assert out["metrics"]["nonfinite"] == 0.0
        assert out["metrics"]["loss"] == pytest.approx(want_loss, rel=1e-4)
    _check_grads({n: g.numpy() for n, g in outs[0]["grads"].items()},
                 {n: want_grads[n].numpy() for n in outs[0]["grads"]})
    _check_state_after(outs[0], want_sd)


# ---- the sharded eval step ------------------------------------------------------------


def test_sharded_eval_step_with_a_ragged_batch_matches_jax(world):
    params, stats = _weights(2)
    images, labels, weights = _eval_batch()
    mesh = _jax_mesh(2, 2)
    state = replicate_state(mesh, _jax_sgd_state(_jax_unet().apply, params, stats))
    with jax_use_mesh(mesh):
        want = jax_sharded_eval_step(jax_loss_fn("ce_tversky"))(
            state, *_put(mesh, images, labels, weights))
        want = {k: float(v) for k, v in want.items()}
    outs = world.results("eval")
    assert len(outs) == 4 and want["n"] == 1.0
    for out in outs:
        assert set(out["metrics"]) == set(want)
        for k, v in want.items():
            assert out["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
