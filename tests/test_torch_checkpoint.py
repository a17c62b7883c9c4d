"""The port's reader and writer of the JAX package's ``.msgpack`` checkpoints
against the JAX package and flax, on the CPU at a toy size (features 4, 8;
16^3; batch 2; fp32; dropout 0):

* the codec (``engine/msgpack_codec.py``) against ``flax.serialization``:
  a tree of every leaf kind byte-equal to flax's ``msgpack.packb`` call
  (``to_bytes`` after ``to_state_dict``) and read as
  ``msgpack_restore`` reads it, and its refusals named;
* JAX to port to JAX: the train checkpoints the JAX trainer writes (no
  accumulation, ``optax.MultiSteps`` mid-accumulation and after an update,
  a frozen encoder, DANN with its discriminator) resume in the port's
  ``Trainer``, whose ``save_checkpoint`` writes the same bytes back;
* JAX to port: a checkpoint of a JAX run (three steps, accumulation 2)
  loads for eval (forward within 1e-5 of max |jax|, the same argmax) and
  through ``load_params_any`` (strict, non-strict, a raw params tree, the
  JAX package's KeyError cases), and resumes: the moments read equal the
  JAX tree after the transposes, and the next two steps match the JAX
  package's from the same file at ``test_torch_train.py``'s bounds
  (losses 1e-5 relative, the applied gradient 1e-4 of max |jax|, params
  3e-3);
* port to JAX: the port writes a checkpoint of its own run, and the JAX
  package's ``load_checkpoint(path, target)`` restores it against its own
  target and the values are the port's;
* ``--resume`` of a JAX checkpoint in the train and DANN CLIs;
* the port's train CLI writes the JAX train CLI's checkpoint files (the
  same names, sidecars and trees, two epochs of each CLI on one split),
  the JAX package's ``Trainer`` resumes the port's epoch-1 checkpoint and
  trains on, and the port's eval CLI serves the port's best model.
"""

import functools
import json
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from multimodal_segmentation_project_tpu.data.dataset import CombinedDataset as JaxDataset
from multimodal_segmentation_project_tpu.data.pipeline import DataLoader as JaxDataLoader
from multimodal_segmentation_project_tpu.engine import checkpoint as jax_ckpt
from multimodal_segmentation_project_tpu.engine import trainer as jax_trainer_module
from multimodal_segmentation_project_tpu.engine.interop import torch_state_dict_to_trees
from multimodal_segmentation_project_tpu.engine.state import TrainState as JaxTrainState
from multimodal_segmentation_project_tpu.engine.state import (
    create_train_state,
    freeze_mask,
    make_optimizer,
    ones_mask,
)
from multimodal_segmentation_project_tpu.engine.steps import make_train_step as jax_train_step
from multimodal_segmentation_project_tpu.engine.trainer import Trainer as JaxTrainer
from multimodal_segmentation_project_tpu.engine.trainer import TrainerConfig as JaxTrainerConfig
from multimodal_segmentation_project_tpu.models import DomainDiscriminator as JaxDiscriminator
from multimodal_segmentation_project_tpu.ops.losses import get_loss_fn as jax_loss_fn
from multimodal_segmentation_project_tpu.workloads import train_unet as jax_train_unet
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.data import CombinedDataset
from multimodal_segmentation_project_tpu_torch.data.pipeline import DataLoader
from multimodal_segmentation_project_tpu_torch.engine import checkpoint as ckpt
from multimodal_segmentation_project_tpu_torch.engine import msgpack_codec as codec
from multimodal_segmentation_project_tpu_torch.engine.interop import (
    jax_path,
    reference_name,
    to_jax_layout,
    tree_get,
    trees_to_state_dict,
)
from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
from multimodal_segmentation_project_tpu_torch.engine.steps import make_train_step
from multimodal_segmentation_project_tpu_torch.engine.trainer import (
    DannTrainer,
    Trainer,
    TrainerConfig,
)
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)
from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator, UNet3D
from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn
from multimodal_segmentation_project_tpu_torch.workloads import test_model, train_dann, train_unet
from tests.test_torch_workloads import _write_cases

FEATURES = (4, 8)
LR, WD = 1e-3, 0.01
SIZE = 16


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_OPS, 0)


def _batch(seed, n=2):
    rng = np.random.default_rng(seed)
    labels = np.zeros((n, SIZE, SIZE, SIZE), np.int32)
    labels[:, 2:9, 3:10, 4:12] = 2
    labels[:, 10:14, 2:6, 9:14] = 1
    labels[:, 9:13, 11:15, 1:5] = 3
    images = labels[:, None] * 0.3 + rng.normal(0, 0.2, (n, 1, SIZE, SIZE, SIZE))
    return images.astype(np.float32), labels


@functools.cache
def _jax_model():
    """The model the JAX trainer builds for this file's runs (fp32, dropout 0,
    no remat; its "auto" convs are XLA's off a TPU): one init for the file's
    JAX states and JAX trainers."""
    return jax_trainer_module.build_model(JaxTrainerConfig(
        experiment_dir="", experiment_name="", precision="fp32", features=FEATURES,
        dropout_rate=0.0, remat=False))


@functools.cache
def _jitted_init(model):
    """A JAX model's own init, jitted once per model (flax modules compare
    by their fields, so the trainers' models and _jax_model() are one entry):
    the eager init compiles every initializer's op on its own (about 40 s on
    the CPU)."""
    return jax.jit(model.init)


def _jax_create_train_state(model, *args, **kwargs) -> JaxTrainState:
    """The JAX package's create_train_state with the model's own init jitted."""
    return create_train_state(SimpleNamespace(init=_jitted_init(model), apply=model.apply),
                              *args, **kwargs)


def _jax_state(accum: int, seed: int = 0, lr: float = LR) -> JaxTrainState:
    return _jax_create_train_state(_jax_model(), jax.random.key(seed),
                                   jnp.zeros((1, 1, SIZE, SIZE, SIZE)), make_optimizer(WD, accum),
                                   lr)


def _fake_updates(state, n: int, seed: int):
    """``n`` AdamW updates from seeded gradients (eager: no model step)."""
    rng = np.random.default_rng(seed)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for _ in range(n):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), state.params)
        state = apply(state, grads)
    return state


def _disc_state(accum: int, n_updates: int):
    disc = JaxDiscriminator()
    params = disc.init({"params": jax.random.key(7)}, jnp.zeros((1, 2 * FEATURES[-1])))["params"]
    tx = make_optimizer(WD, accum)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                          opt_state=tx.init(params), trainable_mask=ones_mask(params),
                          lr=jnp.asarray(LR, jnp.float32), apply_fn=disc.apply, tx=tx)
    return _fake_updates(state, n_updates, seed=11)


def _jax_save(path, state, epoch=2, best=0.25, extra=None):
    """What the JAX ``Trainer.save_checkpoint`` writes (trainer.py:451-460)."""
    tree = {"epoch": jnp.asarray(epoch), "best_val_dice": jnp.asarray(best), **(extra or {})}
    jax_ckpt.save_checkpoint(str(path), jax_ckpt.state_checkpoint_tree(state, tree),
                             metadata={"epoch": epoch, "encoder_frozen": False, "scheduler": None})
    return str(path)


def _port_unet():
    return UNet3D(in_channels=1, out_channels=4, features=FEATURES, dropout_rate=0.0,
                  dtype=torch.float32)


# ---- the codec against flax.serialization -------------------------------------------


def test_codec_writes_and_reads_every_leaf_kind_as_flax():
    rng = np.random.default_rng(0)
    tree = {
        "z": {"kernel": rng.normal(size=(3, 3, 3, 4, 5)).astype(np.float32),
              "count": np.asarray(7, np.int32), "empty": {}},
        "a": np.float32(2.5), "f64": np.float64(-1.25), "py_float": 0.1, "flag": True,
        "none": None, "s": "x" * 40, "ints": [0, 127, 128, 255, 256, 65536, 2**32, 2**63,
                                             -1, -32, -33, -128, -129, -2**15 - 1, -2**31 - 1],
        "bytes": b"\x00\x01", "big": np.arange(70000, dtype=np.uint8),
        "bool_arr": np.asarray([True, False]), "i64": np.arange(3, dtype=np.int64),
        "zero_size": np.zeros((0, 2), np.float32), "f16": np.ones((2,), np.float16),
        "bf16": np.asarray(jnp.asarray([1.5, -2.0], jnp.bfloat16)),
    }
    # flax's own packing call (msgpack_serialize without its key-sorting tree_map)
    want = msgpack.packb(tree, default=serialization._msgpack_ext_pack, strict_types=True)
    port_tree = dict(tree, bf16=torch.tensor([1.5, -2.0], dtype=torch.bfloat16))
    assert codec.packb(port_tree) == want
    got, ref = codec.unpackb(want), serialization.msgpack_restore(want)
    assert list(got) == list(ref)
    for key in ref:
        g, r = got[key], ref[key]
        if key == "bf16":  # numpy cannot name bfloat16: a torch tensor
            assert g.dtype == torch.bfloat16 and g.tolist() == [1.5, -2.0]
        elif isinstance(r, dict):
            assert list(g) == list(r)
            for k in r:
                np.testing.assert_array_equal(g[k], r[k])
        else:
            assert type(g) is type(r), key
            if isinstance(r, np.ndarray):
                assert g.dtype == r.dtype and g.shape == r.shape and g.flags.writeable
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


@pytest.mark.parametrize("data,match", [
    (bytes.fromhex("d7020000000000000000"), "ext 2"),          # flax's complex
    (bytes.fromhex("d405ff"), "ext type 5"),
    (codec.packb({"w": {"__msgpack_chunked_array__": True, "shape": {}}}), "chunked"),
    (b"\x92\x01", "truncated"),
    (b"\x01\x02", "trailing"),
    (b"\xc1", "0xc1"),
])
def test_codec_refuses_what_it_does_not_read(data, match):
    with pytest.raises(ValueError, match=match):
        codec.unpackb(data)


# ---- JAX -> port -> JAX: the port's trainer writes the JAX trainer's bytes -----------


def _list_dataset(n=1):
    return [(_batch(i, n=1)[0][0], _batch(i, n=1)[1][0]) for i in range(n)]


def _port_trainer(tmp_path, resume, accum, dann=False):
    cfg = TrainerConfig(experiment_dir=str(tmp_path / "exp"), experiment_name="x", epochs=3,
                        lr=LR, weight_decay=WD, grad_accum=accum, dropout_rate=0.0,
                        precision="fp32", features=FEATURES, resume=resume, num_workers=0,
                        device="cpu", freeze_prefixes=("enc", "bottleneck"))
    if dann:
        return DannTrainer(cfg, _list_dataset(), _list_dataset(), _list_dataset())
    return Trainer(cfg, _list_dataset(), _list_dataset())


@pytest.mark.parametrize("case", ["plain", "multisteps_mid", "multisteps_applied", "frozen",
                                  "dann"])
def test_port_trainer_resumes_and_rewrites_the_jax_trainers_checkpoint(tmp_path, case):
    accum = 1 if case in ("plain", "frozen") else 2
    state = _jax_state(accum)
    n = {"plain": 2, "multisteps_mid": 3, "multisteps_applied": 4, "frozen": 2, "dann": 3}[case]
    state = _fake_updates(state, n, seed=1)
    extra = None
    if case == "frozen":  # a fresh optimizer at the freeze, as trainer.py does
        state = state.with_mask(freeze_mask(state.params, ("enc", "bottleneck")))
    if case == "dann":
        disc = _disc_state(accum, 3)
        extra = {"disc_params": disc.params, "disc_opt_state": disc.opt_state}
    path = _jax_save(tmp_path / "jax.msgpack", state, extra=extra)

    trainer = _port_trainer(tmp_path, path, accum, dann=case == "dann")
    assert trainer.start_epoch == 2 and trainer.best_val_dice == 0.25
    assert trainer.state.step == n and trainer.state.mini_step == n % accum
    assert set(trainer.state.frozen_prefixes) == ({"enc", "bottleneck"} if case == "frozen"
                                                  else set())
    out = tmp_path / "port.msgpack"
    trainer.save_checkpoint(str(out), trainer.start_epoch - 1, {}, {})
    assert out.read_bytes() == open(path, "rb").read()
    meta = json.loads((tmp_path / "port.msgpack.json").read_text())
    assert meta["epoch"] == 2 and meta["encoder_frozen"] is False


def test_a_frozen_params_moments_are_written_as_zeros(tmp_path):
    """JAX updates the moments of frozen params behind its mask; the port
    keeps none and writes zeros, which no later step reads."""
    state = _jax_state(1)
    state = state.with_mask(freeze_mask(state.params, ("enc",)))
    state = _fake_updates(state, 2, seed=3)
    path = _jax_save(tmp_path / "jax.msgpack", state)
    trainer = _port_trainer(tmp_path, path, 1)
    assert trainer.state.frozen_prefixes == ("enc",)
    out = str(tmp_path / "port.msgpack")
    trainer.save_checkpoint(out, 1, {}, {})
    target = jax_ckpt.state_checkpoint_tree(_jax_state(1, seed=5), {
        "epoch": jnp.asarray(0), "best_val_dice": jnp.asarray(0.0)})
    back = jax_ckpt.load_checkpoint(out, target)
    for name in ("mu", "nu"):
        for module, sub in back["opt_state"][0]._asdict()[name].items():
            want = getattr(state.opt_state[0], name)[module]
            for got_leaf, want_leaf in zip(jax.tree.leaves(sub), jax.tree.leaves(want)):
                if module.startswith("enc"):
                    assert not np.asarray(got_leaf).any()
                else:
                    np.testing.assert_array_equal(np.asarray(got_leaf), np.asarray(want_leaf))
    for got_leaf, want_leaf in zip(jax.tree.leaves(back["trainable_mask"]),
                                   jax.tree.leaves(state.trainable_mask)):
        assert float(got_leaf) == float(want_leaf)


# ---- JAX -> port: eval, load_params_any and the next steps of a resumed run ----------


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Three JAX train steps with accumulation 2 (one AdamW update, then one
    gradient accumulated), saved as the JAX trainer saves; then step 4."""
    state = _jax_state(2)
    step = jax_train_step(jax_loss_fn("ce_tversky"), augment=False, nan_guard=True)
    for i in range(3):
        state, _ = step(state, *map(jnp.asarray, _batch(i)), jax.random.key(0))
    path = _jax_save(tmp_path_factory.mktemp("jax_run") / "run.msgpack", state)
    saved = jax.device_get(state)  # the step donates its input state
    after, metrics = step(state, *map(jnp.asarray, _batch(3)), jax.random.key(0))
    return {"path": path, "state": saved, "after": jax.device_get(after),
            "loss4": float(metrics["loss"])}


def _sd(params, stats):
    return trees_to_state_dict(jax.device_get(params), jax.device_get(stats))


def test_a_jax_checkpoint_serves_in_eval(jax_run):
    state = jax_run["state"]
    model = _port_unet()
    assert ckpt.load_params_any(model, jax_run["path"]) == []
    x = _batch(9)[0]
    want = np.asarray(_jax_model().apply({"params": state.params,
                                          "batch_stats": state.batch_stats},
                                         jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_load_params_any_strict_and_nonstrict(jax_run, tmp_path):
    state = jax_run["state"]
    want = _sd(state.params, state.batch_stats)
    raw = str(tmp_path / "raw.msgpack")  # a raw params tree: no batch_stats
    jax_ckpt.save_checkpoint(raw, state.params)
    model = _port_unet()
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    assert ckpt.load_params_any(model, raw) == []
    for k, v in model.state_dict().items():
        assert torch.equal(v, initial[k] if "running" in k or "num_batches" in k else want[k]), k

    # another head (3 classes), as tests/test_engine.py's lenient case
    other = UNet3D(in_channels=1, out_channels=3, features=FEATURES, dtype=torch.float32)
    initial = {k: v.clone() for k, v in other.state_dict().items()}
    with pytest.raises(KeyError, match="head_kernel"):
        ckpt.load_params_any(other, jax_run["path"], strict=True)
    kept = ckpt.load_params_any(other, jax_run["path"], strict=False)
    assert sorted(kept) == ["final_conv.bias", "final_conv.weight"]
    for k, v in other.state_dict().items():
        assert torch.equal(v, initial[k] if k in kept or "num_batches" in k else want[k]), k

    # a param missing from the checkpoint
    params = jax.device_get(state.params)
    del params["dec1"]["conv"]["conv1"]["kernel"]
    params["proj"] = {"kernel": np.ones((2, 3), np.float32)}  # only the checkpoint has these:
    params["temperature"] = np.float32(2)                      # ignored, as the JAX load does
    partial = str(tmp_path / "partial.msgpack")
    jax_ckpt.save_checkpoint(partial, {"params": params, "batch_stats": state.batch_stats})
    with pytest.raises(KeyError, match="dec1/conv/conv1/kernel"):
        ckpt.load_params_any(_port_unet(), partial)
    assert ckpt.load_params_any(_port_unet(), partial, strict=False) == [
        "decoder.1.double_conv.4.weight"]


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert np.abs(got - want).max() <= tol * scale, name


def test_a_resumed_run_takes_the_jax_packages_next_steps(jax_run):
    saved, after = jax_run["state"], jax_run["after"]
    model = _port_unet()
    state = TrainState(model, LR, weight_decay=WD, grad_accum_steps=2)
    ckpt.restore_train_state(state, ckpt.load_checkpoint(jax_run["path"]))
    assert state.step == 3 and state.mini_step == 1 and state.lr == float(np.float32(LR))
    # the moments and the accumulator as read: the JAX tree's, transposed
    adam = saved.opt_state.inner_opt_state[0]
    for p_name, p in model.named_parameters():
        st = state.optimizer.state[p]
        assert int(st["step"]) == int(adam.count) == 1 and st["step"].dtype == torch.float32
        path = jax_path(p_name)
        for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            np.testing.assert_array_equal(to_jax_layout(path, st[key]), tree_get(tree, path))
        np.testing.assert_array_equal(to_jax_layout(path, state.acc_grads[p_name]),
                                      tree_get(saved.opt_state.acc_grads, path))

    # step 4 applies AdamW to the mean of step 3's and step 4's gradients
    @jax.jit
    def grads_of(p, bs, images, labels):
        def loss_of(p):
            logits, _ = _jax_model().apply({"params": p, "batch_stats": bs}, images, train=True,
                                           mutable=["batch_stats"])
            return jax_loss_fn("ce_tversky")(logits, labels)
        return jax.grad(loss_of)(p)

    g4 = jax.device_get(grads_of(saved.params, saved.batch_stats, *map(jnp.asarray, _batch(3))))
    g3 = jax.device_get(saved.opt_state.acc_grads)
    applied = _sd(jax.tree_util.tree_map(lambda a, g: a + (g - a) / 2, g3, g4),
                  saved.batch_stats)
    metrics = make_train_step(get_loss_fn("ce_tversky"), nan_guard=True)(
        state, *map(torch.from_numpy, _batch(3)))
    assert float(metrics["loss"]) == pytest.approx(jax_run["loss4"], rel=1e-5)
    largest = max(float(np.abs(applied[n].numpy()).max()) for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        if name.endswith(("double_conv.0.bias", "double_conv.4.bias")):  # BN-fed: ~0
            assert float(p.grad.abs().max()) < 1e-5 * largest
        else:
            _close(p.grad, applied[name], 1e-4, name)
    want = _sd(after.params, after.batch_stats)
    for name, value in model.state_dict().items():
        if "num_batches" not in name:
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), rtol=0, atol=3e-3,
                                       err_msg=name)
    assert state.step == 4 and state.mini_step == 0


# ---- port -> JAX ----------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_the_jax_package_restores_the_ports_checkpoint(tmp_path, accum):
    model = _port_unet()
    model.load_state_dict(_sd(*(lambda s: (s.params, s.batch_stats))(_jax_state(accum, seed=4))))
    state = TrainState(model, 3e-4, weight_decay=WD, grad_accum_steps=accum)
    step = make_train_step(get_loss_fn("ce_tversky"), nan_guard=True)
    for i in range(3):
        step(state, *map(torch.from_numpy, _batch(i)))
    path = str(tmp_path / "port.msgpack")
    ckpt.save_checkpoint(path, ckpt.state_checkpoint_tree(state, {
        "epoch": np.asarray(3, np.int32), "best_val_dice": np.asarray(0.5, np.float32)}))
    target = jax_ckpt.state_checkpoint_tree(_jax_state(accum, seed=9), {
        "epoch": jnp.asarray(0), "best_val_dice": jnp.asarray(0.0)})
    tree = jax_ckpt.load_checkpoint(path, target)
    restored = jax_ckpt.restore_train_state(_jax_state(accum, seed=9), tree)
    assert int(restored.step) == 3 and float(restored.lr) == np.float32(3e-4)
    assert int(tree["epoch"]) == 3
    got = _sd(restored.params, restored.batch_stats)
    for name, value in model.state_dict().items():
        if "num_batches" not in name:
            np.testing.assert_array_equal(got[name].numpy(), value.numpy(), err_msg=name)
    inner = restored.opt_state.inner_opt_state if accum > 1 else restored.opt_state
    assert int(inner[0].count) == (1 if accum > 1 else 3)
    mu = trees_to_state_dict(jax.device_get(inner[0].mu), {})
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(mu[name].numpy(),
                                      state.optimizer.state[p]["exp_avg"].numpy(), err_msg=name)
    if accum > 1:
        assert int(restored.opt_state.mini_step) == 1
        acc = trees_to_state_dict(jax.device_get(restored.opt_state.acc_grads), {})
        for name in state.acc_grads:
            np.testing.assert_array_equal(acc[name].numpy(), state.acc_grads[name].numpy())


# ---- --resume of a JAX checkpoint in the CLIs -----------------------------------------


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt_data")
    for i, (split, n) in enumerate([("train", 1), ("val", 1), ("target", 1),
                                    ("dann_add_labeled", 1), ("dann_add_unlabeled", 1)]):
        _write_cases(root, split, "synth_ct", n, seed=10 * i)
        _write_cases(root, split, "synth_mri", n, seed=10 * i + 1)
    return root


@pytest.mark.parametrize("cli", [train_unet, train_dann], ids=["train_unet", "train_dann"])
def test_the_clis_resume_a_jax_checkpoint(data_root, tmp_path, capsys, cli):
    extra = None
    if cli is train_dann:
        disc = _disc_state(1, 2)
        extra = {"disc_params": disc.params, "disc_opt_state": disc.opt_state}
    path = _jax_save(tmp_path / "jax.msgpack", _fake_updates(_jax_state(1), 2, seed=2),
                     epoch=1, extra=extra)
    argv = ["--data_root", str(data_root), "--experiment_dir", str(tmp_path / "exp"),
            "--features", "4,8", "--device", "cpu", "--mixed_precision", "no",
            "--batch_size", "1", "--num_workers", "0", "--epochs", "2", "--resume", path]
    if cli is train_dann:
        argv += ["--source_modality", "mri", "--target_modality", "ct"]
    args = cli.build_parser().parse_args(argv)
    args.experiment_name = "resumed"
    summary = cli.main(args)
    assert f"[RESUME] from {path} at epoch 1" in capsys.readouterr().out
    assert summary["epoch"] == 2 and np.isfinite(summary["train"]["loss"])


# ---- the CLIs' checkpoint files ---------------------------------------------------------

# one device for the JAX CLI too: the test process's CPU mesh would shard the volume
CLI_ARGV = ["--features", "4,8", "--mixed_precision", "no", "--batch_size", "1",
            "--num_workers", "0", "--epochs", "2", "--modalities", "ct", "--dropout_rate", "0.0",
            "--n_data", "1", "--no_auto_spatial", "--no_remat"]


def _layout(tree, path=()):
    """{path: (shape, dtype)} of every leaf of a checkpoint tree."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _layout(sub, (*path, k)).items()}
    return {path: (tuple(np.shape(tree)), str(np.asarray(tree).dtype))}


@pytest.fixture(scope="module")
def cli_checkpoints(data_root, tmp_path_factory):
    """The checkpoint directories of the port's train CLI and of the JAX
    package's, each run for two epochs on the same CT split with the same
    flags (the port's on the CPU)."""
    dirs = []
    for cli, extra in ((train_unet, ["--device", "cpu"]), (jax_train_unet, [])):
        exp = tmp_path_factory.mktemp("cli")
        args = cli.build_parser().parse_args(
            ["--data_root", str(data_root), "--experiment_dir", str(exp), *CLI_ARGV, *extra])
        args.experiment_name = "run"
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_trainer_module, "create_train_state", _jax_create_train_state)
            cli.main(args)
        dirs.append(exp / "run" / "checkpoints")
    return dirs


def test_the_train_cli_writes_the_jax_clis_checkpoint_files(cli_checkpoints):
    """The same file names, the same sidecar keys, and trees with the same
    leaves (paths, shapes, dtypes)."""
    port, ref = cli_checkpoints
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref)) == ["best_model_run.msgpack",
                                                 "best_model_run.msgpack.json"]
    mine, theirs = (str(d / "best_model_run.msgpack") for d in (port, ref))
    assert _layout(ckpt.load_checkpoint(mine)) == _layout(ckpt.load_checkpoint(theirs))
    assert set(ckpt.load_metadata(mine)) == set(ckpt.load_metadata(theirs))


def test_the_eval_cli_serves_the_ports_best_model(cli_checkpoints, data_root, tmp_path,
                                                  monkeypatch):
    """The port's eval CLI on the port's best_model_*.msgpack: its model is
    the checkpoint's, its metrics finite."""
    best = cli_checkpoints[0] / "best_model_run.msgpack"
    (tmp_path / "data").mkdir()
    os.symlink(data_root / "val", tmp_path / "data" / "test")
    loaded = []

    def load(model, path):
        loaded.append(model)
        return ckpt.load_params_any(model, path)

    monkeypatch.setattr(test_model, "load_params_any", load)
    overall = test_model.main(test_model.build_parser().parse_args([
        "--model_path", str(best), "--data_root", str(tmp_path / "data"), "--experiment_dir",
        str(tmp_path), "--model_name", "served", "--precision", "fp32", "--features", "4,8",
        "--device", "cpu", "--no_visualizations", "--modalities", "ct"]))
    assert np.isfinite(overall["mean_dice_overall"])
    tree = ckpt.load_checkpoint(str(best))
    want = _sd(tree["params"], tree["batch_stats"])
    for name, value in loaded[0].state_dict().items():
        if "num_batches" not in name:
            assert torch.equal(value, want[name]), name


def test_the_jax_trainer_resumes_the_ports_epoch1_checkpoint(data_root, tmp_path, monkeypatch):
    """A port Trainer checkpointing every epoch writes
    checkpoint_epoch1_<name>.msgpack and its sidecar; the JAX package's
    Trainer resumes from it (params, statistics, step, best val Dice, the
    scheduler) and trains epoch 2."""
    datasets = [CombinedDataset(str(data_root / split), ["ct"]) for split in ("train", "val")]
    cfg = TrainerConfig(experiment_dir=str(tmp_path / "port"), experiment_name="run", epochs=1,
                        lr=LR, weight_decay=WD, dropout_rate=0.0, precision="fp32",
                        features=FEATURES, num_workers=0, device="cpu", checkpoint_every=1,
                        use_scheduler=True)
    port = Trainer(cfg, *datasets)
    port.run()
    path = tmp_path / "port" / "run" / "checkpoints" / "checkpoint_epoch1_run.msgpack"
    assert Path(f"{path}.json").exists()

    monkeypatch.setattr(jax_trainer_module, "create_train_state", _jax_create_train_state)
    jcfg = JaxTrainerConfig(experiment_dir=str(tmp_path / "jax"), experiment_name="resumed",
                            epochs=2, lr=LR, weight_decay=WD, dropout_rate=0.0, precision="fp32",
                            features=FEATURES, num_workers=0, checkpoint_every=1,
                            use_scheduler=True, resume=str(path), verbose=False, n_data=1,
                            auto_spatial=False, remat=False)
    resumed = JaxTrainer(jcfg, *[JaxDataset(str(data_root / s), ["ct"]) for s in ("train", "val")])
    assert resumed.start_epoch == 1 and int(resumed.state.step) == port.state.step
    # both trainers write the periodic checkpoint before the epoch's best-model update
    assert resumed.best_val_dice == float(ckpt.load_checkpoint(str(path))["best_val_dice"])
    assert resumed.scheduler.state_dict() == port.scheduler.state_dict()
    got = _sd(resumed.state.params, resumed.state.batch_stats)
    for name, value in port.state.model.state_dict().items():
        if "num_batches" not in name:
            np.testing.assert_array_equal(got[name].numpy(), value.numpy(), err_msg=name)
    summary = resumed.run()
    assert summary["epoch"] == 2 and np.isfinite(summary["train"]["loss"])


# ---- the name mapping and the loader's shuffle ------------------------------------------


def test_the_name_mapping_is_the_jax_packages_both_ways():
    """Every state-dict name of a default-width UNet3D lands where the JAX
    package's ``torch_state_dict_to_trees`` puts it, and maps back; so does
    every name of the discriminator."""
    sd = {k: v for k, v in UNet3D().state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = torch_state_dict_to_trees(sd)
    jax_paths = {tuple(str(getattr(k, "key", k)) for k in path)
                 for tree in (params, stats)
                 for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert {jax_path(name) for name in sd} == jax_paths
    names = [*sd, *DomainDiscriminator(16).state_dict()]
    assert [reference_name(jax_path(name)) for name in names] == names
    with pytest.raises(KeyError, match="no place"):
        jax_path("encoder.0.double_conv.2.weight")
    with pytest.raises(KeyError, match="no place"):
        reference_name(("enc0", "bn2", "scale"))


def test_the_loaders_shuffle_against_the_jax_loaders():
    """Uninterrupted, the port's loader draws the JAX loader's shuffle epoch
    by epoch. Resumed at epoch e (``set_epoch``), it draws epoch e's, where
    a fresh JAX loader draws epoch 0's: a stated departure, which makes a
    resumed run see the uninterrupted run's batches."""
    dataset = [(np.full((1,), i), np.full((1,), i)) for i in range(9)]

    def order(loader):
        return [int(images[0, 0]) for images, _ in loader]

    kw = dict(batch_size=1, shuffle=True, seed=7, num_workers=0)
    port, ref = DataLoader(dataset, **kw), JaxDataLoader(dataset, **kw)
    epochs = [order(ref) for _ in range(3)]
    assert [order(port) for _ in range(3)] == epochs
    assert len({tuple(e) for e in epochs}) == 3
    resumed = DataLoader(dataset, **kw)
    resumed.set_epoch(2)
    assert order(resumed) == epochs[2]
    assert order(JaxDataLoader(dataset, **kw)) == epochs[0]
