"""The port's training path on the CPU against the JAX package's, with the
same weights carried across (``engine.interop.trees_to_state_dict``).

* DoubleConv in train mode: the port's per-conv chain (which dec1 and the
  deep region run) and its fused block, each against the JAX package's
  fused Pallas DoubleConv (interpret mode, fp32, dropout 0): outputs,
  running statistics and gradients within 2e-5 of max |jax| (the same
  function; the per-conv chain takes its statistics as means, the fused
  ops as sums, and the sums run in other orders).
* Two train steps of ``make_train_step`` against the JAX one (XLA convs,
  fp32, dropout 0, augmentation off, batch 2, AdamW from zero moments):
  first-step gradients within 1e-4 of max |jax| per parameter, losses
  within 1e-5 relative, the first step's running statistics within 1e-5 of
  max |jax|, params within 3e-3 absolute after two steps (AdamW's first
  step moves a parameter by about lr * sign(g), so a gradient near 0 may
  flip sign and land up to 2 * lr away; the second step's statistics
  inherit that), and the second step's own update: every parameter moved,
  and each one but the BN-fed biases by JAX's update within 1e-3
  norm-relative.
* A conv bias that feeds a train-mode BatchNorm has a true gradient of 0;
  both sides must give less than 1e-5 of the largest gradient there.
* The NaN guard, gradient accumulation against optax.MultiSteps, the train
  CLI end to end with resume and the eval CLI on its checkpoint, and the
  port's data stack against the JAX package's.
"""

import csv
import functools
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_segmentation_project_tpu.data.dataset import CombinedDataset as JaxDataset
from multimodal_segmentation_project_tpu.engine.state import TrainState as JaxTrainState
from multimodal_segmentation_project_tpu.engine.state import make_optimizer, ones_mask
from multimodal_segmentation_project_tpu.engine.steps import make_train_step as jax_train_step
from multimodal_segmentation_project_tpu.engine.trainer import Trainer as JaxTrainer
from multimodal_segmentation_project_tpu.models import UNet3D as JaxUNet3D
from multimodal_segmentation_project_tpu.models.unet3d import DoubleConv as JaxDoubleConv
from multimodal_segmentation_project_tpu.ops.losses import get_loss_fn as jax_loss_fn
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.data import CombinedDataset, save_nifti
from multimodal_segmentation_project_tpu_torch.engine import checkpoint as ckpt
from multimodal_segmentation_project_tpu_torch.engine.interop import trees_to_state_dict
from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
from multimodal_segmentation_project_tpu_torch.engine.steps import make_train_step
from multimodal_segmentation_project_tpu_torch.models import UNet3D
from multimodal_segmentation_project_tpu_torch.models.unet3d import DoubleConv
from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn
from multimodal_segmentation_project_tpu_torch.workloads import test_model, train_unet
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

FEATURES = (4, 8)
LR = 1e-3


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_OPS, 0)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


def _close(got, want, tol, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: max err {err} > {tol} * {scale}"


def _bn_fed_bias(name: str) -> bool:
    """A conv bias followed by a train-mode BatchNorm: its true gradient is 0."""
    return name.endswith(("double_conv.0.bias", "double_conv.4.bias"))


def _check_grads(got: dict, want: dict, tol: float):
    """Per-parameter gradients; the BN-fed conv biases must be ~0 on both sides."""
    assert set(got) == set(want)
    largest = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name in want:
        if _bn_fed_bias(name):
            for side in (got[name], want[name]):
                assert float(np.abs(np.asarray(side)).max()) < 1e-5 * largest, name
        else:
            _close(got[name], want[name], tol, name)


def _double_conv_state_dict(params, stats) -> dict:
    """One JAX DoubleConv's (params, batch_stats) -> the port block's state dict."""
    full = trees_to_state_dict({"bottleneck": params, "head_kernel": np.zeros((1, 1)),
                                "head_bias": np.zeros(1)}, {"bottleneck": stats})
    return {k.removeprefix("bottleneck."): v for k, v in full.items()
            if k.startswith("bottleneck.")}


# ---- DoubleConv: the port's two train paths against the fused Pallas JAX block ---


def test_unfused_doubleconv_matches_the_fused_pallas_doubleconv():
    """The per-conv chain and the fused block, one JAX reference."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 8, 8, 16)).astype(np.float32)
    g = rng.normal(size=(2, 8, 8, 8, 16)).astype(np.float32)
    jmod = JaxDoubleConv(features=8, dropout_rate=0.0, dtype=jnp.float32, conv_impl="pallas")
    # the XLA block has the same param tree and initialises without interpret mode
    init_mod = JaxDoubleConv(features=8, dropout_rate=0.0, dtype=jnp.float32, conv_impl="xla")
    variables = init_mod.init({"params": jax.random.key(0)}, jnp.asarray(x), train=True)
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    for i in range(2):  # a non-trivial BatchNorm affine and running statistics
        params[f"bn{i}"] = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                            "bias": rng.normal(0, 0.1, 8).astype(np.float32)}
        stats[f"bn{i}"] = {"mean": rng.normal(0, 0.1, 8).astype(np.float32),
                           "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}

    @jax.jit
    def fused(p, xx, gg):
        def run(p, xx):
            return jmod.apply({"params": p, "batch_stats": stats}, xx, train=True,
                              mutable=["batch_stats"])

        (out, upd), pullback = jax.vjp(run, p, xx)
        zero_stats = jax.tree_util.tree_map(jnp.zeros_like, upd)
        return out, upd, pullback((gg, zero_stats))

    want, upd, (gp, gx) = fused(params, jnp.asarray(x), jnp.asarray(g))

    want_sd = _double_conv_state_dict(_np(gp), _np(upd["batch_stats"]))

    for path in ("forward_train_per_conv", "forward_train_fused"):
        block = DoubleConv(4, 8, dropout_rate=0.0)
        block.load_state_dict(_double_conv_state_dict(params, stats))
        block.train()
        xt = torch.from_numpy(x).requires_grad_(True)
        got = getattr(block, path)(xt, torch.float32)
        got.backward(torch.from_numpy(g))

        _close(got.detach(), want, 2e-5, f"{path} y")
        _close(xt.grad, gx, 2e-5, f"{path} dx")
        for k, v in block.state_dict().items():
            if "running" in k:
                _close(v, want_sd[k], 2e-5, f"{path} {k}")
        _check_grads({n: p.grad.numpy() for n, p in block.named_parameters()},
                     {n: want_sd[n].numpy() for n, _ in block.named_parameters()}, 2e-5)


# ---- two train steps against the JAX make_train_step ------------------------------


def _batch(seed, n=2, size=16):
    rng = np.random.default_rng(seed)
    labels = np.zeros((n, size, size, size), np.int32)
    labels[:, 2:9, 3:10, 4:12] = 2
    labels[:, 10:14, 2:6, 9:14] = 1
    labels[:, 9:13, 11:15, 1:5] = 3
    images = labels[:, None] * 0.3 + rng.normal(0, 0.2, (n, 1, size, size, size))
    return images.astype(np.float32), labels


@functools.cache
def _jax_setup():
    """The JAX model and its initial (params, batch_stats) as numpy, one
    jitted init for the file (the tests only read them)."""
    model = JaxUNet3D(out_channels=4, features=FEATURES, dropout_rate=0.0, dtype=jnp.float32,
                      conv_impl="xla")
    variables = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 1, 16, 16, 16)))
    return model, _np(variables["params"]), _np(variables["batch_stats"])


def _port_model(params, stats) -> UNet3D:
    model = UNet3D(in_channels=1, out_channels=4, features=FEATURES, dropout_rate=0.0,
                   dtype=torch.float32)
    model.load_state_dict(trees_to_state_dict(params, stats), strict=True)
    return model


def test_two_train_steps_match_jax(monkeypatch):
    """Two fp32 steps with the card's routing: every block of the test's
    model takes the fused block (tests/test_torch_fp32_train.py holds the
    per-conv chain)."""
    fused, per_conv = [], []
    real_fused = DoubleConv.forward_train_fused
    real_chain = DoubleConv.forward_train_per_conv
    monkeypatch.setattr(DoubleConv, "forward_train_fused",
                        lambda self, *a: fused.append(self) or real_fused(self, *a))
    monkeypatch.setattr(DoubleConv, "forward_train_per_conv",
                        lambda self, *a: per_conv.append(self) or real_chain(self, *a))
    check_two_train_steps_against_jax()
    assert len(fused) == 2 * 5 and not per_conv  # two steps, five DoubleConvs at two levels


def check_two_train_steps_against_jax():
    """Two steps of the port's make_train_step against the JAX one, at the
    bounds of the module docstring (tests/test_torch_fp32_train.py runs it
    with every block on the per-conv chain)."""
    model, params, stats = _jax_setup()
    jloss = jax_loss_fn("ce_tversky")
    tx = make_optimizer(weight_decay=0.01)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                           opt_state=tx.init(params), trainable_mask=ones_mask(params),
                           lr=jnp.asarray(LR, jnp.float32), apply_fn=model.apply, tx=tx)
    batches = [_batch(1), _batch(2)]

    @jax.jit
    def grads_of(p, bs, images, labels):
        def loss_of(p):
            logits, _ = model.apply({"params": p, "batch_stats": bs}, images, train=True,
                                    mutable=["batch_stats"])
            return jloss(logits, labels)
        return jax.grad(loss_of)(p)

    want_grads = trees_to_state_dict(_np(grads_of(params, stats, *map(jnp.asarray, batches[0]))),
                                     stats)
    jstep = jax_train_step(jloss, augment=False, nan_guard=True)
    want_losses, want_sd = [], []
    for images, labels in batches:
        jstate, m = jstep(jstate, jnp.asarray(images), jnp.asarray(labels), jax.random.key(0))
        want_losses.append(float(m["loss"]))
        want_sd.append(trees_to_state_dict(_np(jstate.params), _np(jstate.batch_stats)))

    port = _port_model(params, stats)
    state = TrainState(port, LR, weight_decay=0.01)
    step = make_train_step(get_loss_fn("ce_tversky"), augment=False, nan_guard=True)
    got_losses, got_params = [], []
    for i, (images, labels) in enumerate(batches):
        m = step(state, torch.from_numpy(images), torch.from_numpy(labels))
        got_losses.append(float(m["loss"]))
        got_params.append({n: p.detach().clone() for n, p in port.named_parameters()})
        assert float(m["nonfinite"]) == 0.0
        if i == 0:  # the gradients the first update applied, the statistics it left
            _check_grads({n: p.grad.numpy() for n, p in port.named_parameters()},
                         {n: want_grads[n].numpy() for n, _ in port.named_parameters()}, 1e-4)
            for name, value in port.state_dict().items():
                if "running" in name:
                    _close(value, want_sd[0][name], 1e-5, name)
    assert state.step == 2
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    for name, value in port.state_dict().items():
        if "num_batches" not in name:
            np.testing.assert_allclose(value.numpy(), want_sd[1][name].numpy(), rtol=0,
                                       atol=3e-3, err_msg=name)
    # the second update itself: every parameter moved, and away from the
    # BN-fed biases (whose ~0 gradients give AdamW a noise sign) it moved as
    # JAX's did, within 1e-3 norm-relative (7e-5 seen)
    for name, after in got_params[1].items():
        moved = (after - got_params[0][name]).numpy()
        assert np.abs(moved).min() > 0.0, f"{name}: not updated by the second step"
        if not _bn_fed_bias(name):
            want = want_sd[1][name].numpy() - want_sd[0][name].numpy()
            rel = np.linalg.norm(moved - want) / np.linalg.norm(want)
            assert rel <= 1e-3, f"{name}: second update off by {rel} norm-relative"


def test_nan_guard_rolls_back_the_whole_state():
    _, params, stats = _jax_setup()
    model = _port_model(params, stats)
    state = TrainState(model, LR, weight_decay=0.01)
    step = make_train_step(get_loss_fn("ce_tversky"), nan_guard=True)
    images, labels = (torch.from_numpy(a) for a in _batch(3))
    step(state, images, labels)  # non-zero Adam moments to protect

    def snapshot():
        opt = [t.clone() for st in state.optimizer.state.values() for t in st.values()]
        return ([t.clone() for t in model.state_dict().values()], opt, state.step,
                state.mini_step)

    before = snapshot()
    poisoned = images.clone()
    poisoned[0, 0, 3, 3, 3] = float("nan")
    m = step(state, poisoned, labels)
    assert float(m["nonfinite"]) == 1.0 and float(m["loss"]) == 0.0
    after = snapshot()
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert torch.equal(a, b)  # params, BN statistics, Adam moments and step counts
    assert before[2:] == after[2:]
    m = step(state, images, labels)  # the next finite step trains on
    assert float(m["nonfinite"]) == 0.0 and state.step == before[2] + 1


def test_gradient_accumulation_averages_like_optax_multisteps():
    rng = np.random.default_rng(4)
    p0 = {"w": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    tx = make_optimizer(weight_decay=0.01, grad_accum_steps=2)
    jparams, opt_state = dict(p0), tx.init(p0)

    module = torch.nn.Module()
    module.w = torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))
    module.b = torch.nn.Parameter(torch.from_numpy(p0["b"].copy()))
    state = TrainState(module, 0.05, weight_decay=0.01, grad_accum_steps=2)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, jax.tree_util.tree_map(lambda u: 0.05 * u, updates))
        module.w.grad, module.b.grad = torch.from_numpy(g["w"]), torch.from_numpy(g["b"])
        state.apply_gradients()
        for k in ("w", "b"):
            np.testing.assert_allclose(getattr(module, k).detach().numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
    assert state.step == 5 and state.mini_step == 1


def test_freeze_mask_blocks_updates_of_the_encoder():
    _, params, stats = _jax_setup()
    model = _port_model(params, stats)
    state = TrainState(model, LR)
    state.with_mask(("enc",))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    make_train_step(get_loss_fn("ce_tversky"))(state, *(torch.from_numpy(a) for a in _batch(5)))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == n.startswith("encoder."), n


# ---- the train CLI, end to end on the CPU ----------------------------------------


def _write_split(root, split, n, seed, size=16):
    rng = np.random.default_rng(seed)
    for name in ("synth_ct", "synth_mri"):
        img_dir, lbl_dir = root / split / name / "images", root / split / name / "labels"
        img_dir.mkdir(parents=True)
        lbl_dir.mkdir(parents=True)
        for i in range(n):
            lbl = _batch(seed + i, n=1, size=size)[1][0].astype(np.int16)
            img = lbl.astype(np.float32) * 60 + rng.normal(0, 25, lbl.shape)
            affine = np.diag([1.5, 1.5, 2.0, 1.0])
            save_nifti(img.astype(np.float32), str(img_dir / f"c{i:02d}.nii.gz"), affine=affine)
            save_nifti(lbl, str(lbl_dir / f"c{i:02d}.nii.gz"), affine=affine)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    for i, split in enumerate(("train", "val", "test")):
        _write_split(root, split, 1, seed=10 * i)
    return root


def _train_args(data_root, exp, name, *extra):
    args = train_unet.build_parser().parse_args([
        "--data_root", str(data_root), "--experiment_dir", str(exp), "--batch_size", "1",
        "--features", "4,8", "--device", "cpu", "--mixed_precision", "no",
        "--loss", "ce_tversky", "--num_workers", "0", *extra])
    args.experiment_name = name
    return args


def test_train_cli_checkpoints_resume_and_eval(data_root, tmp_path, capsys):
    exp = tmp_path / "exp"
    summary = train_unet.main(_train_args(data_root, exp, "run", "--epochs", "2"))
    assert summary["epoch"] == 2 and np.isfinite(summary["train"]["loss"])
    with open(exp / "run" / "logs" / "train_log.csv") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    assert reader.fieldnames == JaxTrainer.CSV_COLUMNS
    assert [r["epoch"] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r[k])) for r in rows for k in ("train_loss", "val_loss"))
    assert (exp / "run" / "config.txt").exists()
    assert (exp / "run" / "logs" / "device_usage.log").exists()
    # the JAX CLI's checkpoint: the train state's tree and its JSON sidecar
    best = exp / "run" / "checkpoints" / "best_model_run.msgpack"
    assert sorted(os.listdir(best.parent)) == [best.name, f"{best.name}.json"]
    tree, meta = ckpt.load_checkpoint(str(best)), ckpt.load_metadata(str(best))
    assert set(tree) == {"best_val_dice", "batch_stats", "epoch", "lr", "opt_state", "params",
                         "step", "trainable_mask"}
    assert set(meta) == {"epoch", "train_loss", "val_loss", "train_dice", "val_dice",
                         "encoder_frozen", "scheduler"}
    epoch = int(tree["epoch"])
    assert meta["epoch"] == epoch and meta["scheduler"] is not None

    train_unet.main(_train_args(data_root, exp, "resumed", "--epochs", str(epoch + 1),
                                "--resume", str(best)))
    assert f"[RESUME] from {best} at epoch {epoch}" in capsys.readouterr().out
    with open(exp / "resumed" / "logs" / "train_log.csv") as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == [str(epoch + 1)]

    overall = test_model.main(test_model.build_parser().parse_args([
        "--model_path", str(best), "--data_root", str(data_root), "--experiment_dir", str(exp),
        "--model_name", "trained", "--precision", "fp32", "--features", "4,8",
        "--device", "cpu", "--no_visualizations"]))
    assert np.isfinite(overall["mean_dice_overall"])


# in a world of one (no torchrun environment): each asks for ranks that do
# not exist, and the refusal says to launch under torchrun
@pytest.mark.parametrize("extra,match", [
    (("--n_spatial", "2"), "torchrun"),
    (("--n_data", "4"), "torchrun"),
    (("--multihost",), "torchrun"),
])
def test_train_cli_refuses_mesh_flags(data_root, tmp_path, extra, match):
    with pytest.raises(ValueError, match=match):
        train_unet.main(_train_args(data_root, tmp_path, "x", *extra))


def test_train_cli_refuses_cuda_without_a_gpu(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot show")
    args = _train_args(data_root, tmp_path, "x")
    args.device, args.mixed_precision = "cuda", "bf16"
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_unet.main(args)


def test_data_stack_yields_the_jax_packages_arrays(data_root):
    for split in ("train", "val"):
        mine, ref = CombinedDataset(str(data_root / split)), JaxDataset(str(data_root / split))
        assert len(mine) == len(ref) == 2
        assert [s.image_path for s in mine.samples] == [s.image_path for s in ref.samples]
        for i in range(len(ref)):
            for a, b in zip(mine[i], ref[i]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
