"""The port's distillation and DANN steps on the CPU against the JAX
package's, with the same weights carried across
(``engine.interop.trees_to_state_dict`` and
``discriminator_params_to_state_dict``).

Toy size: features (4, 8), 16^3, batch 2, fp32, dropout 0 (the dropout
streams cannot match across frameworks), augmentation off, XLA convs on
the JAX side. The bounds are those of ``tests/test_torch_train.py``:

* losses within 1e-5 relative;
* the first step's gradients within 1e-4 of max |jax| per parameter, the
  discriminator's included; a conv bias that feeds a train-mode BatchNorm
  (true gradient 0) below 1e-5 of the largest gradient on both sides;
* the first step's BatchNorm running statistics within 1e-5 of max |jax|
  (DANN: after both forwards, the source's and then the target's);
* params within 3e-3 absolute after two steps (AdamW's first step moves a
  parameter by about lr * sign(g), so a gradient near 0 may flip sign and
  land up to 2 * lr away), and the second step's own update within 1e-3
  norm-relative of JAX's for every parameter but the BN-fed biases.

Also: the DANN NaN guard (a poisoned target batch leaves both states and
the BatchNorm buffers bit-identical), ``grad_reverse`` against ``jax.vjp``
of the JAX one, the discriminator's forward against the JAX module's, and
the non-strict pretrained load.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_segmentation_project_tpu.engine.state import TrainState as JaxTrainState
from multimodal_segmentation_project_tpu.engine.state import make_optimizer, ones_mask
from multimodal_segmentation_project_tpu.engine.steps import make_dann_step as jax_dann_step
from multimodal_segmentation_project_tpu.engine.steps import (
    make_distill_step as jax_distill_step,
)
from multimodal_segmentation_project_tpu.models import DomainDiscriminator as JaxDisc
from multimodal_segmentation_project_tpu.models import UNet3D as JaxUNet3D
from multimodal_segmentation_project_tpu.ops.grl import grad_reverse as jax_grad_reverse
from multimodal_segmentation_project_tpu.ops.losses import cross_entropy_loss as jax_ce
from multimodal_segmentation_project_tpu.ops.losses import distillation_loss as jax_kd
from multimodal_segmentation_project_tpu.ops.losses import get_loss_fn as jax_loss_fn
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.engine.checkpoint import load_pth_nonstrict, save_pth
from multimodal_segmentation_project_tpu_torch.engine.interop import (
    discriminator_params_to_state_dict,
    trees_to_state_dict,
)
from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
from multimodal_segmentation_project_tpu_torch.engine.steps import (
    make_dann_step,
    make_distill_step,
)
from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator, UNet3D
from multimodal_segmentation_project_tpu_torch.ops.grl import grad_reverse
from multimodal_segmentation_project_tpu_torch.ops.losses import distillation_loss, get_loss_fn

FEATURES = (4, 8)
LR, WD = 1e-3, 0.01
LAMBDA = 0.2
ALPHA, TEMPERATURE = 0.7, 2.0


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
    assert set(got) == set(want)
    largest = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name in want:
        if _bn_fed_bias(name):
            for side in (got[name], want[name]):
                assert float(np.abs(np.asarray(side)).max()) < 1e-5 * largest, name
        else:
            _close(got[name], want[name], tol, name)


def _batch(seed, n=2, size=16):
    rng = np.random.default_rng(seed)
    labels = np.zeros((n, size, size, size), np.int32)
    labels[:, 2:9, 3:10, 4:12] = 2
    labels[:, 10:14, 2:6, 9:14] = 1
    labels[:, 9:13, 11:15, 1:5] = 3
    images = labels[:, None] * 0.3 + rng.normal(0, 0.2, (n, 1, size, size, size))
    return images.astype(np.float32), labels


def _target_images(seed, n=2, size=16):
    """A shifted, noisier domain over the same anatomy."""
    images, _ = _batch(seed, n, size)
    rng = np.random.default_rng(seed + 500)
    return (images * 0.7 + 0.3 + rng.normal(0, 0.2, images.shape)).astype(np.float32)


@functools.cache
def _jax_unet():
    return JaxUNet3D(out_channels=4, features=FEATURES, dropout_rate=0.0, dtype=jnp.float32,
                     conv_impl="xla")


@functools.cache
def _jax_weights(seed):
    """(params, batch_stats) of the JAX UNet3D, with non-trivial statistics."""
    variables = jax.jit(_jax_unet().init)(jax.random.key(seed), jnp.zeros((1, 1, 16, 16, 16)))
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "mean":
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    perturb(stats)
    return params, stats


def _port_unet(params, stats) -> UNet3D:
    model = UNet3D(in_channels=1, out_channels=4, features=FEATURES, dropout_rate=0.0,
                   dtype=torch.float32)
    model.load_state_dict(trees_to_state_dict(params, stats), strict=True)
    return model


def _jax_state(apply_fn, params, stats):
    tx = make_optimizer(weight_decay=WD)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                         opt_state=tx.init(params), trainable_mask=ones_mask(params),
                         lr=jnp.asarray(LR, jnp.float32), apply_fn=apply_fn, tx=tx)


def _grads(model) -> dict:
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


def _params(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _check_updates(got: list, want: list, skip=_bn_fed_bias):
    """Params after two steps within 3e-3, and the second update itself
    within 1e-3 norm-relative of JAX's (``got``/``want``: params after
    each step, by name)."""
    for name, value in got[1].items():
        np.testing.assert_allclose(value.numpy(), want[1][name], rtol=0, atol=3e-3,
                                   err_msg=name)
        moved = (value - got[0][name]).numpy()
        assert np.abs(moved).max() > 0.0, f"{name}: not updated by the second step"
        if not skip(name):
            ref = want[1][name] - want[0][name]
            rel = np.linalg.norm(moved - ref) / np.linalg.norm(ref)
            assert rel <= 1e-3, f"{name}: second update off by {rel} norm-relative"


# ---- distillation ------------------------------------------------------------------


def test_two_distill_steps_match_jax():
    model = _jax_unet()
    s_params, s_stats = _jax_weights(1)
    t_params, t_stats = _jax_weights(2)
    teacher_vars = {"params": t_params, "batch_stats": t_stats}
    batches = [_batch(1), _batch(2)]

    def kd(s, t, y):
        return jax_kd(s, t, y, alpha=ALPHA, temperature=TEMPERATURE)

    @jax.jit
    def grads_of(p, bs, images, labels):
        t_logits = model.apply(teacher_vars, images, train=False)

        def loss_of(p):
            logits, _ = model.apply({"params": p, "batch_stats": bs}, images, train=True,
                                    mutable=["batch_stats"])
            return kd(logits, t_logits, labels)
        return jax.grad(loss_of)(p)

    want_grads = trees_to_state_dict(
        _np(grads_of(s_params, s_stats, *map(jnp.asarray, batches[0]))), s_stats)
    jstate = _jax_state(model.apply, s_params, s_stats)
    jstep = jax_distill_step(kd, augment=False, nan_guard=True)
    want_losses, want_sd = [], []
    for images, labels in batches:
        jstate, m = jstep(jstate, teacher_vars, jnp.asarray(images), jnp.asarray(labels),
                          jax.random.key(0))
        want_losses.append(float(m["loss"]))
        want_sd.append(trees_to_state_dict(_np(jstate.params), _np(jstate.batch_stats)))

    student = _port_unet(s_params, s_stats)
    teacher = _port_unet(t_params, t_stats).requires_grad_(False)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    state = TrainState(student, LR, weight_decay=WD)
    step = make_distill_step(
        lambda s, t, y: distillation_loss(s, t, y, alpha=ALPHA, temperature=TEMPERATURE),
        augment=False, nan_guard=True)
    got_losses, got_params = [], []
    for i, (images, labels) in enumerate(batches):
        m = step(state, teacher, torch.from_numpy(images), torch.from_numpy(labels))
        assert float(m["nonfinite"]) == 0.0
        got_losses.append(float(m["loss"]))
        got_params.append(_params(student))
        if i == 0:
            _check_grads(_grads(student), {n: v.numpy() for n, v in want_grads.items()
                                           if n in dict(student.named_parameters())}, 1e-4)
            for name, value in student.state_dict().items():
                if "running" in name:
                    _close(value, want_sd[0][name], 1e-5, name)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    _check_updates(got_params, [{n: sd[n].numpy() for n in got_params[0]} for sd in want_sd])
    for k, v in teacher.state_dict().items():  # the teacher is left as it was
        assert torch.equal(v, teacher_before[k]), k
    assert not teacher.training
    assert all(p.grad is None for p in teacher.parameters())


# ---- DANN --------------------------------------------------------------------------


@functools.cache
def _jax_disc_params():
    disc = JaxDisc(dropout_rate=0.0)
    variables = disc.init({"params": jax.random.key(7)}, jnp.zeros((1, 2 * FEATURES[-1])))
    return _np(variables["params"])


def _port_disc(dparams, dropout_rate=0.0) -> DomainDiscriminator:
    disc = DomainDiscriminator(2 * FEATURES[-1], dropout_rate=dropout_rate)
    disc.load_state_dict(discriminator_params_to_state_dict(dparams), strict=True)
    return disc


def _jax_dann_grads(params, stats, dparams, src, lbl, tgt):
    """The JAX package's DANN objective (``engine/steps.py:make_dann_step``'s
    ``loss_of``) and its gradients in both trees."""
    model, disc = _jax_unet(), JaxDisc(dropout_rate=0.0)
    loss_fn = jax_loss_fn("ce_tversky")

    def loss_of(p, dp):
        (src_logits, src_feat), mut_s = model.apply(
            {"params": p, "batch_stats": stats}, src, train=True, return_features=True,
            mutable=["batch_stats"])
        task = loss_fn(src_logits, lbl)
        (_, tgt_feat), _ = model.apply(
            {"params": p, "batch_stats": mut_s["batch_stats"]}, tgt, train=True,
            return_features=True, mutable=["batch_stats"])
        feats = jnp.concatenate([jax_grad_reverse(src_feat, LAMBDA),
                                 jax_grad_reverse(tgt_feat, LAMBDA)])
        logits = disc.apply({"params": dp}, feats, train=True)
        labels = jnp.concatenate([jnp.zeros(src.shape[0], jnp.int32),
                                  jnp.ones(tgt.shape[0], jnp.int32)])
        return task + LAMBDA * jax_ce(logits, labels)

    return jax.jit(jax.grad(loss_of, argnums=(0, 1)))(params, dparams)


def test_two_dann_steps_match_jax():
    model = _jax_unet()
    params, stats = _jax_weights(3)
    dparams = _jax_disc_params()
    batches = [(*_batch(4), _target_images(5)), (*_batch(6), _target_images(7))]

    g_seg, g_disc = _jax_dann_grads(params, stats, dparams,
                                    *map(jnp.asarray, batches[0]))
    want_grads = trees_to_state_dict(_np(g_seg), stats)
    want_dgrads = discriminator_params_to_state_dict(_np(g_disc))

    disc_module = JaxDisc(dropout_rate=0.0)
    jseg = _jax_state(model.apply, params, stats)
    jdisc = _jax_state(disc_module.apply, dparams, {})
    jstep = jax_dann_step(jax_loss_fn("ce_tversky"), LAMBDA, nan_guard=True)
    want = {k: [] for k in ("task_loss", "domain_loss", "loss")}
    want_sd, want_dsd = [], []
    for src, lbl, tgt in batches:
        jseg, jdisc, m = jstep(jseg, jdisc, jnp.asarray(src), jnp.asarray(lbl),
                               jnp.asarray(tgt), jax.random.key(0))
        assert float(m["nonfinite"]) == 0.0
        for k in want:
            want[k].append(float(m[k]))
        want_sd.append(trees_to_state_dict(_np(jseg.params), _np(jseg.batch_stats)))
        want_dsd.append(discriminator_params_to_state_dict(_np(jdisc.params)))

    seg, disc = _port_unet(params, stats), _port_disc(dparams)
    seg_state, disc_state = TrainState(seg, LR, WD), TrainState(disc, LR, WD)
    step = make_dann_step(get_loss_fn("ce_tversky"), LAMBDA, nan_guard=True)
    got = {k: [] for k in want}
    got_params, got_dparams = [], []
    for i, (src, lbl, tgt) in enumerate(batches):
        m = step(seg_state, disc_state, torch.from_numpy(src), torch.from_numpy(lbl),
                 torch.from_numpy(tgt), torch.Generator().manual_seed(i))
        assert float(m["nonfinite"]) == 0.0
        for k in got:
            got[k].append(float(m[k]))
        got_params.append(_params(seg))
        got_dparams.append(_params(disc))
        if i == 0:
            _check_grads(_grads(seg), {n: want_grads[n].numpy()
                                       for n, _ in seg.named_parameters()}, 1e-4)
            _check_grads(_grads(disc), {n: v.numpy() for n, v in want_dgrads.items()}, 1e-4)
            # the statistics after both forwards: the source's, then the target's
            for name, value in seg.state_dict().items():
                if "running" in name:
                    _close(value, want_sd[0][name], 1e-5, name)
    assert seg_state.step == disc_state.step == 2
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    _check_updates(got_params, [{n: sd[n].numpy() for n in got_params[0]} for sd in want_sd])
    _check_updates(got_dparams, [{n: v.numpy() for n, v in sd.items()} for sd in want_dsd],
                   skip=lambda name: False)


def test_dann_nan_guard_rolls_back_both_states_and_statistics():
    params, stats = _jax_weights(3)
    seg, disc = _port_unet(params, stats), _port_disc(_jax_disc_params(), dropout_rate=0.2)
    seg_state = TrainState(seg, LR, WD, grad_accum_steps=2)
    disc_state = TrainState(disc, LR, WD, grad_accum_steps=2)
    step = make_dann_step(get_loss_fn("ce_tversky"), LAMBDA, nan_guard=True)
    src, lbl = (torch.from_numpy(a) for a in _batch(8))
    tgt = torch.from_numpy(_target_images(9))
    for i in range(3):  # Adam moments, and an accumulator half full, to protect
        step(seg_state, disc_state, src, lbl, tgt, torch.Generator().manual_seed(i))

    def snapshot():
        out = []
        for st in (seg_state, disc_state):
            out += [t.clone() for t in st.model.state_dict().values()]
            out += [t.clone() for s in st.optimizer.state.values() for t in s.values()]
            out += [t.clone() for t in st.acc_grads.values()]
        return out, [(st.step, st.mini_step) for st in (seg_state, disc_state)]

    before = snapshot()
    poisoned = tgt.clone()
    poisoned[1, 0, 5, 6, 7] = float("nan")
    m = step(seg_state, disc_state, src, lbl, poisoned, torch.Generator().manual_seed(9))
    assert float(m["nonfinite"]) == 1.0
    assert float(m["task_loss"]) == float(m["domain_loss"]) == float(m["loss"]) == 0.0
    after = snapshot()
    assert len(before[0]) == len(after[0])
    for a, b in zip(before[0], after[0]):
        assert torch.equal(a, b)  # params, BN statistics, moments, steps, accumulators
    assert before[1] == after[1]
    m = step(seg_state, disc_state, src, lbl, tgt, torch.Generator().manual_seed(10))
    assert float(m["nonfinite"]) == 0.0 and seg_state.step == disc_state.step == 4


def test_dann_step_draws_dropout_from_the_generator():
    """Three streams from the step's generator: the same seed gives the same
    step, another seed another one."""
    params, stats = _jax_weights(3)
    src, lbl = (torch.from_numpy(a) for a in _batch(8))
    tgt = torch.from_numpy(_target_images(9))

    def run(seed):
        seg = UNet3D(in_channels=1, out_channels=4, features=FEATURES, dropout_rate=0.1,
                     dtype=torch.float32)
        seg.load_state_dict(trees_to_state_dict(params, stats))
        disc = _port_disc(_jax_disc_params(), dropout_rate=0.2)
        step = make_dann_step(get_loss_fn("ce_tversky"), LAMBDA)
        m = step(TrainState(seg, LR, WD), TrainState(disc, LR, WD), src, lbl, tgt,
                 torch.Generator().manual_seed(seed))
        return float(m["loss"])

    assert run(0) == run(0)
    assert run(0) != run(1)


# ---- the pieces: the GRL, the discriminator, the non-strict load ------------------


def test_grad_reverse_matches_jax_vjp():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    g = rng.normal(size=(4, 16)).astype(np.float32)
    y, pullback = jax.vjp(lambda a: jax_grad_reverse(a, LAMBDA), jnp.asarray(x))
    (want_dx,) = pullback(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = grad_reverse(xt, LAMBDA)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(y))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx), rtol=0, atol=0)


def test_discriminator_forward_matches_jax():
    dparams = _jax_disc_params()
    feats = np.random.default_rng(12).normal(size=(4, 2 * FEATURES[-1])).astype(np.float32)
    want = JaxDisc().apply({"params": dparams}, jnp.asarray(feats), train=False)
    disc = _port_disc(dparams, dropout_rate=0.2).eval()
    got = disc(torch.from_numpy(feats))
    assert got.dtype == torch.float32 and got.shape == (4, 2)
    _close(got.detach(), want, 1e-6, "logits")
    # train mode: dropout after fc0 and fc1, drawn from the generator passed in
    disc.train()
    a = disc(torch.from_numpy(feats), generator=torch.Generator().manual_seed(0))
    b = disc(torch.from_numpy(feats), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.allclose(a, got)


def test_discriminator_initialises_as_flax_dense():
    """LeCun-normal truncated at 2 sigma (the weights' spread, fan-in scaled,
    and their bound) and zero biases, at the default widths."""
    disc = DomainDiscriminator(256, generator=torch.Generator().manual_seed(0))
    jparams = _np(JaxDisc().init({"params": jax.random.key(0)}, jnp.zeros((1, 256)))["params"])
    assert set(disc.state_dict()) == set(discriminator_params_to_state_dict(jparams))
    for name in ("fc0", "fc1", "fc2", "out"):
        w = getattr(disc, name).weight.detach().numpy()
        jw = jparams[name]["kernel"].T
        assert w.shape == jw.shape
        fan_in = w.shape[1]
        assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.15, name
        assert abs(w).max() <= 2.0 / 0.8796256610342398 / np.sqrt(fan_in) + 1e-6, name
        assert not getattr(disc, name).bias.detach().any()


def test_nonstrict_load_keeps_missing_and_mismatched_keys(tmp_path):
    params, stats = _jax_weights(3)
    source = _port_unet(params, stats)
    sd = source.state_dict()
    del sd["decoder.1.double_conv.4.weight"]  # missing from the checkpoint
    sd["final_conv.weight"] = torch.zeros(3, FEATURES[0], 1, 1, 1)  # another shape
    sd["not_a_model_key"] = torch.zeros(2)  # only the checkpoint has it
    path = tmp_path / "partial.pth"
    torch.save({"model_state_dict": sd}, path)

    target = UNet3D(in_channels=1, out_channels=4, features=FEATURES, dropout_rate=0.0,
                    dtype=torch.float32, generator=torch.Generator().manual_seed(5))
    initial = {k: v.clone() for k, v in target.state_dict().items()}
    kept = load_pth_nonstrict(target, str(path))
    assert sorted(kept) == ["decoder.1.double_conv.4.weight", "final_conv.weight"]
    for k, v in target.state_dict().items():
        want = initial[k] if k in kept else source.state_dict()[k]
        assert torch.equal(v, want), k
    with pytest.raises(RuntimeError):  # the strict load refuses the same file
        target.load_state_dict(torch.load(path, weights_only=True)["model_state_dict"])
    save_pth(str(tmp_path / "full.pth"), source)
    assert load_pth_nonstrict(target, str(tmp_path / "full.pth")) == []
