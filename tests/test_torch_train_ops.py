"""The port's training ops (plain versions, on the CPU) against the JAX
package's functions and their VJPs, on the same numpy inputs; the Pallas
functions run in interpret mode, as the JAX package's own tests run them.

Tolerances, relative to max |jax| of each compared array:
* fp32 conv, head and upconv forward and gradients: 2e-5 (the two sides
  sum the same fp32 products in other orders);
* bf16 outputs rounded once: each element within one bf16 ulp of its value
  (both sides round at the same point from fp32 sums taken in other
  orders); the training conv's output, rounded twice (the conv's cast, then
  the bias added in bf16): 2**-6, one ulp per rounding at the largest
  output;
* pool backward: exact, ties included (equal shares computed in fp32 by
  the same formula);
* losses and their logits-gradients: 2e-5; metrics: 1e-6 (integer counts);
* augment transforms, given the same drawn parameters: 2e-5 (fp32
  elementwise, exp/pow/where in other libraries);
* the plateau scheduler: the same LR sequence exactly.
On the CPU no kernel launches: every launch counter stays 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_segmentation_project_tpu.engine.schedule import ReduceLROnPlateau as JaxPlateau
from multimodal_segmentation_project_tpu.ops import augment as jaug
from multimodal_segmentation_project_tpu.ops import head as jhead
from multimodal_segmentation_project_tpu.ops import losses as jlosses
from multimodal_segmentation_project_tpu.ops import metrics as jmetrics
from multimodal_segmentation_project_tpu.ops import pallas_conv as jconv
from multimodal_segmentation_project_tpu.ops import pool as jpool
from multimodal_segmentation_project_tpu.ops import upconv as jupconv
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.engine.schedule import ReduceLROnPlateau
from multimodal_segmentation_project_tpu_torch.ops import augment, conv3, head, losses, metrics
from multimodal_segmentation_project_tpu_torch.ops import pool, upconv
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

TOL = 2e-5


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_OPS, 0)


def _close(got, want, tol=TOL, name=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: max err {err} > {tol} * {scale}"


def _one_bf16_ulp(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    m = np.maximum(np.abs(got), np.abs(want))
    ulp = np.ldexp(np.ones_like(m), np.frexp(m)[1] - 8)
    assert np.all(np.abs(got - want) <= ulp), name


def _bf16(a):
    """numpy fp32 -> bf16-valued fp32, so both frameworks start from the same values."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---- conv3x3x3_cf: forward, dx, dW, db --------------------------------


@pytest.mark.parametrize(
    "shape,cout",
    [
        ((2, 4, 6, 8, 16), 8),
        ((2, 4, 5, 8, 16), 8),   # ragged: odd D, batch 2
        ((1, 1, 4, 8, 8), 4),    # Cin = 1, the first encoder conv
    ],
)
def test_conv3x3x3_cf_vjp_matches_jax_fp32(shape, cout):
    rng = np.random.default_rng(0)
    cin = shape[1]
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(shape[0], cout) + shape[2:]).astype(np.float32)
    want, vjp = jax.vjp(jconv.conv3x3x3_cf, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    wdx, wdw, wdb = vjp(jnp.asarray(g))
    xt, wt, bt = _t(x, True), _t(w, True), _t(b, True)
    got = conv3.conv3x3x3_cf(xt, wt, bt)
    got.backward(_t(g))
    for name, a, r in (("y", got.detach(), want), ("dx", xt.grad, wdx), ("dw", wt.grad, wdw),
                       ("db", bt.grad, wdb)):
        _close(a, r, name=name)


def test_conv3x3x3_cf_bf16_rounds_once_then_adds_the_bias_in_bf16():
    rng = np.random.default_rng(1)
    x = _bf16(rng.normal(size=(1, 4, 6, 8, 16)).astype(np.float32))
    w = (rng.normal(size=(3, 3, 3, 4, 8)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(8,)) * 0.5).astype(np.float32)
    g = _bf16(rng.normal(size=(1, 8, 6, 8, 16)).astype(np.float32))
    want, vjp = jax.vjp(jconv.conv3x3x3_cf, jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                        jnp.asarray(b))
    wdx, wdw, _ = vjp(jnp.asarray(g, jnp.bfloat16))
    xt = _t(x).bfloat16().requires_grad_(True)
    wt = _t(w, True)
    got = conv3.conv3x3x3_cf(xt, wt, _t(b))
    got.backward(_t(g).bfloat16())
    assert got.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16
    _close(got.detach().float(), want.astype(jnp.float32), 2.0**-6, "y")
    _one_bf16_ulp(xt.grad.float(), wdx.astype(jnp.float32), "dx")
    _close(wt.grad, wdw, name="dw")  # fp32 sums of the same bf16 products


def test_conv_dx_is_skipped_for_an_input_without_grad():
    x = torch.randn(1, 1, 4, 8, 8)
    w = torch.randn(3, 3, 3, 1, 4, requires_grad=True)
    out = conv3.conv3x3x3_cf(x, w, torch.zeros(4))
    out.sum().backward()
    assert x.grad is None and w.grad is not None


# ---- pool backward ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pool_backward_with_ties_matches_jax_kernel_exactly(dtype):
    """Inside the Pallas gate (W = 48), inputs rounded to a few integers:
    most windows hold several tied maxima, which share g equally."""
    rng = np.random.default_rng(2)
    x = np.clip(np.round(rng.normal(size=(1, 4, 4, 16, 48)) * 1.5), -2, 2).astype(np.float32)
    g = rng.normal(size=(1, 4, 2, 8, 24)).astype(np.float32)
    assert jpool._bwd_tiles(*x.shape[1:]) is not None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    if dtype == "bf16":
        g = _bf16(g)
    y, vjp = jax.vjp(jpool.max_pool2x_cf, jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    xt = _t(x).to(tdt).requires_grad_(True)
    got = pool.max_pool2x_cf(xt)
    got.backward(_t(g).to(tdt))
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(y.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(want.astype(jnp.float32)))
    shares = xt.grad.float().numpy()
    assert np.sum((shares != 0) & (np.abs(shares) < np.abs(g).max() / 1.5)) > 0  # split shares


def test_pool_backward_outside_the_gate_untied_matches_jax():
    """Outside the Pallas gate JAX differentiates its XLA chain (another tie
    rule), so untied inputs only; odd extents drop the tail."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 5, 7, 9)).astype(np.float32)
    g = rng.normal(size=(2, 3, 2, 3, 4)).astype(np.float32)
    assert jpool._bwd_tiles(*x.shape[1:]) is None
    _, vjp = jax.vjp(jpool.max_pool2x_cf, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = _t(x, True)
    pool.max_pool2x_cf(xt).backward(_t(g))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))


# ---- head and upconv VJPs -------------------------------------------------


def test_head1x1_cf_vjp_matches_jax_fp32():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 4, 8, 16)).astype(np.float32)
    k = (rng.normal(size=(8, 4)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(4,)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(2, 4, 4, 8, 16)).astype(np.float32)
    want, vjp = jax.vjp(jhead.head1x1_cf, jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    wdx, wdk, wdb = vjp(jnp.asarray(ct))
    xt, kt, bt = _t(x, True), _t(k, True), _t(b, True)
    got = head.head1x1_cf(xt, kt, bt)
    got.backward(_t(ct))
    for name, a, r in (("y", got.detach(), want), ("dx", xt.grad, wdx), ("dk", kt.grad, wdk),
                       ("db", bt.grad, wdb)):
        _close(a, r, name=name)


def test_head1x1_cf_dx_of_bf16_features_is_bf16():
    rng = np.random.default_rng(5)
    x = _bf16(rng.normal(size=(1, 16, 4, 8, 16)).astype(np.float32))
    k = (rng.normal(size=(16, 4)) * 0.3).astype(np.float32)
    ct = rng.normal(size=(1, 4, 4, 8, 16)).astype(np.float32)
    _, vjp = jax.vjp(jhead.head1x1_cf, jnp.asarray(x, jnp.bfloat16), jnp.asarray(k),
                     jnp.zeros(4))
    wdx = vjp(jnp.asarray(ct))[0]
    xt = _t(x).bfloat16().requires_grad_(True)
    head.head1x1_cf(xt, _t(k), torch.zeros(4)).backward(_t(ct))
    assert xt.grad.dtype == torch.bfloat16 and wdx.dtype == jnp.bfloat16
    _one_bf16_ulp(xt.grad.float(), wdx.astype(jnp.float32), "dx")


def test_upconv2x_cf_vjp_matches_jax_fp32():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 8, 3, 4, 5)).astype(np.float32)
    k = (rng.normal(size=(2, 2, 2, 8, 4)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(4,)) * 0.1).astype(np.float32)
    ct = rng.normal(size=(2, 4, 6, 8, 10)).astype(np.float32)
    want, vjp = jax.vjp(jupconv.upconv2x_cf, jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    wdx, wdk, wdb = vjp(jnp.asarray(ct))
    xt, kt, bt = _t(x, True), _t(k, True), _t(b, True)
    got = upconv.upconv2x_cf(xt, kt, bt)
    got.backward(_t(ct))
    for name, a, r in (("y", got.detach(), want), ("dx", xt.grad, wdx), ("dk", kt.grad, wdk),
                       ("db", bt.grad, wdb)):
        _close(a, r, name=name)


# ---- losses, metrics --------------------------------------------------------


@pytest.fixture
def logits_labels():
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(2, 4, 6, 6, 6)) * 2).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 6, 6, 6)).astype(np.int32)
    return logits, labels


@pytest.mark.parametrize("loss_type", ["combined", "ce", "dice", "tversky", "ce_tversky"])
def test_losses_and_their_gradients_match_jax(logits_labels, loss_type):
    logits, labels = logits_labels
    jfn = jlosses.get_loss_fn(loss_type)
    want, wgrad = jax.value_and_grad(jfn)(jnp.asarray(logits), jnp.asarray(labels))
    lt = _t(logits, True)
    got = losses.get_loss_fn(loss_type)(lt, _t(labels))
    got.backward()
    _close(got.detach(), want, name="loss")
    _close(lt.grad, wgrad, name="dlogits")


def test_distillation_loss_matches_jax(logits_labels):
    logits, labels = logits_labels
    teacher = np.random.default_rng(8).normal(size=logits.shape).astype(np.float32)
    want = jlosses.distillation_loss(jnp.asarray(logits), jnp.asarray(teacher),
                                     jnp.asarray(labels))
    got = losses.distillation_loss(_t(logits), _t(teacher), _t(labels))
    _close(got, want)


def test_segmentation_metrics_match_jax(logits_labels):
    logits, labels = logits_labels
    labels = np.where(labels == 3, 0, labels)  # an absent class is skipped, not scored 0
    want = jmetrics.segmentation_metrics(jnp.asarray(logits), jnp.asarray(labels))
    got = metrics.segmentation_metrics(_t(logits), _t(labels))
    for key in ("dice", "iou", "acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=key)


# ---- augmentation, given the same drawn parameters ----------------------------


@pytest.fixture
def sample():
    rng = np.random.default_rng(9)
    image = rng.uniform(0, 1, size=(1, 10, 12, 14)).astype(np.float32)
    label = rng.integers(0, 4, size=(10, 12, 14)).astype(np.int32)
    return image, label


def test_bias_field_matches_jax(sample):
    image, _ = sample
    key = jax.random.key(0)
    want = jaug.random_bias_field(key, jnp.asarray(image))
    coeffs = np.asarray(jax.random.uniform(key, (20,), minval=0.0, maxval=0.1)).tolist()
    _close(augment.bias_field(_t(image), coeffs), want)


def test_gaussian_noise_matches_jax(sample):
    image, _ = sample
    key = jax.random.key(1)
    want = jaug.random_gaussian_noise(key, jnp.asarray(image))
    noise = np.asarray(jax.random.normal(key, image.shape))
    _close(augment.gaussian_noise(_t(image), _t(noise)), want)


@pytest.mark.parametrize("gamma", [0.7, 1.13, 1.5])
def test_adjust_contrast_matches_jax(sample, gamma):
    image, _ = sample
    _close(augment.adjust_contrast(_t(image), gamma),
           jaug.adjust_contrast(jnp.asarray(image), gamma))


def test_histogram_shift_matches_jax(sample):
    image, _ = sample
    dst = [0.0, 0.1, 0.55, 0.6, 1.0]
    _close(augment.apply_histogram_shift(_t(image), dst),
           jaug.apply_histogram_shift(jnp.asarray(image), jnp.asarray(dst)))


def test_coarse_dropout_matches_jax(sample):
    image, label = sample
    key = jax.random.key(2)
    hole = (4, 5, 6)
    want_img, want_lbl = jaug.random_coarse_dropout(key, jnp.asarray(image), jnp.asarray(label),
                                                    holes=2, hole_size=hole)
    starts = []
    for k in jax.random.split(key, 2):
        ks = jax.random.split(k, 3)
        starts.append([int(jax.random.randint(ks[ax], (), 0, image.shape[1 + ax] - hole[ax] + 1))
                       for ax in range(3)])
    got_img, got_lbl = augment.coarse_dropout(_t(image), _t(label), starts, hole)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))


def test_augment_pipeline_probabilities(sample):
    image, label = sample
    images, labels = _t(image)[None], _t(label)[None]
    same_i, same_l = augment.augment_batch(torch.Generator().manual_seed(0), images, labels, 0.0)
    assert torch.equal(same_i, images) and torch.equal(same_l, labels)
    gen = torch.Generator().manual_seed(0)
    out_i, out_l = augment.augment_batch(gen, images, labels, prob=1.0)
    assert out_i.shape == images.shape and out_l.shape == labels.shape
    assert not torch.equal(out_i, images) and (out_l == 0).sum() > (labels == 0).sum()
    again = augment.augment_batch(torch.Generator().manual_seed(0), images, labels, prob=1.0)
    assert torch.equal(again[0], out_i)  # deterministic given the generator


# ---- scheduler ------------------------------------------------------------------


def test_plateau_scheduler_gives_the_jax_lr_sequence():
    dice = [0.1, 0.2, 0.2, 0.19, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.2, 0.21, 0.2]
    dice += [0.2] * 30
    mine, ref = ReduceLROnPlateau(1e-3, patience=3), JaxPlateau(1e-3, patience=3)
    got = [mine.step(d) for d in dice]
    assert got == [ref.step(d) for d in dice]
    assert got[-1] == 1e-6 and len(set(got)) > 2  # reduced down to min_lr
    restored = ReduceLROnPlateau(1.0)
    restored.load_state_dict(mine.state_dict())
    assert restored.step(0.0) == mine.step(0.0)
