"""The port's four kernel ops (plain versions, on the CPU) against the JAX
package's Pallas functions (interpret mode) on the same numpy inputs.

Tolerances:
* fp32: max |port - jax| <= 2e-5 * max |jax| (sum order only);
* bf16: both sides round once to bf16 from fp32 sums taken in different
  orders, so an output may differ by one bf16 ulp; 2**-7 * max |jax|
  bounds one ulp at the largest output (an ulp is at most 2**-7 of the
  value it sits at);
* max pool: exact (a max selects one of its inputs).
On the CPU no kernel launches: every launch counter stays 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_segmentation_project_tpu.ops import head as jhead
from multimodal_segmentation_project_tpu.ops import pallas_conv as jconv
from multimodal_segmentation_project_tpu.ops import pool as jpool
from multimodal_segmentation_project_tpu.ops import upconv as jupconv
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.ops import conv3, head, pool, upconv

FP32_TOL = 2e-5
BF16_TOL = 2.0**-7


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_OPS, 0)


def _close(got, want, tol):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} > {tol} * {scale}"


def _bf16(a):
    """numpy fp32 -> bf16-valued fp32, so both frameworks start from the same values."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize(
    "shape,cout,dtype",
    [
        ((2, 4, 6, 8, 16), 8, "fp32"),
        ((1, 1, 4, 8, 8), 4, "fp32"),  # Cin = 1, the first encoder conv
        ((2, 4, 6, 8, 16), 8, "bf16"),
    ],
)
def test_conv3x3x3_cf_relu_matches_jax(shape, cout, dtype):
    rng = np.random.default_rng(0)
    cin = shape[1]
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    if dtype == "bf16":
        x = _bf16(x)
        want = jconv.conv3x3x3_cf_relu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
        got = conv3.conv3x3x3_cf_relu(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                                      torch.from_numpy(b))
        assert got.dtype == torch.bfloat16
        _close(got.float(), np.asarray(want.astype(jnp.float32)), BF16_TOL)
    else:
        want = jconv.conv3x3x3_cf_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        got = conv3.conv3x3x3_cf_relu(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
        _close(got, want, FP32_TOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_max_pool2x_cf_matches_jax_exactly(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 4, 4, 16, 48)).astype(np.float32)  # W >= 48: the Pallas gate
    assert jpool._fwd_tiles(*x.shape[2:]) is not None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jpool.max_pool2x_cf(jnp.asarray(x, jdt)).astype(jnp.float32))
    got = pool.max_pool2x_cf(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_max_pool2x_cf_floor_semantics():
    x = torch.arange(2 * 5 * 7 * 9, dtype=torch.float32).reshape(1, 2, 5, 7, 9)
    got = pool.max_pool2x_cf(x)
    want = torch.nn.functional.max_pool3d(x, 2, 2)
    assert got.shape == (1, 2, 2, 3, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_upconv2x_cf_matches_jax_d2s_bf16():
    rng = np.random.default_rng(3)
    x = _bf16(rng.normal(size=(1, 8, 4, 8, 16)).astype(np.float32))
    k = (rng.normal(size=(2, 2, 2, 8, 4)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(4,)) * 0.1).astype(np.float32)
    tiles = jupconv._d2s_tiles(8, 4, 4, 8, 16)
    assert tiles is not None  # the Pallas depth-to-space path, as in bf16 on a TPU
    want = jupconv._upconv_forward_d2s(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k),
                                       jnp.asarray(b), *tiles)
    got = upconv.upconv2x_cf(torch.from_numpy(x).bfloat16(), torch.from_numpy(k),
                             torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == (1, 4, 8, 16, 32)
    _close(got.float(), np.asarray(want.astype(jnp.float32)), BF16_TOL)


def test_upconv2x_cf_matches_jax_fp32():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 8, 4, 8, 16)).astype(np.float32)
    k = (rng.normal(size=(2, 2, 2, 8, 4)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(4,)) * 0.1).astype(np.float32)
    want = jupconv.upconv2x_cf(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    got = upconv.upconv2x_cf(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    _close(got, want, FP32_TOL)


def test_head1x1_cf_matches_jax_fp32():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 8, 4, 8, 16)).astype(np.float32)
    k = (rng.normal(size=(8, 4)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(4,)) * 0.1).astype(np.float32)
    want = jhead.head1x1_cf(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    got = head.head1x1_cf(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    assert got.dtype == torch.float32
    _close(got, want, FP32_TOL)


def test_head1x1_cf_bf16_features_give_fp32_logits():
    rng = np.random.default_rng(6)
    x = _bf16(rng.normal(size=(1, 8, 4, 8, 16)).astype(np.float32))
    k = (rng.normal(size=(8, 4)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(4,)) * 0.1).astype(np.float32)
    want = jhead.head1x1_cf(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(b))
    got = head.head1x1_cf(torch.from_numpy(x).bfloat16(), torch.from_numpy(k),
                          torch.from_numpy(b))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, FP32_TOL)


def test_per_class_metrics_match_jax():
    from multimodal_segmentation_project_tpu.ops import metrics as jmetrics
    from multimodal_segmentation_project_tpu_torch.ops import metrics

    rng = np.random.default_rng(7)
    pred = rng.integers(0, 4, size=(3, 6, 6, 6)).astype(np.int32)
    labels = rng.integers(0, 3, size=(3, 6, 6, 6)).astype(np.int32)  # class 3 absent
    for name in ("per_class_dice_iou_per_sample", "per_class_dice_iou"):
        want = getattr(jmetrics, name)(jnp.asarray(pred), jnp.asarray(labels), num_classes=4)
        got = getattr(metrics, name)(torch.from_numpy(pred), torch.from_numpy(labels), 4)
        for key in ("dice", "iou", "present"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                       err_msg=f"{name}[{key}]")
    assert float(got["dice"][2]) == 0.0  # an absent organ scores 0.0


def test_conv_weight_packing_is_the_kernels_shared_memory_image():
    """pack_weights lays (3,3,3,Cin,Cout) out as one zero-padded
    [tap][cin][cout] bf16 slab per chunk of 16 input channels."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 20, 24)).astype(np.float32))
    packed = conv3.pack_weights(w)
    assert packed.shape == (2, 27, 16, 32) and packed.dtype == torch.bfloat16
    assert packed.is_contiguous()
    want = torch.zeros(32, 27, 32, dtype=torch.bfloat16)  # (cin16, tap, cout16)
    want[:20, :, :24] = w.reshape(27, 20, 24).permute(1, 0, 2).to(torch.bfloat16)
    torch.testing.assert_close(packed.permute(0, 2, 1, 3).reshape(32, 27, 32), want,
                               rtol=0, atol=0)
