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

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodal_segmentation_project_tpu.ops import head as jhead
from multimodal_segmentation_project_tpu.ops import pallas_conv as jconv
from multimodal_segmentation_project_tpu.ops import pool as jpool
from multimodal_segmentation_project_tpu.ops import upconv as jupconv
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.ops import conv3, conv3_fused, head, pool, upconv

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
    [tap][cout][cin] bf16 slab per chunk of 16 input channels: the conv
    body's 32-byte (tap, cout) rows before their swizzle."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 20, 24)).astype(np.float32))
    packed = conv3.pack_weights(w)
    assert packed.shape == (2, 27, 32, 16) and packed.dtype == torch.bfloat16
    assert packed.is_contiguous()
    want = torch.zeros(32, 27, 32, dtype=torch.bfloat16)  # (cin16, tap, cout16)
    want[:20, :, :24] = w.reshape(27, 20, 24).permute(1, 0, 2).to(torch.bfloat16)
    torch.testing.assert_close(packed.permute(0, 3, 1, 2).reshape(32, 27, 32), want,
                               rtol=0, atol=0)


def _tile_header_constants() -> dict:
    text = (Path(conv3.__file__).resolve().parent.parent / "csrc" / "conv3_fwd_tile.cuh").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (T[DHW]) = (\d+);", text)}


@pytest.mark.parametrize("shape", [
    (1, 1, 192, 192, 192), (1, 16, 96, 96, 96), (1, 64, 48, 48, 48),  # the slice's levels
    (2, 3, 5, 7, 37), (2, 40, 3, 9, 37), (1, 40, 3, 9, 20), (2, 40, 3, 9, 9),  # ragged
])
def test_conv_tile_and_partial_scratch_match_the_kernel(shape, monkeypatch):
    """Python's tile is the conv body's (csrc/conv3_fwd_tile.cuh), its TW
    divides the 192/96/48 levels, and the partial-sum scratch the wrappers
    allocate holds one value per (run, block) of the kernel's grid:
    ceil(D/TD) ceil(H/TH) ceil(W/TW) blocks per batch element, 2 Cout runs
    per batch element for the stats, 2 B Cx runs for the dx epilogue."""
    td, th, tw = conv3_fused.TD, conv3_fused.TH, conv3_fused.TW
    assert _tile_header_constants() == {"TD": td, "TH": th, "TW": tw}
    assert all(s % tw == 0 for s in (48, 96, 192))
    bsz, c, d, h, w = shape
    blocks = -(-d // td) * -(-h // th) * -(-w // tw)
    assert conv3_fused.conv_blocks(d, h, w) == blocks
    # the calls as on the card, on meta tensors (no data, no launch)
    monkeypatch.setattr(conv3_fused._build, "require", lambda *a: None)
    meta = {"dtype": torch.bfloat16, "device": "meta"}
    x, a = torch.empty(shape, **meta), torch.empty(bsz, c, device="meta")
    wts, b = torch.empty(3, 3, 3, c, 20, device="meta"), torch.empty(20, device="meta")
    for call in (conv3_fused.stats_call(x, wts, b),
                 conv3_fused.boundary_stats_call(x, wts, b, a, a)):
        assert call.tensors[4].numel() == 2 * 20 * bsz * blocks  # partial
    g = torch.empty(bsz, 20, d, h, w, **meta)
    call = conv3_fused.dx_epilogue_call(g, wts, x, a, a)
    assert call.tensors[6].numel() == 2 * bsz * c * blocks


SMS = 132  # an H100 SXM's SM count


@pytest.mark.parametrize("shape", [
    (1, 1, 192, 192, 192), (1, 16, 96, 96, 96), (1, 64, 48, 48, 48),  # the slice's levels
    (2, 3, 5, 7, 37), (2, 40, 3, 9, 37), (1, 40, 3, 9, 20), (2, 40, 3, 9, 9),  # ragged
])
def test_dw_grid_and_partial_scratch_match_the_kernel(shape, monkeypatch):
    """The dW body (csrc/conv3_dw.cu) runs on the conv body's tile and
    staging, and writes one (27, 16, Cout16) partial per block and chunk:
    the scratch the dW wrappers allocate holds exactly nblk * ceil(Cin/16)
    of them, nblk depends on the SM count and the chunk count only, and the
    grid is at most DW_WAVES waves of the kernel's one block per SM. The
    calls are built on meta tensors (no data, no launch)."""
    src = (Path(conv3.__file__).resolve().parent.parent / "csrc" / "conv3_dw.cu").read_text()
    assert '#include "conv3_fwd_tile.cuh"' in src and "conv3_tile.cuh" not in src
    assert "__launch_bounds__(DW_THREADS, 1)" in src
    monkeypatch.setattr(conv3._build, "require", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=SMS))
    bsz, cin, d, h, w = shape
    nchunk = -(-cin // 16)
    nblk = max(1, conv3.DW_WAVES * SMS // nchunk)  # DW_WAVES waves over all chunks
    meta = {"dtype": torch.bfloat16, "device": "meta"}
    x, a = torch.empty(shape, **meta), torch.empty(bsz, cin, device="meta")
    for cout in (16, 20, 48, 64):
        g = torch.empty(bsz, cout, d, h, w, **meta)
        for call in (conv3.dw_call(x, g), conv3_fused.dw_prologue_call(x, g, a, a)):
            assert call.args[-7:] == (bsz, cin, cout, d, h, w, nblk)
            partial, dw = call.tensors[-2:]
            assert partial.numel() == nblk * nchunk * 27 * 16 * (-(-cout // 16) * 16)
            assert call.result is dw
            assert dw.shape == (3, 3, 3, cin, cout) and dw.dtype == torch.float32


@pytest.mark.parametrize("w", [9, 37])
@pytest.mark.parametrize("cout", [20, 48])
@pytest.mark.parametrize("cin", [1, 40])
@pytest.mark.parametrize("prologue", [False, True], ids=["dw", "dw_prologue"])
def test_dw_reference_matches_jax(prologue, cin, cout, w):
    """The plain dW versions of kernels 2 and 6 against the JAX backward's
    dW kernels (_conv_dw_shared, _conv_dw_prologue, in interpret mode) in
    fp32: Cin = 1 and three chunks with a partial last, Cout16 = 32 and 48,
    ragged W, batch 2, t of both signs (the prologue's halo stays 0). H = 8:
    the Pallas kernels take H % 8 == 0."""
    rng = np.random.default_rng(100 + cin + cout + w)
    shape = (2, cin, 3, 8, w)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=(2, cout) + shape[2:]).astype(np.float32)
    xp, pg = jconv._pad_for_kernel(jnp.asarray(x)), jconv._pad_for_kernel(jnp.asarray(g))
    if prologue:
        a = (rng.normal(size=(2, cin)) + 1.0).astype(np.float32)
        t = rng.normal(size=(2, cin)).astype(np.float32)
        packed = jconv._conv_dw_prologue(xp, pg, jnp.asarray(a), jnp.asarray(t), cout, w)
        got = conv3_fused.conv3x3x3_cf_dw_prologue_reference(*map(torch.from_numpy, (x, g, a, t)))
    else:
        packed = jconv._conv_dw_shared(xp, pg, cout)
        got = conv3.conv3x3x3_cf_dw_reference(torch.from_numpy(x), torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, cin, cout)
    _close(got, jconv.unpack_weight_grads(packed, cin, cout), FP32_TOL)
