"""The upconv (kernel 10) and the head's dx (kernel 11-dx) of the port: the
operands their wrappers build, the tiles and blocks the upconv kernel
walks, and their plain versions against the JAX package, on the CPU.

The CUDA kernels themselves run only on the card (chip_smoke.py holds
them against these plain versions there). Here the upconv's packed
weights are multiplied out tile by tile as the kernel does (a GEMM of the
(8 phases x 16 channels, Cin16) B rows with the [Cin16][TM voxels] A
tile, then the depth-to-space scatter), which checks the packing, the
tile and block split and the scatter's index arithmetic.

Tolerances:
* fp32: max |port - jax| <= 2e-5 * max |jax| (sum order only);
* bf16 (one rounding on both sides, fp32 sums in another order): each
  element within one bf16 ulp of the larger of the two values, plus
  2**-16 * max |jax| for a sum that cancels near zero.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_segmentation_project_tpu.ops import upconv as jupconv
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.ops import head, upconv
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

FP32_TOL = 2e-5
SMS = 132  # an H100 SXM's SM count
CSRC = Path(upconv.__file__).resolve().parent.parent / "csrc"

# (x shape, Cout): ragged W (7, 9, 37), W = 8 with a partial last tile, Cin
# = 70 (five K steps, the last partial) and 16, Cout = 20 (a partial channel
# group) and 64, batch 2
UPCONV_EDGES = [((2, 70, 3, 5, 7), 20), ((2, 16, 3, 4, 9), 64), ((1, 16, 2, 3, 37), 20),
                ((1, 70, 3, 5, 8), 20), ((2, 16, 2, 4, 8), 64)]
# (cotangent shape, Cf): V % 8 != 0, Cf = 16, 40 and 64, batch 2
HEAD_DX_EDGES = [((2, 3, 3, 5, 7), 40), ((2, 4, 2, 4, 8), 64), ((1, 4, 3, 3, 3), 16),
                 ((2, 4, 3, 5, 7), 64)]


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


def _within_one_bf16_ulp(got: torch.Tensor, want: torch.Tensor) -> None:
    g, w = got.float(), want.float()
    m = torch.maximum(g.abs(), w.abs())
    _, exp = torch.frexp(m)
    ulp = torch.where(m > 0, torch.ldexp(torch.ones_like(m), exp - 8), 0.0)
    floor = 2.0**-16 * w.abs().max()
    assert bool(((g - w).abs() <= ulp + floor).all()), float((g - w).abs().max())


def _bf16_valued(rng, shape, scale=1.0):
    """fp32 numpy values that bf16 holds exactly, so every side starts equal."""
    a = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    return a.bfloat16().float().numpy()


def _source_constants(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


def _emulate_upconv(x: torch.Tensor, kp: torch.Tensor, bias: torch.Tensor, cout: int,
                    nblk: int) -> torch.Tensor:
    """The kernel's arithmetic on the CPU in fp32: for each channel group
    (grid y) and block k, the tiles k, k + nblk, ...; per tile the GEMM
    of the group's (8, 16, Cin16) B rows with the zero-padded [Cin16][TM]
    A tile, the bias, and the scatter of (phase (a, p, q), o, voxel m) to
    out[o, 2d + a, 2h + p, 2w + q]. Every output element must be written
    exactly once."""
    b, cin, d, h, w = x.shape
    v = d * h * w
    cin16 = kp.shape[2]
    ntiles = upconv.tiles(b, d, h, w)
    per_b = ntiles // b
    out = torch.zeros((b, cout, 2 * d, 2 * h, 2 * w))
    hits = torch.zeros(out.shape, dtype=torch.int32)
    xf = x.float().reshape(b, cin, v)
    for og0 in range(0, cout, upconv.OG):
        nch = min(upconv.OG, cout - og0)
        bmat = kp[:, og0:og0 + upconv.OG, :].float()  # (8, 16, Cin16)
        for k in range(nblk):
            for tile in range(k, ntiles, nblk):
                bi, t = divmod(tile, per_b)
                v0 = t * upconv.TM
                valid = min(upconv.TM, v - v0)
                a = torch.zeros(cin16, upconv.TM)
                a[:cin, :valid] = xf[bi, :, v0:v0 + valid]
                y = torch.einsum("pok,km->pom", bmat, a)[:, :nch, :valid]
                y = y + bias[og0:og0 + nch].float().reshape(1, -1, 1)
                vox = torch.arange(v0, v0 + valid)
                dd, hh, ww = vox // (h * w), vox // w % h, vox % w
                for ph in range(8):
                    ai, pi, qi = ph >> 2, (ph >> 1) & 1, ph & 1
                    for o in range(nch):
                        idx = (bi, og0 + o, 2 * dd + ai, 2 * hh + pi, 2 * ww + qi)
                        out[idx] = y[ph, o]
                        hits[idx] += 1
    assert bool((hits == 1).all()), "an output element written other than once"
    return out


@pytest.mark.parametrize("shape,cout", UPCONV_EDGES, ids=[f"{s}-{c}" for s, c in UPCONV_EDGES])
def test_upconv_packed_weights_multiplied_out_reproduce_the_op(shape, cout, monkeypatch):
    """pack_kernel lays (2, 2, 2, Cin, Cout) out as the kernel's B rows,
    (8, Cout16, Cin16) bf16, zero-padded; the kernel's tile walk over the
    packed weights reproduces upconv2x_cf_reference and the JAX upconv2x_cf
    (fp32, from the same bf16-valued inputs), and in bf16 the plain
    version within one ulp."""
    rng = np.random.default_rng(sum(shape) + cout)
    x = _bf16_valued(rng, shape)
    k = _bf16_valued(rng, (2, 2, 2, shape[1], cout), (1.0 / shape[1]) ** 0.5)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    xt, kt, bt = map(torch.from_numpy, (x, k, bias))

    kp = upconv.pack_kernel(kt)
    cin16, cout16 = -(-shape[1] // 16) * 16, -(-cout // 16) * 16
    assert kp.shape == (8, cout16, cin16) and kp.dtype == torch.bfloat16 and kp.is_contiguous()
    want_pack = torch.zeros(8, cout16, cin16)
    want_pack[:, :cout, :shape[1]] = kt.reshape(8, shape[1], cout).transpose(1, 2)
    torch.testing.assert_close(kp.float(), want_pack, rtol=0, atol=0)

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=SMS))
    nblk = upconv.blocks(torch.device("cpu"), upconv.tiles(*shape[:1], *shape[2:]), cout)
    got = _emulate_upconv(xt, kp, bt, cout, nblk)
    _close(got, upconv.upconv2x_cf_reference(xt, kt, bt), FP32_TOL)
    _close(got, jupconv.upconv2x_cf(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias)), FP32_TOL)
    _within_one_bf16_ulp(got.bfloat16(), upconv.upconv2x_cf_reference(xt.bfloat16(), kt, bt))


def test_upconv_bf16_matches_the_jax_depth_to_space_kernel():
    """The tile walk in bf16 (one rounding) against the JAX package's
    Pallas depth-to-space kernel (interpret mode) at Cout = 64, batch 2."""
    rng = np.random.default_rng(11)
    shape, cout = (2, 16, 2, 4, 8), 64
    x = _bf16_valued(rng, shape)
    k = (rng.normal(size=(2, 2, 2, 16, cout)) * 0.25).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    tiles = jupconv._d2s_tiles(16, cout, *shape[2:])
    assert tiles is not None  # the Pallas path, as in bf16 on a TPU
    want = jupconv._upconv_forward_d2s(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k),
                                       jnp.asarray(bias), *tiles)
    kt = torch.from_numpy(k)
    got = _emulate_upconv(torch.from_numpy(x), upconv.pack_kernel(kt), torch.from_numpy(bias),
                          cout, 3)
    _within_one_bf16_ulp(got.bfloat16(), torch.from_numpy(np.array(want.astype(jnp.float32))))


@pytest.mark.parametrize("shape", [
    (1, 32, 96, 96, 96), (1, 64, 48, 48, 48), (1, 128, 24, 24, 24),  # the slice's levels
    (2, 70, 3, 5, 7), (2, 16, 3, 4, 9), (1, 16, 2, 3, 37), (1, 70, 3, 5, 8),  # ragged
])
def test_upconv_call_tiles_and_blocks_match_the_kernel(shape, monkeypatch):
    """The wrapper's tile size and channel group are the kernel's; its
    tiles cover every voxel of every batch element once (the last of each
    element partial); the block count is UPCONV_WAVES blocks per SM over
    the channel groups, at most one per tile, so the walk k, k + nblk, ...
    visits every tile once; the call's arguments, packed weights and
    output are what the C entry point takes (built on meta tensors: no
    data, no launch)."""
    consts = _source_constants("upconv_d2s.cu")
    assert (consts["TM"], consts["OG"]) == (upconv.TM, upconv.OG)
    monkeypatch.setattr(upconv._build, "require", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=SMS))
    b, cin, d, h, w = shape
    v = d * h * w
    ntiles = upconv.tiles(b, d, h, w)
    per_b = ntiles // b
    assert ntiles == b * per_b and (per_b - 1) * upconv.TM < v <= per_b * upconv.TM
    for cout in (16, 20, 32, 64):
        groups = -(-cout // upconv.OG)
        assert (groups - 1) * upconv.OG < cout <= groups * upconv.OG
        nblk = upconv.blocks(torch.device("meta"), ntiles, cout)
        assert nblk == max(1, min(ntiles, upconv.UPCONV_WAVES * SMS // groups))
        walked = sorted(t for k in range(nblk) for t in range(k, ntiles, nblk))
        assert walked == list(range(ntiles))
        meta = {"device": "meta"}
        x = torch.empty(shape, dtype=torch.bfloat16, **meta)
        call = upconv.upconv_call(x, torch.empty(2, 2, 2, cin, cout, **meta),
                                  torch.empty(cout, **meta))
        assert call.entry == "mmseg_upconv_d2s"
        assert call.args[4:] == (b, cin, cout, d, h, w, nblk)
        _, kp, bk, out = call.tensors
        assert kp.shape == (8, -(-cout // 16) * 16, -(-cin // 16) * 16)
        assert kp.dtype == torch.bfloat16 and bk.dtype == torch.float32
        assert call.result is out and out.shape == (b, cout, 2 * d, 2 * h, 2 * w)


def test_upconv_call_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(upconv._build, "require", lambda *a: None)
    x = torch.empty(1, upconv.MAX_IN_CHANNELS + 1, 2, 2, 2, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="Cin <="):
        upconv.upconv_call(x, torch.empty(2, 2, 2, x.shape[1], 16, device="meta"),
                           torch.empty(16, device="meta"))
    x = torch.empty(1, 8, 2, 2, 2, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="does not match"):
        upconv.upconv_call(x, torch.empty(2, 2, 2, 8, 16, device="meta"),
                           torch.empty(15, device="meta"))


def _jax_head_dx(ct, k, dtype):
    """The JAX head's dx as the JAX package's own head tests hold its kernel
    (tests/test_head.py: the einsum): the fp32 sum over the classes, rounded
    once to the features' dtype, as _head_bwd_rule's kernel call rounds it."""
    return jnp.einsum("bodhw,io->bidhw", ct, k).astype(dtype).astype(jnp.float32)


@pytest.mark.parametrize("shape,cf", HEAD_DX_EDGES, ids=[f"{s}-{c}" for s, c in HEAD_DX_EDGES])
def test_head_dx_reference_matches_jax(shape, cf):
    """The plain dx against the JAX head's backward (_head_bwd_rule: the
    head kernel with the transposed weights and a zero bias), in the form
    the JAX package's head tests accept for its kernel: in fp32, and in bf16
    features (dx rounded once) within one ulp."""
    rng = np.random.default_rng(sum(shape) + cf)
    b, co, d, h, w = shape
    ct = (rng.normal(size=shape) * 1e-2).astype(np.float32)
    k = (rng.normal(size=(cf, co)) * 0.5).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = np.array(_jax_head_dx(jnp.asarray(ct), jnp.asarray(k), jdtype))
        got = head.head1x1_cf_dx_reference(torch.from_numpy(ct), torch.from_numpy(k), dtype)
        assert got.dtype == dtype and got.shape == (b, cf, d, h, w)
        if dtype == torch.float32:
            _close(got, want, FP32_TOL)
        else:
            _within_one_bf16_ulp(got, torch.from_numpy(want))


def test_head_calls_take_the_models_weights_without_a_copy(monkeypatch):
    """The model passes kernel = final_conv.weight[:, :, 0, 0, 0].t(); both
    calls read kernel.t(), which is then the parameter itself: no cast, no
    copy, and the dx makes no bias. The C arguments are what the entry
    points take."""
    monkeypatch.setattr(head._build, "require", lambda *a: None)
    param = torch.randn(4, 16, 1, 1, 1)  # final_conv.weight: (classes, Cf, 1, 1, 1)
    kernel = param[:, :, 0, 0, 0].t()
    ct = torch.randn(2, 4, 3, 5, 7)
    call = head.dx_call(ct, kernel)
    assert call.entry == "mmseg_head1x1_dx"
    ctk, wk, dx = call.tensors
    assert wk.data_ptr() == param.data_ptr() and wk.shape == (4, 16)
    assert call.args[1] == param.data_ptr() and call.args[3:] == (2, 4, 16, 3 * 5 * 7)
    assert call.result is dx and dx.shape == (2, 16, 3, 5, 7) and dx.dtype == torch.bfloat16
    x = torch.randn(2, 16, 3, 5, 7).bfloat16()
    fwd = head.head_call(x, kernel, torch.randn(4))
    assert fwd.tensors[1].data_ptr() == param.data_ptr()
    assert fwd.args[4:] == (2, 16, 4, 3 * 5 * 7) and fwd.result.dtype == torch.float32


@pytest.mark.parametrize("cf,co", [(65, 4), (16, 9)])
def test_head_dx_call_refuses_what_the_kernel_does_not_take(cf, co, monkeypatch):
    monkeypatch.setattr(head._build, "require", lambda *a: None)
    with pytest.raises(ValueError, match="the kernel takes"):
        head.dx_call(torch.empty(1, co, 2, 2, 2, device="meta"), torch.empty(cf, co, device="meta"))
