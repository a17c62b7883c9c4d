"""The fused DoubleConv's fp32 instances (kernels 3, 4, 5, 6 and 12 on the
fp32 bodies, csrc/conv3_f32.cu and csrc/conv3_dw_f32.cu), on the CPU:

* each fp32 wrapper on a faked CUDA tensor launches its C entry with the
  arguments, the scratch and the launch descriptor its source takes, at
  the fp32 train step's 192^3 shapes and at ragged ones; every C entry
  point's parameters are the ctypes signature ``ops._build`` gives it;
* the fp32 plain versions of 5 and 6 against the JAX package's
  ``_conv_dx_epilogue`` and ``_conv_dw_prologue`` in Pallas interpret mode
  in fp32, within 2e-5 of max |jax| (the same fp32 products summed in other
  orders; 3, 4 and 12 are held in tests/test_torch_fused_ops.py); 6's
  3xTF32 arithmetic, emulated on the activated input, against its plain
  version within 2e-6 of max |plain|;
* the kernels' order of the channel sums, emulated (the fp32 body's: 4
  voxels a thread in order, a butterfly over the 8 lanes of a channel, the
  block's warps in order, one partial per output tile, the reduce's
  strided sums and tree), reproduces the
  plain s1, s2, da and dt within 1e-6 of the sum of |terms| (fp32 sums of
  a few thousand terms in another order);
* on the card an fp32 tensor never reaches a plain version, and another
  dtype than bf16 or fp32 raises.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there); here the launches are faked on 'meta' tensors, as
tests/test_torch_fp32_train.py does.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from multimodal_segmentation_project_tpu.ops import pallas_conv as jconv
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.ops import _build, conv3, conv3_fused
from tests.test_torch_fp32_eval import _constants, _require_as_on_the_card
from tests.test_torch_fp32_train import DW_TOL_3XTF32, emulate_dw_f32
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

CSRC = Path(conv3.__file__).resolve().parent.parent / "csrc"
SMS = 132  # the H100's SM count, which the faked device properties report
TOL = 2e-5
SUM_TOL = 1e-6
# (Cin, Cout, S) of the fused blocks' convs at 192^3 (conv0, conv1 of enc0-enc2,
# dec2, dec3), and ragged ones: W = 7, 9, 20, 37; Cin = 1, 40; Cout = 20, 48
STEP_CASES = [(1, 16, 192), (16, 32, 96), (32, 64, 48), (64, 32, 96), (32, 16, 192),
              (16, 16, 192), (32, 32, 96), (64, 64, 48)]
RAGGED_CASES = [(40, 20, 9), (16, 48, 7), (1, 48, 20), (40, 20, 37), (64, 8, 5)]


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


@pytest.fixture
def faked_launches(monkeypatch):
    """Launches on a non-CPU tensor recorded, not run; the device checks as
    on the card; the SM count an H100's."""
    calls = []

    def fake_run(name, call, t):
        calls.append(call)
        return call.result

    monkeypatch.setattr(conv3, "run", fake_run)  # conv3_fused launches through conv3.run
    monkeypatch.setattr(_build, "require", _require_as_on_the_card)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=SMS))
    return calls


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _tile_d(cout):
    """The fp32 body's output planes of a tile: one a warpgroup, three for a
    slice of 16 channels, two for one of 32 (csrc/conv3_f32.cu)."""
    assert "constexpr int warpgroups(int ns) { return ns == 16 ? 3 : 2; }" in (
        CSRC / "conv3_f32.cu").read_text()
    return 3 if cout <= 16 else 2


def _blocks(d, h, w, cout):
    """The fp32 body's output tiles per batch element (csrc/conv3_f32.cu's
    TILE_D x TILE_H x TILE_W), one partial of each channel sum each."""
    k = _constants("conv3_f32.cu")
    return -(-d // _tile_d(cout)) * -(-h // k["TILE_H"]) * -(-w // k["TILE_W"])


# ---- the launches against their sources ---------------------------------------------


@pytest.mark.parametrize("cin,cout,s", STEP_CASES + RAGGED_CASES)
@pytest.mark.parametrize("op", ["stats", "boundary_stats", "boundary"])
def test_the_fp32_fused_forwards_launch_as_the_source_says(op, cin, cout, s, faked_launches):
    """Kernels 3, 4 and 12 in fp32: the fp32 body's entries with its weight
    packing, the fp32 bias, the descriptor of conv3.f32_launch_dims, and
    for 3 and 4 a scratch of one partial per (sum, channel, batch, block)
    and the (2, Cout) sums."""
    bsz = 2
    x = _meta(bsz, cin, s, s + 1, s)
    w, b = _meta(3, 3, 3, cin, cout), _meta(cout)
    a, t = _meta(bsz, cin), _meta(bsz, cin)
    call = {"stats": lambda: conv3_fused.stats_call(x, w, b),
            "boundary_stats": lambda: conv3_fused.boundary_stats_call(x, w, b, a, t),
            "boundary": lambda: conv3_fused.boundary_call(x, w, b, a, t)}[op]()
    entry = {"stats": "mmseg_conv3_f32_stats", "boundary_stats": "mmseg_conv3_f32_prologue_stats",
             "boundary": "mmseg_conv3_f32_prologue"}[op]
    assert call.entry == entry and len(call.args) + 1 == len(_build._SIGNATURES[entry])
    dims = conv3.f32_launch_dims(x.device, tuple(x.shape), cout)
    assert call.args[-11:] == (bsz, cin, cout, s, s + 1, s, *dims)
    wk = call.tensors[1]
    ck, ns = conv3.f32_chunk(cin), conv3.f32_slice(cout)
    assert wk.dtype == torch.float32 and wk.shape == (-(-cout // ns), -(-cin // ck),
                                                      conv3.f32_k_steps(ck), 2, 2, 3 * ns, 4)
    assert call.tensors[2].dtype == torch.float32 and call.tensors[2].shape == (cout,)
    y = call.result if op == "boundary" else call.result[0]
    assert y.shape == (bsz, cout, s, s + 1, s) and y.dtype == torch.float32
    if op == "boundary":
        return
    partial, stats = call.tensors[4], call.tensors[5]
    assert partial.shape == (2 * cout * bsz * _blocks(s, s + 1, s, cout),)
    nslices = -(-cout // conv3.f32_slice(cout))
    assert dims[:3] == (min(bsz * _blocks(s, s + 1, s, cout) * nslices, SMS), 1, 1)
    assert stats.shape == (2, cout) and all(r.shape == (cout,) for r in call.result[1:])


@pytest.mark.parametrize("cin,cout,s", STEP_CASES + RAGGED_CASES)
def test_the_fp32_dx_epilogue_launches_as_the_source_says(cin, cout, s, faked_launches):
    """Kernel 5 in fp32: the dx conv of the cotangent (Cout channels) on the
    flipped, transposed weights packed for the fp32 body, the boundary
    conv's raw input and (a, t) of its Cin channels, the descriptor of the
    fp32 body on the cotangent with Cin output channels, and a scratch of
    one partial per (sum, batch, channel, block)."""
    bsz = 2
    g, x = _meta(bsz, cout, s, s, s + 2), _meta(bsz, cin, s, s, s + 2)
    w, a, t = _meta(3, 3, 3, cin, cout), _meta(bsz, cin), _meta(bsz, cin)
    call = conv3_fused.dx_epilogue_call(g, w, x, a, t)
    assert call.entry == "mmseg_conv3_f32_dx_epilogue"
    assert len(call.args) + 1 == len(_build._SIGNATURES[call.entry])
    assert call.args[-11:] == (bsz, cout, cin, s, s, s + 2,
                               *conv3.f32_launch_dims(g.device, tuple(g.shape), cin))
    # the dx conv: Cout input channels, Cin output ones
    ck, ns = conv3.f32_chunk(cout), conv3.f32_slice(cin)
    assert call.tensors[1].shape == (-(-cin // ns), -(-cout // ck), conv3.f32_k_steps(ck), 2, 2,
                                     3 * ns, 4)
    dy, da, dt = call.result
    assert dy.shape == x.shape and dy.dtype == torch.float32
    assert da.shape == dt.shape == (bsz, cin)
    assert call.tensors[6].shape == (2 * bsz * cin * _blocks(s, s, s + 2, cin),)


@pytest.mark.parametrize("cin,cout,s", STEP_CASES + RAGGED_CASES)
def test_the_fp32_dw_prologue_launches_as_the_source_says(cin, cout, s, faked_launches):
    """Kernel 6 in fp32: the fp32 dW body's prologue entry, with the fp32 dW's
    scratch and descriptor (conv3.dw_f32_launch_dims: grid (nblk, ceil(Cin
    / CIB), ceil(Cout / COB)), DW_THREADS threads, the shared memory of
    Cout's m16 tiling, from csrc/conv3_dw_f32.cu's constants) and a, t (B,
    Cin)."""
    k = _constants("conv3_dw_f32.cu")
    bsz = 2
    x, g = _meta(bsz, cin, s, s + 1, s), _meta(bsz, cout, s, s + 1, s)
    call = conv3_fused.dw_prologue_call(x, g, _meta(bsz, cin), _meta(bsz, cin))
    plain = conv3.dw_f32_call(x, g)
    assert call.entry == "mmseg_conv3_dw_f32_prologue"
    assert len(call.args) + 1 == len(_build._SIGNATURES[call.entry])
    assert call.args[6:] == plain.args[4:]  # the sizes and the descriptor
    dims = conv3.dw_f32_launch_dims(None, tuple(x.shape), cout)
    cb, cz = -(-cin // k["CIB"]), -(-cout // k["COB"])
    assert call.args[-5:] == dims
    assert dims[:4] == (max(1, SMS // (cb * cz)), cb, cz, k["DW_THREADS"])
    assert dims[4] == conv3.dw_f32_smem_bytes(cout) <= 227 * 1024
    assert "launch<true>(x, g, a, t, partial, dw," in (CSRC / "conv3_dw_f32.cu").read_text()
    assert call.tensors[4].shape == (dims[0] * 27 * cin * cout,)
    assert call.result.shape == (3, 3, 3, cin, cout) and call.result.dtype == torch.float32


def _c_entries() -> dict:
    """name -> the ctypes types of each MMSEG_API function's parameters, read
    from csrc."""
    import ctypes

    ctype = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong}
    out = {}
    for src in CSRC.glob("*.cu"):
        text = src.read_text()
        for name, params in re.findall(r"MMSEG_API\s+\w+\s+(\w+)\(([^)]*)\)", text):
            types = []
            for p in filter(None, (q.strip() for q in params.split(","))):
                p = re.sub(r"\bconst\b", "", p)
                base = re.sub(r"\s+\w+$", "", p).replace(" ", "")
                base = "void*" if base == "void*" else base.replace("longlong", "long long")
                types.append(ctype[base])
            out[name] = tuple(types)
    return out


@pytest.mark.parametrize("entry", sorted(_build._SIGNATURES))
def test_each_entry_points_ctypes_signature_is_its_sources(entry):
    """ctypes passes each argument as the signature says (a pointer cut to
    an int would launch on garbage): the types of every entry point's
    parameters in csrc, in order, are those ops._build declares."""
    assert _c_entries()[entry] == _build._SIGNATURES[entry]


def test_the_fp32_fused_sources_refuse_no_instance():
    """Both fp32 bodies carry the fused block's instances: no static_assert
    refuses an epilogue or the prologue, the enum is conv3.cu's, and the
    entries dispatch the instances the wrappers name."""
    conv, dw = ((CSRC / n).read_text() for n in ("conv3_f32.cu", "conv3_dw_f32.cu"))
    assert "not written yet" not in conv and "not written yet" not in dw
    assert "enum Epilogue { kBiasRelu = 0, kCastBias = 1, kBiasStats = 2, kDxMask = 3 };" in conv
    for inst in ("dispatch<kBiasStats, false>", "dispatch<kBiasStats, true>",
                 "dispatch<kCastBias, true>", "dispatch<kDxMask, false>"):
        assert inst in conv
    assert "launch<true>(" in dw and "launch<false>(" in dw


# ---- the plain fp32 versions of 5 and 6 against JAX ------------------------------------


def _dx_dw_inputs(seed, bsz, cin, cout, shape):
    """g, w, x, a, t with t > 0 on the even channels and < 0 on the odd ones."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(bsz, cout, *shape)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    x = rng.normal(size=(bsz, cin, *shape)).astype(np.float32)
    a = (rng.normal(size=(bsz, cin)) + 1.0).astype(np.float32)
    t = (np.abs(rng.normal(size=(bsz, cin))) * np.where(np.arange(cin) % 2 == 0, 1.0, -1.0)
         ).astype(np.float32)
    return g, w, x, a, t


def _close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{name}: max err {err} > {TOL} * {scale}"


@pytest.mark.parametrize("bsz,cin,cout,shape", [(2, 4, 8, (4, 8, 16)), (1, 8, 4, (4, 8, 8)),
                                                (1, 3, 5, (3, 8, 7))])
def test_the_fp32_dx_epilogue_plain_version_matches_jax(bsz, cin, cout, shape):
    """Kernel 5's plain version in fp32 (dy, da, dt) against the JAX
    package's _conv_dx_epilogue on the padded cotangent and the flipped,
    transposed weights, as its boundary backward calls it."""
    g, w, x, a, t = _dx_dw_inputs(sum(shape) + cin, bsz, cin, cout, shape)
    wt = jnp.transpose(jnp.asarray(w)[::-1, ::-1, ::-1], (0, 1, 2, 4, 3))
    want = jconv._conv_dx_epilogue(jconv._pad_for_kernel(jnp.asarray(g)), jconv.pack_weights(wt),
                                   jnp.asarray(x), jnp.asarray(a), jnp.asarray(t))
    got = conv3_fused.conv3x3x3_cf_dx_epilogue_reference(*map(torch.from_numpy, (g, w, x, a, t)))
    for name, o, r in zip(("dy", "da", "dt"), got, want):
        _close(o.numpy(), r, name)
    assert got[0].dtype == torch.float32


@pytest.mark.parametrize("bsz,cin,cout,shape", [(2, 4, 8, (4, 8, 16)), (1, 8, 4, (4, 8, 8)),
                                                (1, 3, 5, (3, 8, 7))])
def test_the_fp32_dw_prologue_plain_version_matches_jax(bsz, cin, cout, shape):
    """Kernel 6's plain version in fp32 against the JAX package's
    _conv_dw_prologue (the dW through relu(x a + t), the halo kept 0)."""
    g, _, x, a, t = _dx_dw_inputs(7 * sum(shape) + cout, bsz, cin, cout, shape)
    packed = jconv._conv_dw_prologue(jconv._pad_for_kernel(jnp.asarray(x)),
                                     jconv._pad_for_kernel(jnp.asarray(g)), jnp.asarray(a),
                                     jnp.asarray(t), cout, shape[-1])
    want = jconv.unpack_weight_grads(packed, cin, cout)
    got = conv3_fused.conv3x3x3_cf_dw_prologue_reference(*map(torch.from_numpy, (x, g, a, t)))
    _close(got.numpy(), want, "dw")


@pytest.mark.parametrize("bsz,cin,cout,shape,sms", [(2, 16, 16, (4, 7, 20), 5),
                                                      (1, 5, 9, (3, 8, 17), 3),
                                                      (2, 20, 48, (3, 4, 9), 132)])
def test_the_fp32_dw_prologue_in_3xtf32_reproduces_the_plain_version(bsz, cin, cout, shape, sms,
                                                                    monkeypatch):
    """Kernel 6's fp32 instance stages relu(x a + t) (the plain version's
    values: x a + t rounded after each operation, the halo 0, t > 0 on
    some channels) and then runs the 3xTF32 body: the body's arithmetic
    emulated on that input (tests/test_torch_fp32_train.py's
    emulate_dw_f32) reproduces conv3x3x3_cf_dw_prologue_reference, held
    against JAX above, within DW_TOL_3XTF32 = 2e-6 of its max."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=sms))
    g, _, x, a, t = _dx_dw_inputs(11 * sum(shape) + cout, bsz, cin, cout, shape)
    x, g, a, t = map(torch.from_numpy, (x, g, a, t))
    want = conv3_fused.conv3x3x3_cf_dw_prologue_reference(x, g, a, t)
    got = emulate_dw_f32(conv3_fused.prologue_reference(x, a, t), g)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= DW_TOL_3XTF32, err


# ---- the kernels' order of the channel sums ---------------------------------------------


def _block_partials(terms: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) fp32 terms -> (B, C, tiles) fp32: each output tile's
    sum as conv3_f32.cu takes it. In a TILE_D x TILE_H x TILE_W tile (3 x 8
    x 14 for C <= 16, else 2 x 8 x 14: a warpgroup a plane), warp 4 g + q of
    the block holds rows q and 4 + q of plane g, and its lane (gq, tq)
    fragment rows gq and gq + 8 of each, output voxels w0 + gq - 1 and w0 +
    gq + 7 (rows 1 to 14 only); a thread adds its terms of a channel in
    order (row q, then 4 + q; fragment row gq, then gq + 8), a butterfly
    over the 8 lanes gq that share the channel sums them (((r0 + r1) + (r2 +
    r3)) + ((r4 + r5) + (r6 + r7))), and the block's warps add in warp
    order. Voxels past the volume add nothing (0 here: adding 0 is exact)."""
    bsz, c, d, h, w = terms.shape
    k = _constants("conv3_f32.cu")
    td, th, tw = _tile_d(c), k["TILE_H"], k["TILE_W"]
    nd, nh, nw = -(-d // td), -(-h // th), -(-w // tw)
    v = F.pad(terms, (0, nw * tw - w, 0, nh * th - h, 0, nd * td - d))
    # the 16 fragment rows of a tile's output row: rows 0 and 15 are no voxel
    v = F.pad(v.reshape(bsz, c, nd * td, nh * th, nw, tw), (1, 16 - tw - 1))
    # (B, C, nd, g, nh, mt, q, nw, v1, gq) -> (B, C, nd, nh, nw, g, q, gq, mt, v1)
    v = v.reshape(bsz, c, nd, td, nh, 2, 4, nw, 2, 8).permute(0, 1, 2, 4, 7, 3, 6, 9, 5, 8)
    r = torch.zeros(v.shape[:-2])
    for mt in range(2):
        for v1 in range(2):
            r = r + v[..., mt, v1]
    lane = torch.arange(8)
    for sh in (1, 2, 4):  # the lanes 4, 8 and 16 apart: gq ^ 1, ^ 2, ^ 4
        r = r + r[..., lane ^ sh]
    r = r[..., 0].reshape(*r.shape[:5], 4 * td)  # (B, C, nd, nh, nw, warp 4 g + q)
    block = r[..., 0]
    for wp in range(1, 4 * td):
        block = block + r[..., wp]
    return block.reshape(bsz, c, nd * nh * nw)


def _reduce(runs: torch.Tensor) -> torch.Tensor:
    """(R, len) -> (R,): conv3_f32_stats_reduce_kernel's order: thread i of
    256 sums elements i, i + 256, ... in order, then a tree halves the
    threads."""
    n = runs.shape[1]
    p = F.pad(runs, (0, -(-n // 256) * 256 - n)).reshape(runs.shape[0], -1, 256)
    acc = torch.zeros(runs.shape[0], 256)
    for k in range(p.shape[1]):
        acc = acc + p[:, k]
    h = 128
    while h:
        acc = torch.cat([acc[:, :h] + acc[:, h:2 * h], acc[:, 2 * h:]], dim=1)
        h //= 2
    return acc[:, 0]


def _stats_in_kernel_order(y):
    """(s1, s2) of kBiasStats: runs (sum, channel) of (batch, block) partials."""
    out = []
    for terms in (y, y * y):  # the square rounded, then added
        part = _block_partials(terms)  # (B, C, blocks)
        out.append(_reduce(part.permute(1, 0, 2).reshape(y.shape[1], -1)))
    return out


def _dadt_in_kernel_order(du, x):
    """(da, dt) of kDxMask: runs (sum, batch, channel) of (block) partials."""
    return [_reduce(_block_partials(terms).reshape(-1, _block_partials(terms).shape[-1]))
            .reshape(du.shape[:2]) for terms in (du * x, du)]


@pytest.mark.parametrize("shape", [(2, 5, 6, 10, 20), (1, 3, 9, 17, 37), (2, 2, 4, 8, 16),
                                   (1, 1, 13, 30, 33)])
def test_the_fp32_stats_summed_in_kernel_order_reproduce_the_plain_sums(shape):
    """kBiasStats's order of sums over y = conv + bias reproduces the plain
    s1, s2 of conv3x3x3_cf_stats_reference (held against the JAX package in
    tests/test_torch_fused_ops.py) within 1e-6 of the sum of |terms|; a
    block's partial left out would move a channel by far more."""
    rng = np.random.default_rng(sum(shape))
    bsz, cout = shape[:2]
    x = torch.from_numpy(rng.normal(size=(bsz, 3, *shape[2:])).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, 3, cout)) * 0.2).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    y, s1, s2 = conv3_fused.conv3x3x3_cf_stats_reference(x, w, b)
    got = _stats_in_kernel_order(y)
    for name, k, p, terms in (("s1", got[0], s1, y.abs()), ("s2", got[1], s2, y * y)):
        bound = SUM_TOL * terms.sum(dim=(0, 2, 3, 4))
        assert ((k - p).abs() <= bound).all(), name
    part = _block_partials(y)
    if part.shape[-1] > 1:  # one block fewer is refused
        lost = part[..., 1:].sum(dim=(0, 2))
        assert ((lost - s1).abs() > SUM_TOL * y.abs().sum(dim=(0, 2, 3, 4))).any()


@pytest.mark.parametrize("shape,cout", [((2, 5, 6, 10, 20), 4), ((1, 3, 9, 17, 37), 6),
                                        ((2, 16, 4, 8, 16), 8)])
def test_the_fp32_dadt_summed_in_kernel_order_reproduce_the_plain_sums(shape, cout):
    """kDxMask's order of sums over du x and du (du the masked dx conv, each
    product rounded before it is added) reproduces the plain da, dt of
    conv3x3x3_cf_dx_epilogue_reference within 1e-6 of the sum of |terms|."""
    g, w, x, a, t = map(torch.from_numpy, _dx_dw_inputs(sum(shape), shape[0], shape[1], cout,
                                                        shape[2:]))
    dy, da, dt = conv3_fused.conv3x3x3_cf_dx_epilogue_reference(g, w, x, a, t)
    dr = conv3.conv_fp32(g, conv3.flip_transpose(w))
    du = torch.where(x * a[..., None, None, None] + t[..., None, None, None] > 0, dr, 0.0)
    got_da, got_dt = _dadt_in_kernel_order(du, x)
    for name, k, p, terms in (("da", got_da, da, (du * x).abs()), ("dt", got_dt, dt, du.abs())):
        assert ((k - p).abs() <= SUM_TOL * terms.sum(dim=(2, 3, 4))).all(), name


# ---- on the card: no plain version, and other dtypes refused ---------------------------


def test_every_fused_op_in_fp32_on_the_card_launches_its_fp32_entry(faked_launches):
    """The three fused ops' forward and backward on fp32 device tensors
    launch the fp32 entries and count on the *_f32 counters: 3 with the
    training conv's dx and dW, 4 and 12 with 5 and 6."""
    def leaf(*shape):
        return _meta(*shape).requires_grad_(True)

    x, w, b = leaf(2, 16, 4, 8, 16), leaf(3, 3, 3, 16, 32), leaf(32)
    a, t = leaf(2, 16), leaf(2, 16)
    y, s1, s2 = conv3_fused.conv3x3x3_cf_stats(x, w, b)
    (y.sum() + s1.sum() + s2.sum()).backward()
    y, s1, s2 = conv3_fused.conv3x3x3_cf_boundary_stats(x, w, b, a, t)
    (y.sum() + s1.sum() + s2.sum()).backward()
    conv3_fused.conv3x3x3_cf_boundary(x, w, b, a, t).sum().backward()
    assert [c.entry for c in faked_launches] == [
        "mmseg_conv3_f32_stats", "mmseg_conv3_f32", "mmseg_conv3_dw_f32",
        "mmseg_conv3_f32_prologue_stats", "mmseg_conv3_f32_dx_epilogue",
        "mmseg_conv3_dw_f32_prologue",
        "mmseg_conv3_f32_prologue", "mmseg_conv3_f32_dx_epilogue", "mmseg_conv3_dw_f32_prologue"]
    assert {k: n for k, n in ops.launch_counts().items() if n} == {
        "conv3x3x3_cf_stats_f32": 1, "conv3x3x3_cf_boundary_stats_f32": 1,
        "conv3x3x3_cf_boundary_f32": 1, "conv3x3x3_cf_dx_epilogue_f32": 2,
        "conv3x3x3_cf_dw_prologue_f32": 2, "conv3x3x3_cf_dx_f32": 1, "conv3x3x3_cf_dw_f32": 1}
    for p in (x, w, b, a, t):
        assert p.grad is not None and p.grad.dtype == torch.float32


def test_the_fused_ops_refuse_other_dtypes_on_the_card(faked_launches):
    """fp16 (or any dtype but bf16 and fp32) on the card raises: the bf16
    kernels take bf16 only, the fp32 ones fp32 only, so an fp32 cotangent
    with another input (or the reverse) raises too."""
    x = _meta(1, 16, 4, 8, 16, dtype=torch.float16)
    w, b, a, t = _meta(3, 3, 3, 16, 16), _meta(16), _meta(1, 16), _meta(1, 16)
    for fn, args in ((conv3_fused.conv3x3x3_cf_stats, (x, w, b)),
                     (conv3_fused.conv3x3x3_cf_boundary_stats, (x, w, b, a, t)),
                     (conv3_fused.conv3x3x3_cf_boundary, (x, w, b, a, t)),
                     (conv3_fused.conv3x3x3_cf_dx_epilogue, (x, w, x, a, t)),
                     (conv3_fused.conv3x3x3_cf_dw_prologue, (x, x, a, t))):
        with pytest.raises(TypeError, match="takes torch.bfloat16"):
            fn(*args)
    f32, bf16 = _meta(1, 16, 4, 8, 16), _meta(1, 16, 4, 8, 16, dtype=torch.bfloat16)
    for call, args, want in ((conv3_fused.dx_epilogue_call, (f32, w, x, a, t), "float32"),
                             (conv3_fused.dx_epilogue_call, (f32, w, bf16, a, t), "float32"),
                             (conv3_fused.dx_epilogue_call, (bf16, w, f32, a, t), "bfloat16"),
                             (conv3_fused.dw_prologue_call, (f32, x, a, t), "float32"),
                             (conv3_fused.dw_prologue_call, (f32, bf16, a, t), "float32"),
                             (conv3_fused.dw_prologue_call, (bf16, f32, a, t), "bfloat16")):
        with pytest.raises(TypeError, match=f"takes torch.{want}"):
            call(*args)
    with pytest.raises(ValueError, match=r"a \(1, 8\) is not"):
        conv3_fused.boundary_stats_call(f32, w, b, _meta(1, 8), t)
    with pytest.raises(ValueError, match="does not match the cotangent"):
        conv3_fused.dx_epilogue_call(f32, w, _meta(1, 16, 4, 8, 8), a, t)
    assert faked_launches == [] and not any(ops.launch_counts().values())
