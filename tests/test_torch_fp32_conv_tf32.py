"""The fp32 conv body's arithmetic (csrc/conv3_f32.cu, the fp32 instances of
kernels 1, 1-dx, 3, 4, 5, 7 and 12), emulated on the CPU.

The body is a 3xTF32 implicit GEMM on wgmma with the kw taps on N: per
output tile of conv3.f32_tile(Cout) voxels, slice of NS output channels and chunk
of CK input channels, the rows of a warp's fragment are the 16 input voxels
w0 - 1 .. w0 + 14 of an output row, K is (kd, kh, ci) and N is (kw,
channel). A thread reads its A values from the staged haloed tile at the
offsets of the kernel's k table (zero-padded to whole k steps of 8),
applies the prologue there (relu(x a + t), 0 on the halo by the per-row
mask of the (kd, kh) pairs inside the volume), splits each value into hi =
tf32(v) and lo = v - hi cut to TF32's 19 bits, and the tensor core adds
lo_a hi_b, hi_a lo_b and hi_a hi_b of each k step to the chunk's sum. At
the chunk's end output row r of a channel is ((row r - 1 at kw 0 + row r
at kw 1) + row r + 1 at kw 2), added to the fp32 master sum; rows 1 to 14
are the tile's 14 output voxels. The weights arrive split by
ops/conv3.py:pack_weights_f32.

Here the staging geometry (XD x XH rows of XW floats from voxel w0 - 1
rounded down to 4), the table's offsets and masks, the fragments' rows and
the packed planes are those of the source, and the sums are fp32 sums of
whole k steps in the kernel's order (the tensor core's own order inside a
wgmma is not emulated). Tolerances: the emulated body against the plain
fp32 conv, TOL_3XTF32 = 2e-6 of max |plain| (the terms 3xTF32 drops are
about 2^-22 of a product; a tenth of the card's bound); one TF32 pass
(hi_a hi_b alone) must read above the card's F32_TOL = 2e-5, so that the
first bound tells a 3xTF32 sum from a 1xTF32 one.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from multimodal_segmentation_project_tpu_torch.ops import conv3, conv3_fused
from tests.test_torch_fp32_eval import _constants
from tests.test_torch_fp32_train import _tf32
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

TOL_3XTF32 = 2e-6
F32_TOL = 2e-5
K = _constants("conv3_f32.cu")
XD, XH, XW = K["XD"], K["XH"], K["XW"]
XCH = XD * XH * XW


def _table(ck: int):
    """The kernel's k table: for k step s and lane tq of a quad, the staged
    offsets, (kd, kh) pair and channel of k = 8 s + tq and 8 s + tq + 4 (k =
    CK pair + ci); a padded k reads pair 0 of channel 0 (against zero
    weights)."""
    ks = conv3.f32_k_steps(ck)
    k = torch.arange(8 * ks).reshape(ks, 2, 4).permute(0, 2, 1)  # (s, tq, j)
    real = k < 9 * ck
    pair, ci = torch.where(real, k // ck, 0), torch.where(real, k % ck, 0)
    off = ci * XCH + ((pair // 3) * XH + pair % 3) * XW
    return off, pair, ci


def _tf32_cut(t: torch.Tensor) -> torch.Tensor:
    """fp32 cut to TF32's top 19 bits (toward zero), as the kernel cuts lo."""
    return (t.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def emulate_conv_f32(x, w, a=None, t=None, passes: int = 3) -> torch.Tensor:
    """conv3_f32.cu's conv of x (B, Cin, D, H, W) with w (3, 3, 3, Cin, Cout),
    through the prologue where a, t (B, Cin) are given, on the CPU -> (B,
    Cout, D, H, W), before any epilogue. passes = 1: hi_a hi_b alone."""
    bsz, cin, d, h, wd = x.shape
    cout = w.shape[4]
    td, th, tw = conv3.f32_tile(cout)
    wk = conv3.pack_weights_f32(w)  # (nslices, nchunks, KS, 2, 2, N, 4)
    nsl, nch, ks, n = wk.shape[0], wk.shape[1], wk.shape[2], wk.shape[5]
    ns, ck = n // 3, conv3.f32_chunk(cin)
    assert ks == conv3.f32_k_steps(ck) and nch == -(-cin // ck) and ns == conv3.f32_slice(cout)
    # the B planes, k = 8 s + 4 kg + e
    bp = wk.permute(0, 1, 3, 2, 4, 6, 5).reshape(nsl, nch, 2, 8 * ks, n)
    off, pair, ci = _table(ck)
    kidx = off.permute(0, 2, 1).reshape(-1)  # k = 8 s + 4 j + tq
    kpair, kci = pair.permute(0, 2, 1).reshape(-1), ci.permute(0, 2, 1).reshape(-1)
    kd, kh = kpair // 3, kpair % 3
    # the fragments' rows: warp (g, wq) of td warpgroups, m64 tile mt, row r
    # = gq + 8 v1 (input voxel w0 - 1 + r of output row 4 mt + wq of plane g)
    g, wq, mt, r = (u.reshape(-1) for u in torch.meshgrid(
        *(torch.arange(k) for k in (td, 4, 2, 16)), indexing="ij"))
    m = 128 * td
    od, oh = g, 4 * mt + wq
    idx = ((g * XH + wq) * XW + r + 4 * XW * mt)[:, None] + kidx[None, :]  # (m, 8 KS)
    nd, nh, nw = -(-d // td), -(-h // th), -(-wd // tw)
    # the TMA boxes: channels past Cin, voxels outside the volume zero; a
    # row from voxel -4 so that every box starts at w0 - 1 rounded down to 4
    xp = F.pad(x.float(), (4, 4 + XW + nw * tw - wd, 1, XH + nh * th - h, 1, XD + nd * td - d,
                           0, nch * ck - cin))
    out = torch.zeros(bsz, nsl * ns, nd * td, nh * th, nw * tw + 16)
    for b in range(bsz):
        for i in range(nd):
            for j in range(nh):
                for k in range(nw):
                    d0, h0, w0 = i * td, j * th, k * tw
                    start = (w0 - 1) - ((w0 - 1) & 3)
                    sh = (w0 - 1) - start
                    for sl in range(nsl):
                        master = torch.zeros(m, ns)
                        for c in range(nch):
                            xs = xp[b, c * ck:(c + 1) * ck, d0:d0 + XD, h0:h0 + XH,
                                    start + 4:start + 4 + XW].reshape(-1)
                            av = xs[idx + sh]  # (m rows, 8 KS)
                            if a is not None:
                                ch = c * ck + kci
                                at = torch.where(ch < cin, a[b, ch.clamp(max=cin - 1)], 0.0)
                                tt = torch.where(ch < cin, t[b, ch.clamp(max=cin - 1)], 0.0)
                                gd = d0 - 1 + od[:, None] + kd
                                gh = h0 - 1 + oh[:, None] + kh
                                gw = (w0 - 1 + r)[:, None]
                                inside = ((gd >= 0) & (gd < d) & (gh >= 0) & (gh < h)
                                          & (gw >= 0) & (gw < wd))
                                u = av * at + tt
                                av = torch.where(inside, torch.where(u < 0, 0.0, u), 0.0)
                            hi = _tf32(av)
                            lo = _tf32_cut(av - hi)
                            acc = torch.zeros(m, n)
                            for s in range(ks):
                                sl_k = slice(8 * s, 8 * s + 8)
                                pairs = [(lo, bp[sl, c, 0]), (hi, bp[sl, c, 1]),
                                         (hi, bp[sl, c, 0])]
                                for aa, bb in pairs[3 - passes:]:
                                    acc = acc + aa[:, sl_k] @ bb[sl_k]
                            rows = acc.reshape(m // 16, 16, 3, ns)  # (warp, m64 tile), r, kw, co
                            left = F.pad(rows[:, :-1, 0], (0, 0, 1, 0))
                            right = F.pad(rows[:, 1:, 2], (0, 0, 0, 1))
                            master = master + ((left + rows[:, :, 1]) + right).reshape(m, ns)
                        # rows 1 to 14 are output voxels w0 .. w0 + 13
                        keep = (r >= 1) & (r <= tw)
                        out[b, sl * ns:(sl + 1) * ns, d0 + od[keep], h0 + oh[keep],
                            w0 + r[keep] - 1] = master[keep].t()
    return out[:, :cout, :d, :h, :wd]


# (batch, Cin, Cout, (D, H, W), prologue): Cin 1 (the (kd, kh) pairs on K),
# 40 (five chunks of 8, the last partial) and 64; Cout 16, 20 (a slice of
# 32, partly zero) and 48 (two slices); W 7 and 37 (ragged tiles, a box
# start shifted by 1); batch 2
CASES = [(2, 1, 16, (3, 9, 7), False), (1, 40, 20, (3, 5, 37), False),
         (2, 64, 48, (2, 5, 7), False), (1, 40, 48, (3, 9, 7), True),
         (2, 1, 20, (3, 5, 37), True), (2, 64, 16, (3, 4, 7), True)]


def _case(bsz, cin, cout, shape, pro):
    rng = np.random.default_rng(bsz + cin + cout + sum(shape))
    x = torch.from_numpy(rng.normal(size=(bsz, cin, *shape)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, cin, cout)) / (27 * cin) ** 0.5)
                         .astype(np.float32))
    if not pro:
        return x, w, None, None, conv3.conv_fp32(x, w)
    # t of both signs: relu(t) > 0 on the halo where the mask did not hold it at 0
    a = torch.from_numpy((np.abs(rng.normal(size=(bsz, cin))) + 0.5).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(bsz, cin)).astype(np.float32))
    return x, w, a, t, conv3.conv_fp32(conv3_fused.prologue_reference(x, a, t), w)


@pytest.mark.parametrize("bsz,cin,cout,shape,pro", CASES)
def test_the_fp32_body_in_3xtf32_reproduces_the_plain_conv(bsz, cin, cout, shape, pro):
    """The body's arithmetic emulated (emulate_conv_f32: its staging, k table
    and fragments, the prologue in registers with the halo masked, the
    hi/lo split, the three products of a k step in the kernel's order, the
    per-chunk promotion) reproduces the plain fp32 conv (of relu(x a + t)
    with the prologue) within TOL_3XTF32 of its max."""
    x, w, a, t, want = _case(bsz, cin, cout, shape, pro)
    got = emulate_conv_f32(x, w, a, t)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err <= TOL_3XTF32, err


@pytest.mark.parametrize("bsz,cin,cout,shape,pro", CASES)
def test_one_tf32_pass_of_the_fp32_body_misses_the_fp32_bound(bsz, cin, cout, shape, pro):
    """The control: the same emulation with hi_a hi_b alone reads above
    F32_TOL = 2e-5 of max |plain|."""
    x, w, a, t, want = _case(bsz, cin, cout, shape, pro)
    got = emulate_conv_f32(x, w, a, t, passes=1)
    err = float((got - want).abs().max()) / float(want.abs().max())
    assert err > F32_TOL, err


def test_the_table_reads_every_bank_once():
    """A warp's ld.shared of one A value: lanes (gq, tq) read fragment row
    gq at k = 8 s + 4 j + tq, i.e. channels 4 j + tq of one (kd, kh) pair
    (CK = 8): XCH = 8 (mod 32) puts the four channels' 8 rows on 32
    distinct banks at every k step and shift of the tile's first voxel."""
    assert XCH % 32 == 8
    off, _, _ = _table(8)
    for s in range(off.shape[0]):
        for j in range(2):
            for sh in range(4):
                addr = (sh + torch.arange(8)[:, None] + off[s, :, j][None, :]).reshape(-1)
                assert len({a % 32 for a in addr.tolist()}) == 32, (s, j, sh)


def test_the_packed_planes_are_exact_tf32_and_sum_to_the_weights():
    """hi = tf32(w) and lo = tf32(w - hi), both with 13 zero mantissa bits
    (cvt.rna's rounding: to nearest, ties away from zero), and hi + lo
    within 2^-21 of |w|, at k = CK (3 kd + kh) + ci and n = NS kw + co; a
    tie rounds away from zero."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, 40, 20)) * 0.1).astype(np.float32))
    wk = conv3.pack_weights_f32(w)  # (1 slice, 5 chunks, 9, 2, 2, 96, 4)
    assert not (wk.view(torch.int32) & 0x1FFF).any()
    planes = wk.permute(0, 1, 3, 2, 4, 6, 5).reshape(1, 5, 2, 72, 96)
    wsum = (planes[0, :, 0] + planes[0, :, 1]).reshape(5, 3, 3, 8, 3, 32)  # chunk kd kh ci kw co
    want = F.pad(w, (0, 12)).reshape(3, 3, 3, 5, 8, 32).permute(3, 0, 1, 4, 2, 5)
    assert ((wsum - want).abs() <= 2.0**-21 * want.abs()).all()
    tie = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11)])
    assert _tf32(tie).tolist() == [1.0 + 2.0**-10, -(1.0 + 2.0**-10)]


class _CountKernels(TorchDispatchMode):
    """The aten calls that launch a kernel (views, metadata changes and
    allocations do not)."""

    VIEWS = {"view", "_unsafe_view", "reshape", "permute", "expand", "select", "slice", "t",
             "unsqueeze", "as_strided", "alias", "detach", "empty"}

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name not in self.VIEWS:
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


def test_the_weight_split_costs_the_wrapper_a_fixed_count_of_torch_kernels():
    """pack_weights_f32 splits the weights on the device once per call. At a
    main-path shape (Cin a multiple of CK = 8, Cout of NS: no padding) it
    runs 6 torch kernels: the permuting copy into (k, n) order, TF32's
    integer rounding of hi (add, and) and lo's difference and rounding
    (sub, add, and), each written in place into the wgmma layout; a ragged
    Cin or Cout adds a pad, and Cin = 1 pads K to whole k steps in place of
    the copy."""
    for cin, cout, want in ((16, 16, 6), (32, 64, 6), (40, 20, 7), (1, 16, 6)):
        w = torch.zeros(3, 3, 3, cin, cout)
        with _CountKernels() as mode:
            conv3.pack_weights_f32(w)
        assert len(mode.ops) == want, mode.ops
