"""The fp32 training path of the port, on the CPU: how an fp32 train step
routes every op on the card (the fused DoubleConv where bf16 takes it, the
fp32 instances of kernels 1, 1-dx, 2, 3, 4, 5, 6, 8, 9, 11, 11-dx and
11-dw, the library for the deep region and every upconv), the launches'
descriptors against their sources' constants, the fp32 dW body's order of
sums, the plain fp32 step with the card's routing (and with every block on
the per-conv chain) against the JAX package's, cuDNN's TF32 off in the
steps' backward, and the wrappers' refusals.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there). Here the model runs on 'meta' tensors with the
launches faked, as tests/test_torch_fp32_eval.py does for the eval forward.

Tolerances: the dW partials summed in block order against the plain dW,
1e-6 of max |plain| (fp32 sums of at most a few thousand terms in another
order); the dW body's 3xTF32 arithmetic, emulated, 2e-6 of max |plain|
(the terms dropped by 3xTF32 are about 2^-22 of a product), and one TF32
pass above the card's 2e-5; the two train steps against JAX,
tests/test_torch_train.py's.
"""

from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
from multimodal_segmentation_project_tpu_torch.engine.steps import make_dann_step, make_train_step
from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator, UNet3D, unet3d
from multimodal_segmentation_project_tpu_torch.ops import conv3, conv3_fused, head, pool, upconv
from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn
from tests.test_torch_fp32_eval import _constants, _require_as_on_the_card, _source
from tests.test_torch_train import check_two_train_steps_against_jax

CSRC = Path(conv3.__file__).resolve().parent.parent / "csrc"
WIDTHS = (16, 32, 64, 128)  # the default widths, whose routing the card sees
# per train step at the default widths: the kernels' launches, and the
# library's convs and transpose convs in the forward
STEP = {
    torch.float32: ({"conv3x3x3_cf_stats_f32": 5, "conv3x3x3_cf_boundary_stats_f32": 5,
                     "conv3x3x3_cf_f32": 1, "conv3x3x3_cf_dx_f32": 5,
                     "conv3x3x3_cf_dx_epilogue_f32": 5, "conv3x3x3_cf_dw_f32": 6,
                     "conv3x3x3_cf_dw_prologue_f32": 5, "max_pool2x_cf_f32": 4,
                     "max_pool2x_cf_bwd_f32": 4, "head1x1_cf_f32": 1, "head1x1_cf_dx_f32": 1,
                     "head1x1_cf_dw_f32": 1},
                    {"conv3d": 7, "conv_transpose3d": 4}),
    torch.bfloat16: ({"conv3x3x3_cf_stats": 5, "conv3x3x3_cf_boundary_stats": 5, "conv3x3x3_cf": 1,
                      "conv3x3x3_cf_dx": 5, "conv3x3x3_cf_dx_epilogue": 5, "conv3x3x3_cf_dw": 6,
                      "conv3x3x3_cf_dw_prologue": 5, "max_pool2x_cf": 4, "max_pool2x_cf_bwd": 4,
                      "upconv2x_cf": 3, "head1x1_cf": 1, "head1x1_cf_dx": 1, "head1x1_cf_dw": 1},
                     {"conv3d": 7, "conv_transpose3d": 1}),
}
# the C entry points an fp32 step launches, and how often
F32_ENTRIES = {"mmseg_conv3_f32": 6, "mmseg_conv3_f32_stats": 5,
               "mmseg_conv3_f32_prologue_stats": 5, "mmseg_conv3_f32_dx_epilogue": 5,
               "mmseg_conv3_dw_f32": 6, "mmseg_conv3_dw_f32_prologue": 5, "mmseg_pool2x_f32": 4,
               "mmseg_pool2x_bwd_f32": 4, "mmseg_head1x1_f32": 1, "mmseg_head1x1_dx_f32": 1,
               "mmseg_head1x1_dw_f32": 1}
SMS = 132  # the H100's SM count, which the faked device properties report


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

    for module in (conv3, pool, head, upconv):  # conv3_fused launches through conv3.run
        monkeypatch.setattr(module, "run", fake_run)
    monkeypatch.setattr(ops._build, "require", _require_as_on_the_card)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=SMS))
    return calls


def _table(dtype: torch.dtype) -> tuple[Counter, Counter]:
    """The train step's kernel launches and library calls on the card, from
    the routing functions (DoubleConv.fused, conv3.supported, pool.route,
    upconv.route, head.route) and the model's widths."""
    model = UNet3D(features=WIDTHS)
    kernels, library = Counter(), Counter()
    suffix = "_f32" if dtype == torch.float32 else ""
    first = True  # the image's conv, whose input needs no gradient
    for block in (*model.encoder, model.bottleneck, *model.decoder):
        c0, c1 = block.double_conv[0], block.double_conv[4]
        if block.fused():
            kernels.update({f"conv3x3x3_cf_{k}{suffix}": 1 for k in (
                "stats", "boundary_stats", "dx_epilogue", "dw_prologue", "dw")})
            kernels[f"conv3x3x3_cf_dx{suffix}"] += not first
        else:
            for conv in (c0, c1):
                if not conv3.supported(conv.in_channels, conv.out_channels):
                    library["conv3d"] += 1
                    continue
                kernels[f"conv3x3x3_cf{suffix}"] += 1
                kernels[f"conv3x3x3_cf_dw{suffix}"] += 1
                kernels[f"conv3x3x3_cf_dx{suffix}"] += not first
                first = False
        first = False
    for c in WIDTHS:
        suffix = "_f32" if pool.route(dtype).endswith("_f32") else ""
        kernels[f"max_pool2x_cf{suffix}"] += 1
        kernels[f"max_pool2x_cf_bwd{suffix}"] += 1
    for up in model.upconvs:
        if upconv.route(dtype, up.out_channels) is None:
            library["conv_transpose3d"] += 1
        else:
            kernels["upconv2x_cf"] += 1
    suffix = "_f32" if head.route(dtype).endswith("_f32") else ""
    for name in ("head1x1_cf", "head1x1_cf_dx", "head1x1_cf_dw"):
        kernels[name + suffix] += 1
    return kernels, library


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_train_step_routes_every_op_as_the_table_says(dtype, faked_launches, monkeypatch):
    """A train-mode forward and backward at the default widths on the card
    path: both dtypes take the fused block in enc0-enc2, dec2 and dec3 and
    the per-conv chain in dec1 and the deep region; bf16 launches 46 of the
    port's kernels, fp32 the same table on the fp32 instances without kernel
    10 (43; the library's 7 convs and 4 transpose convs). The table from the
    routing functions, the counters, the launched entry points and the
    library's calls all agree."""
    kernels, library = STEP[dtype]
    table, lib_table = _table(dtype)
    assert (table, lib_table) == (Counter(kernels), Counter(library))
    assert sum(kernels.values()) == (43 if dtype == torch.float32 else 46)

    lib_calls = Counter()

    class Counting:
        def __getattr__(self, name):
            fn = getattr(F, name)
            if name not in ("conv3d", "conv_transpose3d"):
                return fn

            def call(*args, **kwargs):
                lib_calls[name] += 1
                return fn(*args, **kwargs)
            return call

    monkeypatch.setattr(unet3d, "F", Counting())
    per_conv = []
    real = unet3d.DoubleConv.forward_train_per_conv
    monkeypatch.setattr(unet3d.DoubleConv, "forward_train_per_conv",
                        lambda self, *a: per_conv.append(self) or real(self, *a))
    model = UNet3D(features=WIDTHS, dtype=dtype, dropout_rate=0.0).to("meta").train()
    logits = model(torch.empty(1, 1, 32, 32, 32, device="meta"))
    assert logits.shape == (1, 4, 32, 32, 32) and logits.dtype == torch.float32
    logits.sum().backward()
    assert {k: n for k, n in ops.launch_counts().items() if n} == kernels
    if dtype == torch.float32:  # dec1's forward and the dx share the fp32 body's entry
        assert Counter(c.entry for c in faked_launches) == F32_ENTRIES
    assert len(per_conv) == 4  # dec1 and the deep region
    assert dict(lib_calls) == library
    assert all(p.grad is not None for p in model.parameters())


def test_the_fused_block_is_chosen_by_width_alone():
    """The fused block is a matter of widths only: an fp32 block of two
    convs <= 64 wide takes it on the CPU and on the card alike (its fp32
    instances exist), a block with a wider conv never does."""
    assert unet3d.DoubleConv(16, 16).fused() and unet3d.DoubleConv(64, 32).fused()
    assert not unet3d.DoubleConv(64, 128).fused()  # the deep region
    assert not unet3d.DoubleConv(128, 64).fused()  # dec1
    for device in ("cpu", "meta"):
        block = unet3d.DoubleConv(4, 8).to(device).train()
        taken = []
        block.forward_train_fused = lambda *a, **k: taken.append(device) or a[0]
        block.forward_train_per_conv = lambda *a, **k: pytest.fail("per-conv chain taken")
        block.forward_train(torch.empty(1, 4, 4, 8, 16, device=device), torch.float32)
        assert taken == [device]


# ---- the new launches against their sources ---------------------------------------

# the fp32 train step's convs at 192^3 (Cin, Cout, S), and ragged ones
CONV_CASES = [(1, 16, 192), (16, 16, 192), (16, 32, 96), (32, 32, 96), (32, 64, 48),
              (64, 64, 48), (64, 32, 96), (32, 16, 192), (3, 8, 7), (40, 20, 9), (20, 48, 5)]


@pytest.mark.parametrize("cin,cout,s", CONV_CASES)
def test_the_fp32_training_conv_and_its_dx_launch_as_the_source_says(cin, cout, s,
                                                                     faked_launches):
    """Kernel 1's fp32 forward (bias) and its dx (flipped weights, no bias)
    take the fp32 body's one entry, mmseg_conv3_f32, with the fp32 body's
    descriptor (tests/test_torch_fp32_eval.py holds it against
    csrc/conv3_f32.cu's constants) for their own Cin and Cout."""
    source = (CSRC / "conv3_f32.cu").read_text()
    assert "enum Epilogue { kBiasRelu = 0, kCastBias = 1, kBiasStats = 2, kDxMask = 3 };" in source
    assert "dispatch<kCastBias, false>" in source
    x = torch.empty(2, cin, s, s + 1, s, device="meta")
    g = torch.empty(2, cout, s, s + 1, s, device="meta")
    w, b = torch.empty(3, 3, 3, cin, cout, device="meta"), torch.empty(cout, device="meta")
    fwd, dx = conv3.conv_f32_call(x, w, b), conv3.dx_f32_call(g, w)
    assert fwd.entry == dx.entry == "mmseg_conv3_f32"
    assert fwd.args[10:] == conv3.f32_launch_dims(tuple(x.shape), cout)
    assert dx.args[10:] == conv3.f32_launch_dims(tuple(g.shape), cin)
    assert fwd.args[2] is not None and dx.args[2] is None  # the dx has no bias
    assert fwd.args[4:10] == (2, cin, cout, s, s + 1, s)
    assert dx.args[4:10] == (2, cout, cin, s, s + 1, s)
    assert dx.result.shape == x.shape and dx.result.dtype == torch.float32
    assert dx.tensors[1].shape[-1] == -(-cin // 16) * 16  # the packed flip_transpose(w)


@pytest.mark.parametrize("cin,cout,s", CONV_CASES)
def test_the_fp32_dw_launch_is_the_sources(cin, cout, s, faked_launches):
    """Grid (nblk, ceil(Cin / CIB), ceil(Cout / COB)) with nblk one wave of
    one block an SM over the channel blocks, DW_THREADS threads (DW_WARPS
    warps), the hi and lo planes of CIB input channels (CP floats each) and
    16 or COB cotangent channels (GP floats each), two raw stages and their
    mbarriers in shared memory, and an fp32 scratch of one (27, Cin, Cout)
    partial per block row: from the constants of csrc/conv3_dw_f32.cu."""
    k = _constants("conv3_dw_f32.cu")
    assert (k["CIB"], k["COB"], k["DW_THREADS"], k["CP"], k["GP"], k["RAW_PITCH"]) == (
        conv3.DW_F32_CI, conv3.DW_F32_CO, conv3.DW_F32_THREADS, conv3.DW_F32_CP,
        conv3.DW_F32_GP, conv3.DW_F32_RAW_PITCH)
    assert (k["DTD"], k["DTH"], k["DTW"]) == conv3.DW_F32_TILE
    assert k["DW_THREADS"] == 32 * k["DW_WARPS"]
    source = _source("conv3_dw_f32.cu")
    for line in ("ROWS_OUT = DTD * DTH", "KSTEPS = 2 * ROWS_OUT", "XROWS = (DTD + 2) * DHR",
                 "XW = DTW + 2", "VOX = ROWS_OUT * DTW", "XPLANE = CIB * CP",
                 "RX_FLOATS = CIB * XROWS * RAW_PITCH", "COUT = 16 * MW",
                 "GPLANE = COUT * GP", "GHI = 2 * XPLANE", "PLANES = GHI + 2 * GPLANE",
                 "RG = RX_FLOATS", "RAT = RG + COUT * VOX", "STAGE = RAT + 2 * CIB",
                 "BAR = PLANES + 2 * STAGE", "FLOATS = BAR + 4", "BYTES = FLOATS * 4"):
        assert f" {line};" in source
    assert "int m_tiles(int cout) { return cout <= 16 ? 1 : 2; }" in source
    x = torch.empty(1, cin, s, s, s + 2, device="meta")
    g = torch.empty(1, cout, s, s, s + 2, device="meta")
    call = conv3.dw_f32_call(x, g)
    cb, cz = -(-cin // k["CIB"]), -(-cout // k["COB"])
    nblk = max(1, SMS // (cb * cz))
    cout16 = 16 if cout <= 16 else k["COB"]
    xrows = (k["DTD"] + 2) * (k["DTH"] + 2)
    stage = (k["CIB"] * xrows * k["RAW_PITCH"] + cout16 * k["DTD"] * k["DTH"] * k["DTW"]
             + 2 * k["CIB"])
    floats = 2 * (k["CIB"] * k["CP"] + cout16 * k["GP"]) + 2 * stage + 4
    assert call.entry == "mmseg_conv3_dw_f32"
    assert call.args[4:] == (1, cin, cout, s, s, s + 2, nblk, cb, cz, k["DW_THREADS"],
                             4 * floats)
    assert call.args[-1] <= 227 * 1024
    partial = call.tensors[2]
    assert partial.shape == (nblk * 27 * cin * cout,) and partial.dtype == torch.float32
    assert call.result.shape == (3, 3, 3, cin, cout)


@pytest.mark.parametrize("shape", [(1, 16, 192, 192, 192), (1, 128, 24, 24, 24),
                                   (2, 3, 5, 7, 9)])
def test_the_fp32_pool_backward_launch_is_the_sources(shape, faked_launches):
    threads = _constants("pool2x.cu")["THREADS"]
    b, c, d, h, w = shape
    pooled = (b, c, d // 2, h // 2, w // 2)
    x = torch.empty(shape, device="meta")
    call = pool.bwd_f32_call(x, torch.empty(pooled, device="meta"),
                             torch.empty(pooled, device="meta"))
    n = b * c * (d // 2) * (h // 2) * (w // 2)
    assert call.entry == "mmseg_pool2x_bwd_f32"
    assert call.args[4:] == (b, c, d, h, w, -(-n // threads), threads)
    assert call.result.shape == shape and call.result.dtype == torch.float32


@pytest.mark.parametrize("b,cf,co,s", [(1, 16, 4, 192), (2, 40, 3, 7), (1, 64, 8, 3),
                                       (2, 5, 1, 9)])
def test_the_fp32_head_backward_launches_are_the_sources(b, cf, co, s, faked_launches):
    """The dx: a thread per 8 voxels of one batch element, THREADS a block.
    The weight gradient: nblk one block an SM (at most one per THREADS
    groups), and dw_slice<float>(NC) feature channels a block row, half
    the bf16 slice."""
    k = _constants("head1x1.cu")
    source = (CSRC / "head1x1.cu").read_text()
    assert "constexpr int dw_slice_bf16(int nc) { return nc <= 4 ? 16 : nc <= 6 ? 8 : 4; }" in source
    assert "return dw_slice_bf16(nc) / int(sizeof(T) / 2);" in source
    for n in range(1, 9):
        bf16 = 16 if n <= 4 else 8 if n <= 6 else 4
        assert (head.dw_slice(n, torch.bfloat16), head.dw_slice(n, torch.float32)) == (
            bf16, bf16 // 2)
    v = s * s * (s + 1)
    groups = b * -(-v // k["VOX"])
    ct = torch.empty(b, co, s, s, s + 1, device="meta")
    dx = head.dx_f32_call(ct, torch.empty(cf, co, device="meta"))
    assert dx.entry == "mmseg_head1x1_dx_f32"
    assert dx.args[3:] == (b, co, cf, v, -(-groups // k["THREADS"]), k["THREADS"])
    assert dx.result.shape == (b, cf, s, s, s + 1) and dx.result.dtype == torch.float32
    dw = head.dw_f32_call(torch.empty(b, cf, s, s, s + 1, device="meta"), ct)
    nblk = max(1, min(SMS, -(-groups // k["THREADS"])))
    assert dw.entry == "mmseg_head1x1_dw_f32"
    assert dw.args[5:] == (b, cf, co, v, nblk, -(-cf // head.dw_slice(co, torch.float32)),
                           k["THREADS"])
    assert dw.tensors[2].shape == (nblk * (cf * co + co),)


# ---- the fp32 dW body's order of sums ------------------------------------------------

DW_TOL_3XTF32 = 2e-6  # the emulated 3xTF32 body against the plain dW, of max |plain|
F32_TOL = 2e-5        # every fp32 output's bound on the card (chip_smoke.py)


def _tiled(x, g):
    """x's 27 shifted copies and g, cut into the fp32 dW body's k steps:
    X (tiles, 18, 8, 27, Cin) and G (tiles, 18, 8, Cout), tiles in the
    kernel's walk order (W fastest, then H, D, the batch), k step ks = 2 r +
    h of output row r = 3 od + oh, voxel 8 h + k of it; zero outside the
    volume (the halo of x, the padding of the last tiles)."""
    bsz, cin, d, h, w = x.shape
    cout = g.shape[1]
    td, th, tw = conv3.DW_F32_TILE
    nd, nh, nw = -(-d // td), -(-h // th), -(-w // tw)
    dp, hp, wp = nd * td, nh * th, nw * tw
    xp = F.pad(x, (1, 1 + wp - w, 1, 1 + hp - h, 1, 1 + dp - d))
    gp = F.pad(g, (0, wp - w, 0, hp - h, 0, dp - d))
    taps = torch.stack([xp[:, :, kd:kd + dp, kh:kh + hp, kw:kw + wp]
                        for kd in range(3) for kh in range(3) for kw in range(3)], dim=-1)
    xt = taps.reshape(bsz, cin, nd, td, nh, th, nw, 2, 8, 27).permute(0, 2, 4, 6, 3, 5, 7, 8, 9, 1)
    gt = gp.reshape(bsz, cout, nd, td, nh, th, nw, 2, 8).permute(0, 2, 4, 6, 3, 5, 7, 8, 1)
    n = bsz * nd * nh * nw
    return xt.reshape(n, 2 * td * th, 8, 27, cin), gt.reshape(n, 2 * td * th, 8, cout)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 does: to 10 mantissa bits,
    to nearest, ties away from zero (in int32 bit operations)."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def emulate_dw_f32(x: torch.Tensor, g: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """conv3_dw_f32.cu's arithmetic on the CPU -> (3, 3, 3, Cin, Cout). Each
    operand split once, hi = tf32(v), lo = tf32(v - hi); per k step of 8
    voxels, a fragment from zero adds lo_g hi_x, then hi_g lo_x, then hi_g
    hi_x, the 8 exact products of each in voxel order, in fp32 (passes = 1:
    hi_g hi_x alone, one TF32 pass); each warp adds its k steps' fragments
    to its accumulators in order, tile after tile (block k takes tiles k, k
    + nblk, ...; warp kp of a job the k steps kp, kp + 18 / J, ..., J jobs
    as the kernel counts them); a job's warps add in warp order; the reduce
    adds the nblk partials in block order. The tensor core's own order
    inside an MMA is not emulated: only the sums around it."""
    cin, cout = x.shape[1], g.shape[1]
    nblk = conv3.dw_f32_launch_dims(None, tuple(x.shape), cout)[0]
    mw = 1 if cout <= 16 else 2  # m16 tiles of a block's output channels
    jobs = (1 if cin == 1 else 9) * mw
    ksplit = 18 // jobs
    xt, gt = _tiled(x.float(), g.float())
    xh, gh = _tf32(xt), _tf32(gt)
    xl, gl = _tf32(xt - xh), _tf32(gt - gh)
    pairs = [(gl, xh), (gh, xl), (gh, xh)][3 - passes:]
    frag = torch.zeros(*xt.shape[:2], 27, cin, cout)  # (tiles, 18, 27, Cin, Cout)
    for gs, xs in pairs:
        for k in range(8):
            frag = frag + xs[:, :, k, :, :, None] * gs[:, :, k, None, None, :]
    rounds = -(-frag.shape[0] // nblk)
    frag = F.pad(frag, (0, 0, 0, 0, 0, 0, 0, 0, 0, rounds * nblk - frag.shape[0]))
    frag = frag.reshape(rounds, nblk, 18, 27, cin, cout)
    acc = torch.zeros(nblk, ksplit, 27, cin, cout)
    for r in range(rounds):
        for i in range(18 // ksplit):
            acc = acc + frag[r, :, i * ksplit:(i + 1) * ksplit]
    part = acc[:, 0]
    for kp in range(1, ksplit):
        part = part + acc[:, kp]
    dw = part[0]
    for blk in range(1, nblk):
        dw = dw + part[blk]
    return dw.reshape(3, 3, 3, cin, cout)


@pytest.mark.parametrize("shape,cout,sms", [((2, 5, 6, 10, 20), 9, 10), ((1, 1, 5, 9, 17), 16, 3),
                                            ((1, 8, 4, 8, 16), 8, 132)])
def test_the_fp32_dw_partials_summed_in_block_order_reproduce_the_plain_dw(
        shape, cout, sms, monkeypatch):
    """Block k of the fp32 dW walks the output tiles k, k + nblk, ... (of
    DW_F32_TILE voxels, W fastest, then H, D, the batch) and sums each
    tile's products of the zero-haloed input and the cotangent (zero
    outside the volume); the reduce adds the nblk partials in block order.
    That order, with nblk as the wrapper picks it, reproduces
    conv3x3x3_cf_dw_reference (held against the JAX package in
    tests/test_torch_train_ops.py) within 1e-6 of its max; the blocks that
    get no tile add zeros."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=sms))
    rng = np.random.default_rng(sum(shape) + cout)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(shape[0], cout, *shape[2:])).astype(np.float32))
    cin = shape[1]
    nblk = conv3.dw_f32_launch_dims(None, shape, cout)[0]
    assert nblk == max(1, sms // (-(-cin // conv3.DW_F32_CI) * -(-cout // conv3.DW_F32_CO)))
    xt, gt = _tiled(x, g)
    partials = torch.zeros(nblk, 27, cin, cout)
    for tile in range(xt.shape[0]):
        partials[tile % nblk] += torch.einsum("skti,sko->tio", xt[tile], gt[tile])
    got = partials[0]
    for k in range(1, nblk):
        got = got + partials[k]
    want = conv3.conv3x3x3_cf_dw_reference(x, g).reshape(27, cin, cout)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


DW_EMULATION_CASES = [((2, 5, 6, 10, 20), 9, 10), ((1, 1, 5, 9, 17), 16, 3),
                      ((2, 1, 4, 7, 23), 20, 7), ((1, 16, 4, 6, 33), 16, 5),
                      ((2, 5, 3, 5, 37), 64, 4), ((1, 20, 3, 4, 9), 48, 132)]


@pytest.mark.parametrize("shape,cout,sms", DW_EMULATION_CASES)
def test_the_fp32_dw_in_3xtf32_reproduces_the_plain_dw(shape, cout, sms, monkeypatch):
    """The fp32 dW body's 3xTF32 arithmetic, emulated (emulate_dw_f32: the
    hi/lo split, the three products in the kernel's order, the fragments'
    fp32 sums in its tiling's order, the block-order reduce), reproduces
    conv3x3x3_cf_dw_reference within DW_TOL_3XTF32 = 2e-6 of its max, a
    tenth of the card's fp32 bound, at ragged shapes: Cin 1, 5, 16 and 20
    (two channel blocks), Cout 9, 16, 20, 48 and 64 (one and two m16 tiles
    a block, one and two blocks of output channels), W not a multiple of
    16, batch 2, K split over 1, 2, 9 or 18 warps."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=sms))
    rng = np.random.default_rng(3 * sum(shape) + cout)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(shape[0], cout, *shape[2:])).astype(np.float32))
    want = conv3.conv3x3x3_cf_dw_reference(x, g)
    err = float((emulate_dw_f32(x, g) - want).abs().max()) / float(want.abs().max())
    assert err <= DW_TOL_3XTF32, err


@pytest.mark.parametrize("shape,cout,sms", DW_EMULATION_CASES)
def test_one_tf32_pass_misses_the_fp32_bound(shape, cout, sms, monkeypatch):
    """The control: the same emulation with hi_g hi_x alone (one TF32 pass)
    reads above F32_TOL = 2e-5 of max |plain| at every shape, so that the
    test above tells a 3xTF32 sum from a 1xTF32 one."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=sms))
    rng = np.random.default_rng(3 * sum(shape) + cout)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(shape[0], cout, *shape[2:])).astype(np.float32))
    want = conv3.conv3x3x3_cf_dw_reference(x, g)
    err = float((emulate_dw_f32(x, g, passes=1) - want).abs().max()) / float(want.abs().max())
    assert err > F32_TOL, err


# ---- the plain fp32 step on the per-conv chain against JAX ----------------------------


def test_two_fp32_train_steps_on_the_per_conv_chain_match_jax(monkeypatch):
    """tests/test_torch_train.py's two steps against the JAX package's fp32
    make_train_step (which holds the fused block), with every DoubleConv on
    the per-conv chain: the JAX package's data-mesh configuration, which the
    port runs for dec1 and the deep region, at that test's bounds."""
    monkeypatch.setattr(unet3d.DoubleConv, "fused", lambda self: False)
    per_conv = []
    real = unet3d.DoubleConv.forward_train_per_conv
    monkeypatch.setattr(unet3d.DoubleConv, "forward_train_per_conv",
                        lambda self, *a: per_conv.append(self) or real(self, *a))
    monkeypatch.setattr(unet3d.DoubleConv, "forward_train_fused", lambda *a: pytest.fail(
        "a fused block ran on the per-conv chain's routing"))
    check_two_train_steps_against_jax()
    assert len(per_conv) == 2 * 5  # two steps, five DoubleConvs at two levels


# ---- cuDNN's TF32 in the steps' backward ---------------------------------------------


def _recording_loss(seen: list):
    """ce_tversky with a hook on the logits that records cuDNN's TF32 flag
    while the backward runs."""
    real = get_loss_fn("ce_tversky")

    def loss(logits, labels):
        logits.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32))
        return real(logits, labels)
    return loss


def _tiny_batch(seed: int):
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(1, 1, 8, 8, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, size=(1, 8, 8, 8)).astype(np.int32))
    return images, labels


@pytest.mark.parametrize("dtype,want", [(torch.float32, False), (torch.bfloat16, True)],
                         ids=["fp32", "bf16"])
def test_the_steps_backward_runs_with_cudnn_tf32_off_in_fp32(dtype, want):
    """loss.backward() of a train step and total.backward() of a DANN step
    see cuDNN's TF32 off in fp32 (the deep region's and the fp32 upconvs'
    cuDNN backward on the card), and as they found it in bf16; the flag and
    cuDNN's other flags read as before once the step returns."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled)
    assert flags[0]  # PyTorch's default, which the fp32 scope must turn off
    seen = []
    model = UNet3D(features=(4, 8), dtype=dtype, generator=torch.Generator().manual_seed(0))
    state = TrainState(model, 1e-3, 1e-4)
    images, labels = _tiny_batch(0)
    make_train_step(_recording_loss(seen))(state, images, labels)
    assert seen == [want]
    disc = TrainState(DomainDiscriminator(16, generator=torch.Generator().manual_seed(1)),
                      1e-3, 1e-4)
    step = make_dann_step(_recording_loss(seen), 0.2)
    step(state, disc, images, labels, _tiny_batch(1)[0], torch.Generator().manual_seed(2))
    assert seen == [want, want]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled) == flags


# ---- refusals ------------------------------------------------------------------------


def test_the_fp32_training_wrappers_refuse_what_their_kernels_do_not_take(faked_launches):
    meta = {"device": "meta"}
    bf16 = torch.empty(1, 16, 4, 8, 16, dtype=torch.bfloat16, **meta)
    x = torch.empty(1, 16, 4, 8, 16, **meta)
    w, b = torch.empty(3, 3, 3, 16, 16, **meta), torch.empty(16, **meta)
    for call, args in ((conv3.conv_f32_call, (bf16, w, b)), (conv3.dx_f32_call, (bf16, w)),
                       (conv3.dw_f32_call, (bf16, x)), (conv3.dw_f32_call, (x, bf16)),
                       (pool.bwd_f32_call, (bf16, bf16[..., ::2, ::2, ::2], x[..., ::2, ::2,
                                                                                ::2])),
                       (head.dx_f32_call, (bf16[:, :4], torch.empty(16, 4, **meta))),
                       (head.dw_f32_call, (bf16, x[:, :4]))):
        with pytest.raises(TypeError, match="takes torch.float32"):
            call(*args)
    with pytest.raises(ValueError, match="Cin, Cout <= 64"):
        conv3.conv_f32_call(torch.empty(1, 65, 4, 8, 16, **meta),
                            torch.empty(3, 3, 3, 65, 16, **meta), b)
    with pytest.raises(ValueError, match="Cin, Cout <= 64"):
        conv3.dx_f32_call(torch.empty(1, 65, 4, 8, 16, **meta),
                          torch.empty(3, 3, 3, 16, 65, **meta))
    with pytest.raises(ValueError, match="Cin, Cout <= 64"):
        conv3.dw_f32_call(x, torch.empty(1, 65, 4, 8, 16, **meta))
    with pytest.raises(ValueError, match="does not match"):
        conv3.dw_f32_call(x, torch.empty(1, 16, 4, 8, 8, **meta))
    with pytest.raises(ValueError, match="contiguous"):
        conv3.dw_f32_call(x.transpose(3, 4), x.transpose(3, 4))
    with pytest.raises(ValueError, match="must be"):
        pool.bwd_f32_call(x, torch.empty(1, 16, 2, 4, 4, **meta), torch.empty(1, 16, 2, 4, 8,
                                                                             **meta))
    with pytest.raises(ValueError, match="1..8 classes"):
        head.dx_f32_call(torch.empty(1, 9, 4, 8, 16, **meta), torch.empty(16, 9, **meta))
    with pytest.raises(ValueError, match="1..64 channels"):
        head.dx_f32_call(torch.empty(1, 4, 4, 8, 16, **meta), torch.empty(65, 4, **meta))
    with pytest.raises(ValueError, match="1..64 channels"):
        head.dw_f32_call(torch.empty(1, 65, 4, 8, 16, **meta), x[:, :4].contiguous())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        head.head1x1_cf_dx(x[:, :4].contiguous(), torch.empty(16, 4, **meta), torch.float16)
    assert faked_launches == []


def test_an_fp32_conv_on_the_card_never_runs_a_plain_version(faked_launches, monkeypatch):
    """The training conv's forward, dx and dW, and the fused DoubleConv's
    three ops forward and backward, on an fp32 device tensor launch the fp32
    kernels (a bf16 one the bf16 kernels), never the plain versions."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on a device tensor")

    for name in ("conv3x3x3_cf_reference", "conv3x3x3_cf_dx_reference",
                 "conv3x3x3_cf_dw_reference", "conv_fp32"):
        monkeypatch.setattr(conv3, name, refuse)
    for name in ("prologue_reference", "conv3x3x3_cf_stats_reference",
                 "conv3x3x3_cf_boundary_stats_reference", "conv3x3x3_cf_boundary_reference",
                 "conv3x3x3_cf_dx_epilogue_reference", "conv3x3x3_cf_dw_prologue_reference"):
        monkeypatch.setattr(conv3_fused, name, refuse)
    for dtype, body, dw in ((torch.float32, "mmseg_conv3_f32", "mmseg_conv3_dw_f32"),
                            (torch.bfloat16, "mmseg_conv3", "mmseg_conv3_dw")):
        faked_launches.clear()
        x = torch.empty(1, 16, 4, 8, 16, dtype=dtype, device="meta", requires_grad=True)
        w = torch.empty(3, 3, 3, 16, 16, device="meta", requires_grad=True)
        b = torch.empty(16, device="meta", requires_grad=True)
        a = torch.empty(1, 16, device="meta", requires_grad=True)
        t = torch.empty(1, 16, device="meta", requires_grad=True)
        for op in (lambda: conv3_fused.conv3x3x3_cf_stats(x, w, b),
                   lambda: conv3_fused.conv3x3x3_cf_boundary_stats(x, w, b, a, t),
                   lambda: (conv3_fused.conv3x3x3_cf_boundary(x, w, b, a, t),)):
            sum(o.float().sum() for o in op()).backward()
        assert [c.entry for c in faked_launches] == [
            f"{body}_stats", body, dw, f"{body}_prologue_stats", f"{body}_dx_epilogue",
            f"{dw}_prologue", f"{body}_prologue", f"{body}_dx_epilogue", f"{dw}_prologue"]
        assert x.grad.dtype == dtype and a.grad.shape == a.shape
    for dtype, want in ((torch.float32, ["mmseg_conv3_f32", "mmseg_conv3_f32",
                                         "mmseg_conv3_dw_f32"]),
                        (torch.bfloat16, ["mmseg_conv3", "mmseg_conv3", "mmseg_conv3_dw"])):
        faked_launches.clear()
        x = torch.empty(1, 16, 4, 8, 16, dtype=dtype, device="meta", requires_grad=True)
        w = torch.empty(3, 3, 3, 16, 32, device="meta", requires_grad=True)
        b = torch.empty(32, device="meta", requires_grad=True)
        conv3.conv3x3x3_cf(x, w, b).float().sum().backward()
        assert [c.entry for c in faked_launches] == want
        assert x.grad.dtype == dtype and w.grad.shape == w.shape
