"""The fp32 eval path of the port, on the CPU: how the fp32 and bf16 eval
forwards route every op (the card's kernel entry points or the library),
the fp32 instances' launch descriptors against their sources' constants,
the wrappers' refusals, the device policy of the CLIs, and the plain fp32
forward with the upconv routed as on the card against the JAX package.

The kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there). Here the model runs on 'meta'
tensors with the launches faked, so that every wrapper takes the path it
takes on the card and builds its launch, and nothing is computed.

Tolerance: the plain fp32 forward against JAX's fp32 UNet3D, max |port -
jax| <= 2e-5 * max |jax| (sum order and the BatchNorm fold only, as
tests/test_torch_unet.py).
"""

import re
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.models import UNet3D, unet3d
from multimodal_segmentation_project_tpu_torch.ops import _build, conv3, head, pool, upconv
from multimodal_segmentation_project_tpu_torch.workloads import (
    common,
    distill_unet,
    finetune_ct,
    main,
    test_model,
    train_dann,
    train_unet,
)
from tests.test_torch_unet import _close, _jax_weights, _port

CSRC = Path(conv3.__file__).resolve().parent.parent / "csrc"
WIDTHS = (16, 32, 64, 128)  # the default widths, whose routing the card sees
# per eval forward at the default widths: the kernels' launches and the
# library's convs and transpose convs
FORWARD = {
    torch.float32: ({"conv3x3x3_cf_relu_f32": 11, "max_pool2x_cf_f32": 4, "head1x1_cf_f32": 1},
                    {"conv3d": 7, "conv_transpose3d": 4}),
    torch.bfloat16: ({"conv3x3x3_cf_relu": 11, "max_pool2x_cf": 4, "upconv2x_cf": 3,
                      "head1x1_cf": 1}, {"conv3d": 7, "conv_transpose3d": 1}),
}
ENTRY_OP = {"mmseg_conv3_f32_bias_relu": "conv3x3x3_cf_relu_f32",
            "mmseg_conv3_bias_relu": "conv3x3x3_cf_relu", "mmseg_pool2x_f32": "max_pool2x_cf_f32",
            "mmseg_pool2x": "max_pool2x_cf", "mmseg_upconv_d2s": "upconv2x_cf",
            "mmseg_head1x1_f32": "head1x1_cf_f32", "mmseg_head1x1": "head1x1_cf"}


def _constants(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}


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

    for module in (conv3, pool, head, upconv):
        monkeypatch.setattr(module, "run", fake_run)
    monkeypatch.setattr(_build, "require", _require_as_on_the_card)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    return calls


_real_require = _build.require


class _OnTheCard:
    """A 'meta' tensor as _build.require sees a CUDA one."""

    def __init__(self, t):
        self.t, self.device = t, SimpleNamespace(type="cuda")

    def __getattr__(self, name):
        return getattr(self.t, name)


def _require_as_on_the_card(name, t, dtype, ndim):
    _real_require(name, _OnTheCard(t), dtype, ndim)


def _routes(dtype: torch.dtype) -> list:
    """The eval forward's table, from the routing functions: (op, dtype, Cin,
    Cout) -> the entry point the card launches, or 'library'."""
    model = UNet3D(features=WIDTHS)
    rows = []
    for block in (*model.encoder, model.bottleneck, *model.decoder):
        for conv in (block.double_conv[0], block.double_conv[4]):
            cin, cout = conv.in_channels, conv.out_channels
            rows.append(("conv", cin, cout, conv3.eval_route(dtype, cin, cout) or "library"))
    rows += [("pool", c, c, pool.route(dtype)) for c in WIDTHS]
    rows += [("upconv", up.in_channels, up.out_channels,
              upconv.route(dtype, up.out_channels) or "library") for up in model.upconvs]
    rows.append(("head", WIDTHS[0], 4, head.route(dtype)))
    return rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_eval_forward_routes_every_op_as_the_table_says(dtype, faked_launches,
                                                            monkeypatch):
    """18 convs, 4 pools, 4 upconvs and the head: the table's kernel entries
    are the launches of one eval forward on the card path, exactly, and its
    library rows are the library's calls."""
    rows = _routes(dtype)
    assert Counter(op for op, *_ in rows) == {"conv": 18, "pool": 4, "upconv": 4, "head": 1}
    kernels, library = FORWARD[dtype]
    table = Counter(ENTRY_OP[entry] for *_, entry in rows if entry != "library")
    assert table == kernels
    lib_rows = Counter(op for op, *_, entry in rows if entry == "library")
    assert lib_rows == {"conv": library["conv3d"], "upconv": library["conv_transpose3d"]}

    lib_calls = Counter()

    class Counting:
        def __getattr__(self, name):
            fn = getattr(F, name)
            if name not in library:
                return fn

            def call(*args, **kwargs):
                lib_calls[name] += 1
                return fn(*args, **kwargs)
            return call

    monkeypatch.setattr(unet3d, "F", Counting())
    model = UNet3D(features=WIDTHS, dtype=dtype).to("meta").eval()
    with torch.inference_mode():
        logits = model(torch.empty(1, 1, 32, 32, 32, device="meta"))
    assert logits.shape == (1, 4, 32, 32, 32) and logits.dtype == torch.float32
    assert Counter(ENTRY_OP[c.entry] for c in faked_launches) == kernels
    assert {k: n for k, n in ops.launch_counts().items() if n} == kernels
    assert dict(lib_calls) == library
    # the fp32 path's library calls run with cuDNN's TF32 off; nothing else changes
    assert torch.backends.cudnn.allow_tf32


def test_an_fp32_forward_turns_cudnn_tf32_off_and_back(monkeypatch):
    seen = []

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return F.conv3d(*args, **kwargs)

    monkeypatch.setattr(unet3d, "F", SimpleNamespace(
        conv3d=spy, conv_transpose3d=F.conv_transpose3d, interpolate=F.interpolate))
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    for dtype, want in ((torch.float32, False), (torch.bfloat16, True)):
        seen.clear()
        with torch.inference_mode():
            UNet3D(features=(8, 16, 32, 64), dtype=dtype).eval()(torch.randn(1, 1, 16, 16, 16))
        assert seen and set(seen) == {want}
        assert torch.backends.cudnn.allow_tf32
        assert (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic) == flags


def test_the_plain_fp32_forward_with_the_cards_upconv_routing_matches_jax(monkeypatch):
    """JAX's fp32 UNet3D (its fp32 upconv an XLA einsum; XLA convs, where
    tests/test_torch_unet.py takes its Pallas ones at this size) against
    the port's plain fp32 forward with the upconvs routed as on the card:
    the library's transpose conv in fp32 (on the CPU the model routes them
    to the op's plain version, the einsum)."""
    jmodel, params, stats = _jax_weights("xla", seed=11)
    x = np.random.default_rng(12).normal(size=(1, 1, 16, 16, 16)).astype(np.float32)
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)

    def refuse(*a, **k):
        raise AssertionError("the upconv kernel's op ran in an fp32 forward")

    transposed = []

    def conv_transpose3d(x, w, b, stride):
        transposed.append((x.dtype, w.dtype))
        return F.conv_transpose3d(x, w, b, stride=stride)

    monkeypatch.setattr(unet3d.upconv, "runs_op",
                        lambda x, cout: upconv.route(x.dtype, cout) is not None)
    monkeypatch.setattr(unet3d.upconv, "upconv2x_cf", refuse)
    monkeypatch.setattr(unet3d, "F", SimpleNamespace(conv3d=F.conv3d, interpolate=F.interpolate,
                                                     conv_transpose3d=conv_transpose3d))
    with torch.inference_mode():
        got = _port(params, stats)(torch.from_numpy(x))
    assert transposed == [(torch.float32, torch.float32)] * 2  # both upconvs, (4, 8) widths
    _close(got.numpy(), want)


# ---- the fp32 instances' launches against their sources ----------------------------


# the eval forward's fp32 convs at 192^3 (Cin, Cout, S), and ragged ones
CONV_CASES = [(1, 16, 192), (16, 16, 192), (16, 32, 96), (32, 32, 96), (32, 64, 48),
              (64, 64, 48), (64, 32, 96), (32, 16, 192), (3, 8, 7), (40, 20, 9), (64, 48, 5)]


@pytest.mark.parametrize("cin,cout,s", CONV_CASES)
def test_the_fp32_conv_launch_is_the_sources(cin, cout, s, faked_launches):
    """Grid (a block per TD x TH x TW output tile), THREADS threads, and the
    ring's dynamic shared memory (two stages where there is more than one
    chunk of CK input channels: each CK staged tiles of (TD + 2) (TH + 2)
    rows of PITCH floats, and CK x 27 x Cout16 weights), from the
    constants of csrc/conv3_f32.cu; the packed weights are its chunks."""
    k = _constants("conv3_f32.cu")
    assert (k["TD"], k["TH"], k["TW"]) == conv3.F32_TILE
    assert (k["CK"], k["PITCH"], k["THREADS"]) == (conv3.F32_CK, conv3.F32_PITCH,
                                                   conv3.F32_THREADS)
    source = (CSRC / "conv3_f32.cu").read_text()
    assert all(f"constexpr int {line};" in source
               for line in ("DR = TD + 2", "HR = TH + 2", "ROWS = DR * HR"))
    rows = (k["TD"] + 2) * (k["TH"] + 2)
    shape = (2, cin, s, s + 1, s)
    x = torch.empty(shape, device="meta")
    w, b = torch.empty(3, 3, 3, cin, cout, device="meta"), torch.empty(cout, device="meta")
    call = conv3.relu_f32_call(x, w, b)
    nchunks, cout16 = -(-cin // k["CK"]), -(-cout // 16) * 16
    stage = k["CK"] * (rows * k["PITCH"] + 27 * cout16) * 4
    grid = (-(-s // k["TW"]) * -(-(s + 1) // k["TH"]), -(-s // k["TD"]), 2)
    assert call.entry == "mmseg_conv3_f32_bias_relu"
    assert call.args[4:10] == (2, cin, cout, s, s + 1, s)
    assert call.args[10:] == (*grid, k["THREADS"], (2 if nchunks > 1 else 1) * stage)
    assert call.args[-1] <= 227 * 1024
    wk = call.tensors[1]
    assert wk.shape == (nchunks, k["CK"], 27, cout16) and wk.dtype == torch.float32
    assert call.result.shape == (2, cout, s, s + 1, s) and call.result.dtype == torch.float32


@pytest.mark.parametrize("cin,cout", [(1, 16), (3, 8), (40, 20), (16, 48)])
def test_the_fp32_packing_summed_as_the_kernel_sums_reproduces_the_op(cin, cout):
    """The packed weights (chunk, channel, tap, Cout16), zero past Cin and
    Cout, summed over the chunks, their channels and the taps as the fp32
    body sums them (tap = (kd * 3 + kh) * 3 + kw on the zero-haloed input),
    reproduce conv3x3x3_cf_relu_reference (held against the JAX package in
    tests/test_torch_ops.py) within 2e-5 of its max."""
    rng = np.random.default_rng(cin * 100 + cout)
    x = torch.from_numpy(rng.normal(size=(2, cin, 5, 6, 7)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, cin, cout)) / (27 * cin) ** 0.5)
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32) * 0.1)
    wk = conv3.pack_weights_f32(w)
    ck = conv3.F32_CK
    assert not wk.reshape(-1, 27, wk.shape[-1])[cin:].any() and not wk[..., cout:].any()
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    acc = torch.zeros(2, wk.shape[-1], 5, 6, 7)
    for chunk in range(wk.shape[0]):
        for ci in range(min(ck, cin - chunk * ck)):
            c = chunk * ck + ci
            for kd in range(3):
                for kh in range(3):
                    for kw in range(3):
                        tap = (kd * 3 + kh) * 3 + kw
                        shifted = xp[:, c, kd:kd + 5, kh:kh + 6, kw:kw + 7]
                        acc += shifted[:, None] * wk[chunk, ci, tap][None, :, None, None, None]
    got = torch.relu(acc[:, :cout] + b.reshape(1, -1, 1, 1, 1))
    want = conv3.conv3x3x3_cf_relu_reference(x, w, b)
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())


@pytest.mark.parametrize("shape", [(1, 16, 192, 192, 192), (1, 128, 24, 24, 24),
                                   (2, 3, 5, 7, 9)])
def test_the_fp32_pool_launch_is_the_sources(shape, faked_launches):
    threads = _constants("pool2x.cu")["THREADS"]
    assert threads == pool.POOL_THREADS
    call = pool.pool_f32_call(torch.empty(shape, device="meta"))
    b, c, d, h, w = shape
    n = b * c * (d // 2) * (h // 2) * (w // 2)
    assert call.entry == "mmseg_pool2x_f32"
    assert call.args[2:] == (b, c, d, h, w, -(-n // threads), threads)
    assert call.result.shape == (b, c, d // 2, h // 2, w // 2)


@pytest.mark.parametrize("shape,co", [((1, 16, 192, 192, 192), 4), ((2, 5, 3, 5, 7), 3),
                                      ((1, 64, 3, 3, 3), 8)])
def test_the_fp32_head_launch_is_the_sources(shape, co, faked_launches):
    k = _constants("head1x1.cu")
    assert k["THREADS"] == head.HEAD_THREADS and k["VOX"] == 8
    x = torch.empty(shape, device="meta")
    call = head.head_f32_call(x, torch.empty(shape[1], co, device="meta"),
                              torch.empty(co, device="meta"))
    b, cin, d, h, w = shape
    groups = b * -(-(d * h * w) // k["VOX"])
    assert call.entry == "mmseg_head1x1_f32"
    assert call.args[4:] == (b, cin, co, d * h * w, -(-groups // k["THREADS"]), k["THREADS"],
                             cin * -(-co // 4) * 4 * 4)
    assert call.result.dtype == torch.float32 and call.result.shape == (b, co, d, h, w)


# ---- refusals ----------------------------------------------------------------------


def test_the_fp32_wrappers_refuse_what_their_kernels_do_not_take(faked_launches):
    meta = {"device": "meta"}
    bf16 = torch.empty(1, 16, 4, 8, 16, dtype=torch.bfloat16, **meta)
    x = torch.empty(1, 16, 4, 8, 16, **meta)
    w, b = torch.empty(3, 3, 3, 16, 16, **meta), torch.empty(16, **meta)
    with pytest.raises(TypeError, match="takes torch.float32"):
        conv3.relu_f32_call(bf16, w, b)
    with pytest.raises(ValueError, match="contiguous"):
        conv3.relu_f32_call(x.transpose(3, 4), w.transpose(3, 4), b)
    wide = torch.empty(1, 65, 4, 8, 16, **meta)
    with pytest.raises(ValueError, match="Cin, Cout <= 64"):
        conv3.relu_f32_call(wide, torch.empty(3, 3, 3, 65, 16, **meta), b)
    with pytest.raises(ValueError, match="Cin, Cout <= 64"):
        conv3.relu_f32_call(x, torch.empty(3, 3, 3, 16, 65, **meta), torch.empty(65, **meta))
    with pytest.raises(ValueError, match="does not match"):
        conv3.relu_f32_call(x, w, torch.empty(8, **meta))
    with pytest.raises(TypeError, match="takes torch.float32"):
        pool.pool_f32_call(bf16)
    with pytest.raises(ValueError, match="contiguous"):
        pool.pool_f32_call(x.transpose(3, 4))
    with pytest.raises(TypeError, match="takes torch.float32"):
        head.head_f32_call(bf16, torch.empty(16, 4, **meta), torch.empty(4, **meta))
    with pytest.raises(ValueError, match="1..8 classes"):
        head.head_f32_call(x, torch.empty(16, 9, **meta), torch.empty(9, **meta))
    # a bf16 x takes the bf16 entry, an fp32 one the fp32 entry: never the other
    conv3.conv3x3x3_cf_relu(bf16, w, b)
    conv3.conv3x3x3_cf_relu(x, w, b)
    assert [c.entry for c in faked_launches] == ["mmseg_conv3_bias_relu",
                                                 "mmseg_conv3_f32_bias_relu"]


def test_an_fp32_head_or_pool_that_needs_a_gradient_launches_its_fp32_backward_kernels(
        faked_launches, monkeypatch):
    """With a gradient asked for, the fp32 head and pool launch their fp32
    forward kernels and, in the backward, their fp32 backward kernels
    (the head's dx and weight gradient, the pool's backward), and never a
    plain version on a device tensor. Without one (an eval forward) they
    launch the forward kernels alone; bf16 features keep their bf16
    kernels."""
    def refuse(*a, **k):
        raise AssertionError("a plain version ran on a device tensor")

    for module, name in ((head, "head1x1_cf_reference"), (head, "head1x1_cf_dx_reference"),
                         (head, "head1x1_cf_dw_reference"), (pool, "max_pool2x_cf_reference"),
                         (pool, "max_pool2x_cf_bwd_reference"), (torch, "einsum")):
        monkeypatch.setattr(module, name, refuse)
    param = torch.empty(4, 16, 1, 1, 1, device="meta", requires_grad=True)
    bias = torch.empty(4, device="meta", requires_grad=True)
    x = torch.empty(1, 16, 2, 4, 8, device="meta", requires_grad=True)
    head.head1x1_cf(x, param[:, :, 0, 0, 0].t(), bias).sum().backward()
    pool.max_pool2x_cf(x).sum().backward()
    assert [c.entry for c in faked_launches] == [
        "mmseg_head1x1_f32", "mmseg_head1x1_dx_f32", "mmseg_head1x1_dw_f32", "mmseg_pool2x_f32",
        "mmseg_pool2x_bwd_f32"]
    assert x.grad.dtype == torch.float32 and param.grad.shape == param.shape
    faked_launches.clear()
    with torch.inference_mode():
        head.head1x1_cf(x.detach(), param[:, :, 0, 0, 0].t(), bias)
    with torch.no_grad():
        pool.max_pool2x_cf(x)
    assert [c.entry for c in faked_launches] == ["mmseg_head1x1_f32", "mmseg_pool2x_f32"]
    # bf16 features keep their backward kernels
    xb = torch.empty(1, 16, 2, 4, 8, dtype=torch.bfloat16, device="meta", requires_grad=True)
    head.head1x1_cf(xb, param[:, :, 0, 0, 0].t(), bias).sum().backward()
    assert [c.entry for c in faked_launches[2:]] == ["mmseg_head1x1", "mmseg_head1x1_dx",
                                                     "mmseg_head1x1_dw"]


# ---- the CLIs' device policy -------------------------------------------------------


def test_resolve_device_takes_fp32_on_the_gpu_for_eval_and_training(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for precision in ("fp32", "bf16"):
        assert common.resolve_device("cuda", precision) == torch.device("cuda")
        assert common.resolve_device("cpu", precision) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for precision in ("fp32", "bf16"):  # never the CPU for 'cuda'
        with pytest.raises(RuntimeError, match="--device cpu"):
            common.resolve_device("cuda", precision)


def _resolving_spy(seen):
    """A resolve_device that records its call and the device it resolves,
    then stops the CLI."""
    def spy(*args, **kwargs):
        seen.append((args, kwargs, common.resolve_device(*args, **kwargs)))
        raise RuntimeError("stop")
    return spy


def test_the_eval_cli_resolves_the_gpu_in_fp32(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []
    monkeypatch.setattr(test_model, "resolve_device", _resolving_spy(seen))
    args = test_model.build_parser().parse_args([
        "--model_path", "m.msgpack", "--data_root", str(tmp_path), "--experiment_dir",
        str(tmp_path), "--model_name", "x", "--precision", "fp32"])
    with pytest.raises(RuntimeError, match="stop"):
        test_model.main(args)
    assert seen == [(("cuda", "fp32"), {}, torch.device("cuda"))]


TRAIN_CLIS = [
    (train_unet, []), (finetune_ct, ["--pretrained_model", "p.msgpack"]),
    (distill_unet, ["--teacher_model", "t.msgpack"]),
    (train_dann, ["--source_modality", "mri", "--target_modality", "ct"]),
]


@pytest.mark.parametrize("cli,extra", TRAIN_CLIS,
                         ids=[c.__name__.rsplit(".", 1)[1] for c, _ in TRAIN_CLIS])
def test_each_training_cli_takes_fp32_on_the_gpu(cli, extra, monkeypatch, tmp_path):
    """With a GPU present, --mixed_precision no (the JAX CLIs' default, fp32)
    resolves to the card and the CLI goes on (a spy stops it there, before
    any data is read), as bf16 does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    argv = ["--data_root", str(tmp_path / "none"), "--experiment_dir", str(tmp_path), *extra]
    seen = []
    monkeypatch.setattr(cli, "resolve_device", _resolving_spy(seen))
    for flag in ("no", "bf16"):
        with pytest.raises(RuntimeError, match="stop"):
            cli.main(cli.build_parser().parse_args([*argv, "--mixed_precision", flag]))
    assert seen == [(("cuda", p), {}, torch.device("cuda")) for p in ("fp32", "bf16")]


@pytest.mark.parametrize("experiment,extra", [
    ("train", []), ("finetune", ["--pretrained_model", "p.msgpack"]),
    ("distill", ["--teacher_model", "t.msgpack"]), ("dann", []),
])
def test_the_orchestrator_takes_fp32_training_on_the_gpu(experiment, extra, monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []
    for cli, _ in TRAIN_CLIS:
        monkeypatch.setattr(cli, "resolve_device", _resolving_spy(seen))
    with pytest.raises(RuntimeError, match="stop"):
        main.main(["--experiment", experiment, "--data_root", str(tmp_path / "none"),
                   "--experiment_dir", str(tmp_path), "--mixed_precision", "no", *extra])
    assert seen == [(("cuda", "fp32"), {}, torch.device("cuda"))]
