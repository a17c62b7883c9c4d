#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line per check; any failure exits non-zero:

1. device: a CUDA device must be present; prints its name, the
   ``nvidia-smi`` name and power limit, and the torch and CUDA versions;
2. build: compiles every kernel of ``multimodal_segmentation_project_tpu_torch/csrc``
   with nvcc (one process per source, in parallel), from this checkout;
   prints ptxas's registers and spills of each of the 24 instances of the
   conv body (``csrc/conv3.cu``), of the 8 of the dW body
   (``csrc/conv3_dw.cu``) and of the head's and the upconv's 34
   (``csrc/head1x1.cu``, ``csrc/upconv_d2s.cu``; none of these 42 may
   spill), and their dynamic shared memory per block;
3. kernels: each kernel against its plain PyTorch version at every shape
   the 192^3 eval forward and train step give it, in bf16, on seeded
   inputs; prints the error against the stated tolerance, the median time
   of the kernel as called, of its plain version and of one library call
   over distinct inputs (CUDA events), and its bound: the larger of its
   bytes over 3.35 TB/s and its FLOPs over 989 TFLOP/s. For every kernel
   also the bare launch (operands packed before the timed window,
   BARE_REPS runs over the distinct inputs between two CUDA events, over
   the count) and the kernel/library ratios per shape, and the conv and
   dW bodies' sums per train step; ragged edge inputs; the same bits
   twice where blocks' partials are summed (the head's weight gradient
   too), and for the upconv and the head's dx;
4. slice: writes two synthetic 192^3 CT cases and a seeded default-width
   UNet3D ``.pth``, runs the port's eval CLI (``workloads.test_model``) on
   the GPU, checks its artifacts and that every forward launched exactly
   11 conv, 4 pool, 3 upconv and 1 head kernel;
5. parity: the GPU's bf16 eval forward against the port's fp32 plain
   forward on the CPU, one 64^3 volume at full width;
6. train: writes two train, one val and one test synthetic 192^3 CT case,
   runs the port's train CLI (``workloads.train_unet``) as
   ``run_training.sh`` does (batch 1, bf16, ce_tversky, augmentation on)
   for two epochs, checks finite losses and the launches of every kernel
   per train step (the fused DoubleConv's kernels in enc0-enc2, dec2 and
   dec3, the per-conv chain in dec1) and per validation forward, evaluates the best
   checkpoint with the eval CLI; then times the train step (median over
   distinct inputs, host clock around ``torch.cuda.synchronize()``),
   reports the peak allocated memory, and breaks a few steps' device time
   down from a ``torch.profiler`` trace;
7. train parity: one train step at 128^3 and full width, GPU bf16 against
   CPU fp32 and against the CPU bf16 emulation, from the same weights: the
   loss and every parameter's gradient, and controls that the check
   refuses a zeroed or halved deep gradient and a fused block's bn0
   scale gradient;
8. workloads (run after phase 6, before phase 7): the port's orchestrator
   (``workloads.main``) runs ``--experiment finetune`` (with
   ``--freeze_encoder``), ``distill`` and ``dann`` at full width on phase
   6's data and best checkpoint (the pretrained model and the teacher) as
   ``run_finetune_ct.sh``, ``run_distillation.sh`` and ``run_dann.sh`` do,
   one epoch of two steps each with gradient accumulation 2; checks the
   exact launches of every kernel per step and per validation forward,
   finite CSV rows, the best checkpoints, the fine-tune's frozen encoder
   and bottleneck unchanged, and the DANN model through the eval CLI; then
   times the distillation and DANN steps alone (median over distinct
   device-resident inputs, peak memory, launches per step) and holds one
   DANN step at 64^3 against the CPU (fp32 and the bf16 emulation): the
   task and domain losses and every discriminator gradient, with a control
   that a zeroed fc0 gradient is refused.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Scratch files go to
``build/chip_smoke/`` in this checkout.
"""

from __future__ import annotations

import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "chip_smoke"
SEED = 0
N_TIMED = 5  # distinct inputs per timed kernel / plain / library call
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, same source
FP32_FLOPS = 67e12         # fp32 outside the tensor cores, same source

# (Cin, Cout, S) of every 3x3x3 conv with Cin, Cout <= 64 at 192^3 input:
# the eval forward's
CONV_SHAPES = [
    (1, 16, 192), (16, 16, 192),                       # enc0
    (16, 32, 96), (32, 32, 96),                        # enc1
    (32, 64, 48), (64, 64, 48),                        # enc2
    (64, 64, 48),                                      # dec1.conv1
    (64, 32, 96), (32, 32, 96),                        # dec2
    (32, 16, 192), (16, 16, 192),                      # dec3
]
# the train step's: conv0 and conv1 of the fused blocks (enc0-enc2, dec2,
# dec3), and dec1's conv1 on the per-conv chain
CONV0_SHAPES = [(1, 16, 192), (16, 32, 96), (32, 64, 48), (64, 32, 96), (32, 16, 192)]
CONV1_SHAPES = [(16, 16, 192), (32, 32, 96), (64, 64, 48), (32, 32, 96), (16, 16, 192)]
TRAIN_CONV_SHAPES = [(64, 64, 48)]
# the plain dx convs of the train step: every conv0 but the image's, and
# dec1.conv1, Cin/Cout swapped; the boundary convs' dx is the dx epilogue's
DX_SHAPES = [(cout, cin, s) for cin, cout, s in CONV0_SHAPES + TRAIN_CONV_SHAPES if cin > 1]
DW_SHAPES = CONV0_SHAPES + TRAIN_CONV_SHAPES
POOL_SHAPES = [(16, 192), (32, 96), (64, 48), (128, 24)]     # (C, S in)
UPCONV_SHAPES = [(128, 64, 24), (64, 32, 48), (32, 16, 96)]  # (Cin, Cout, S in)
HEAD_SHAPES = [(16, 4, 192)]                                 # (Cin, classes, S)
HEAD_DX_SHAPES = [(4, 16, 192)]                              # (classes, Cin, S)
HEAD_DW_SHAPES = [(16, 4, 192)]                              # (Cin, classes, S)

# launches per eval forward and per train step (default widths, 192^3)
PER_FORWARD = {"conv3x3x3_cf_relu": 11, "max_pool2x_cf": 4, "upconv2x_cf": 3, "head1x1_cf": 1}
PER_STEP = {"conv3x3x3_cf_stats": 5, "conv3x3x3_cf_boundary_stats": 5, "conv3x3x3_cf": 1,
            "conv3x3x3_cf_dx": 5, "conv3x3x3_cf_dx_epilogue": 5, "conv3x3x3_cf_dw": 6,
            "conv3x3x3_cf_dw_prologue": 5, "max_pool2x_cf": 4, "max_pool2x_cf_bwd": 4,
            "upconv2x_cf": 3, "head1x1_cf": 1, "head1x1_cf_dx": 1, "head1x1_cf_dw": 1}
CONV3 = "multimodal_segmentation_project_tpu_torch/csrc/conv3.cu"
CONV3_DW = "multimodal_segmentation_project_tpu_torch/csrc/conv3_dw.cu"
PALLAS_CONV = "multimodal_segmentation_project_tpu/ops/pallas_conv.py"

KERNEL_INFO = {  # name -> (source, the TPU kernel it replaces)
    "conv3x3x3_cf_relu": (CONV3, f"{PALLAS_CONV}:314"),
    "conv3x3x3_cf": (CONV3, f"{PALLAS_CONV}:293"),
    "conv3x3x3_cf_dx": (CONV3, f"{PALLAS_CONV}:293"),
    "conv3x3x3_cf_dw": (CONV3_DW, f"{PALLAS_CONV}:468"),
    "conv3x3x3_cf_stats": (CONV3, f"{PALLAS_CONV}:341"),
    "conv3x3x3_cf_boundary_stats": (CONV3, f"{PALLAS_CONV}:1039"),
    "conv3x3x3_cf_dx_epilogue": (CONV3, f"{PALLAS_CONV}:886"),
    "conv3x3x3_cf_dw_prologue": (CONV3_DW, f"{PALLAS_CONV}:799"),
    "conv3x3x3_cf_boundary": (CONV3, f"{PALLAS_CONV}:732"),
    "max_pool2x_cf": ("multimodal_segmentation_project_tpu_torch/csrc/pool2x.cu",
                      "multimodal_segmentation_project_tpu/ops/pool.py:65"),
    "max_pool2x_cf_bwd": ("multimodal_segmentation_project_tpu_torch/csrc/pool2x.cu",
                          "multimodal_segmentation_project_tpu/ops/pool.py:145"),
    "upconv2x_cf": ("multimodal_segmentation_project_tpu_torch/csrc/upconv_d2s.cu",
                    "multimodal_segmentation_project_tpu/ops/upconv.py:69"),
    "head1x1_cf": ("multimodal_segmentation_project_tpu_torch/csrc/head1x1.cu",
                   "multimodal_segmentation_project_tpu/ops/head.py:39"),
    "head1x1_cf_dx": ("multimodal_segmentation_project_tpu_torch/csrc/head1x1.cu",
                      "multimodal_segmentation_project_tpu/ops/head.py:39"),
    # no Pallas kernel: _head_bwd_rule's dkernel dot_general and dbias sum (XLA)
    "head1x1_cf_dw": ("multimodal_segmentation_project_tpu_torch/csrc/head1x1.cu",
                      "multimodal_segmentation_project_tpu/ops/head.py:108"),
}
# conv/upconv/head-dx: the kernel and the plain version round to bf16 once,
# at the same point, from fp32 sums taken in different orders, so an output
# may differ by one bf16 ulp of its value. The training conv rounds twice,
# the conv's cast and then the bias added in bf16: the cast may differ by
# one ulp of the conv's value and the sum by one more of its own. Both are
# checked element by element (_elementwise_ok), with a floor for fp32
# sum-order noise near zero. The fused DoubleConv's kernels return more
# than one output: kernels 3 and 4 (conv + stats) y, rounded once, and the
# per-channel sums s1, s2 of y and y^2; the dx epilogue (5) dy, rounded
# once, and the per-(batch, channel) sums da, dt of du x and du.
BF16_ONE_ULP = "1 bf16 ulp"
BF16_TWO_ROUNDINGS = "1 bf16 ulp of the conv + 1 of the output"
ELEMENTWISE = (BF16_ONE_ULP, BF16_TWO_ROUNDINGS)
STATS = "y: 1 bf16 ulp; s1, s2: sum |dy| + STATS_TOL sum |y|"
DX_EPILOGUE = "dy: 1 bf16 ulp; da, dt: DADT_TOL sum |du x|, sum |du|"
HEAD_TOL = 1e-5  # fp32 logits: sum order only, scaled by max|plain|
# the head's weight gradient (11-dw): dk and db are fp32 sums over 7.1M
# voxels, the kernel's in per-thread runs of ~100 terms, a shuffle tree,
# 8 warps and ~264 blocks in order, the plain einsum's in cuBLAS's order.
# Each rounding errs by at most 2**-24 of a partial, and the errors of a
# sum this deep add up as a random walk, far under HEAD_DW_TOL of the sum
# of |terms| per entry (a block's partials lost would move an entry by
# about 1/264 of it).
HEAD_DW_TOL = 1e-5
HEAD_DW = f"dk, db per entry within {HEAD_DW_TOL:g} sum |x ct|, sum |ct|"
DW_TOL = 1e-3    # fp32 sums of up to 7.1M bf16 products in another order
# s1, s2 per channel: the kernel and the plain version sum their own y, which
# may differ by an ulp here and there, so a channel's sums may differ by
# sum |y_kernel - y_plain| (of y^2 for s2) plus the fp32 sum-order error of
# up to 7.1M terms (the kernel: warp trees, 8 warps, ~100 partials per
# thread and a tree of 256; at most ~130 roundings deep, under 1e-5 of the
# sum of |terms|). A block's partials lost would move a 192^3 channel's sum
# by 1/27648 = 3.6e-5 of it.
STATS_TOL = 1e-5
# da, dt per (batch, channel): both sides mask the same fp32 u = x a + t,
# so they differ only by du = dr, the dx conv's fp32 sum over up to 27 * 64
# bf16 products in another order, and by the order of the sum over the
# volume; those errors are independent from voxel to voxel and average out
# (at most 5e-8 of the sums of |terms| on the H100 at the train step's
# shapes). A block's partials lost would move a 96^3 entry by 1/3456 of it.
DADT_TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def fail_unless(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    import torch

    fail_unless(torch.cuda.is_available(), "torch.cuda.is_available() is false: no GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    fail_unless(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"count {torch.cuda.device_count()} | name, power limit:", flush=True)
    print(card, flush=True)  # as nvidia-smi gives it
    # fp32 plain versions are the yardstick: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return name, card


EPILOGUES = {"0": "bias+ReLU (7)", "1": "cast-then-bias (1, 1-dx, 12)", "2": "bias+stats (3, 4)",
             "3": "dx mask (5)"}


def ptxas_resources(log: str, pattern: str, label) -> list:
    """One line per kernel instance whose mangled name matches ``pattern``,
    from ptxas's -v output: ``label(*groups)``, its registers and shared
    memory, and its spills."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name, spill = line, ""
        elif "spill" in line and name is not None:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name is not None:
            m = re.search(pattern, name)
            if m:
                out.append(f"{label(*m.groups())}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return sorted(out)


def conv_body_resources(log: str) -> list:
    """conv3.cu's conv3_kernel<COUT, EPI, PRO> instances."""
    return ptxas_resources(
        log, r"conv3_kernelILi(\d+)ELi(\d)ELb(\d)E",
        lambda cout, epi, pro: f"conv3_kernel<COUT={cout}, {EPILOGUES[epi]}, prologue={pro}>")


DW_INSTANCES = 8  # conv3_dw.cu: COUT 16, 32, 48, 64, each without and with the prologue


def dw_body_resources(log: str) -> list:
    """conv3_dw.cu's conv3_dw_partial_kernel<COUT, PRO> instances."""
    return ptxas_resources(
        log, r"conv3_dw_partial_kernelILi(\d+)ELb(\d)E",
        lambda cout, pro: f"conv3_dw_partial_kernel<COUT={cout}, prologue={pro}>")


# head1x1.cu: 8 forward (CO = 1..8), 8 dx (NC = 1..8), 16 weight-gradient
# (NC = 1..8, 16-byte or guarded loads) and the weight gradient's block
# reduce; upconv_d2s.cu: 1
SMALL_INSTANCES = 34


def small_kernel_resources(log: str) -> list:
    """head1x1.cu's and upconv_d2s.cu's kernel instances."""
    def label(kname, n, vec):
        if n is None:
            return kname
        return (f"{kname}<{'CO' if kname == 'head1x1_kernel' else 'NC'}={n}"
                + ("" if vec is None else f", {'16-byte' if vec == '1' else 'guarded'} loads")
                + ">")

    return ptxas_resources(
        log, r"(head1x1_kernel|head1x1_dx_kernel|head1x1_dw_kernel|head1x1_dw_reduce_kernel"
             r"|upconv_d2s_kernel)(?:ILi(\d+)E(?:Lb(\d)E)?)?", label)


def phase_build() -> None:
    import multimodal_segmentation_project_tpu_torch as pkg
    from multimodal_segmentation_project_tpu_torch.ops import _build

    # the port must come from this checkout, not from an installed copy
    fail_unless(Path(pkg.__file__).resolve().is_relative_to(ROOT),
                f"port package imported from {pkg.__file__}, not from {ROOT}")
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    lib = _build.load()
    secs = time.perf_counter() - t0
    print(f"[build] {_build.library_path().relative_to(ROOT)} "
          f"{'loaded from an earlier build' if cached else 'built by nvcc and loaded'} "
          f"in {secs:.2f} s", flush=True)
    log = _build.build_log_path().read_text()
    lines = conv_body_resources(log)
    fail_unless(len(lines) == 24, f"ptxas reported {len(lines)} conv3_kernel instances, not 24")
    for line in lines:
        print(f"[build] ptxas {line}", flush=True)
    print("[build] conv3_kernel dynamic shared memory per block, one chunk of 16 input "
          "channels / more: " + ", ".join(
              f"COUT={c} {lib.mmseg_conv3_smem_bytes(c, 1)} / {lib.mmseg_conv3_smem_bytes(c, 2)} B"
              for c in (16, 32, 48, 64)), flush=True)
    lines = dw_body_resources(log)
    fail_unless(len(lines) == DW_INSTANCES, f"ptxas reported {len(lines)} "
                f"conv3_dw_partial_kernel instances, not {DW_INSTANCES}")
    for line in lines:
        print(f"[build] ptxas {line}", flush=True)
        fail_unless("0 bytes spill stores, 0 bytes spill loads" in line, f"dW spills: {line}")
    print("[build] conv3_dw_partial_kernel dynamic shared memory per block: " + ", ".join(
        f"COUT={c} {lib.mmseg_conv3_dw_smem_bytes(c)} B" for c in (16, 32, 48, 64)), flush=True)
    lines = small_kernel_resources(log)
    fail_unless(len(lines) == SMALL_INSTANCES, f"ptxas reported {len(lines)} head and upconv "
                f"kernel instances, not {SMALL_INSTANCES}")
    for line in lines:
        print(f"[build] ptxas {line}", flush=True)
        fail_unless("0 bytes spill stores, 0 bytes spill loads" in line,
                    f"head or upconv spills: {line}")
    print("[build] upconv_d2s_kernel dynamic shared memory per block: " + ", ".join(
        f"Cin={c} {lib.mmseg_upconv_smem_bytes(c)} B" for c in (32, 64, 128)), flush=True)


def _time_ms(fn, inputs) -> float:
    """Median over distinct inputs of one call each, by CUDA events."""
    import torch

    fn(*inputs[0])  # warm-up
    torch.cuda.synchronize()
    times = []
    for args in inputs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


BARE_REPS = 4  # runs over the distinct inputs per bare-launch timing


def _time_bare_ms(name: str, call, inputs) -> float:
    """Mean time of one bare launch of a kernel's entry point: the
    operands packed and the scratch and outputs allocated before the window,
    then BARE_REPS runs over the distinct inputs between two CUDA events,
    over the count."""
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import _build

    lib = _build.load()
    calls = [call(*args) for args in inputs]
    fns = [(getattr(lib, c.entry), c.args) for c in calls]
    stream = torch.cuda.current_stream().cuda_stream
    for fn, args in fns:  # warm-up
        _build.check(name, fn(*args, stream))
    torch.cuda.synchronize()
    codes = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(BARE_REPS):
        for fn, args in fns:
            codes.append(fn(*args, stream))
    end.record()
    end.synchronize()
    for code in codes:
        _build.check(name, code)
    return start.elapsed_time(end) / (BARE_REPS * len(fns))


def _bf16_ulp(t):
    """The bf16 ulp of each element's magnitude (8 significant bits)."""
    import torch

    m = t.float().abs()
    _, exp = torch.frexp(m)  # m = mantissa * 2**exp, mantissa in [0.5, 1)
    return torch.where(m > 0, torch.ldexp(torch.ones_like(m), exp - 8), 0.0)


def _elementwise_ok(tol, got, want, args) -> bool:
    """Every element within its allowance under ``tol`` (a key of
    ELEMENTWISE), plus 2**-16 * max|want| for an fp32 sum-order difference
    on a value near zero (where the sum cancels, the ulp of the result is
    far below the rounding error of its summands). The allowance is one
    ulp of the larger of the two values, and for the training conv one
    more of its fp32 conv before the cast and the bias (x, w = args; for
    the boundary conv x, w, b, a, t = args and the conv's input is the
    prologue of x)."""
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import conv3, conv3_fused

    allowed = _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    if tol == BF16_TWO_ROUNDINGS:
        x = args[0] if len(args) < 5 else conv3_fused.prologue_reference(args[0], *args[3:5])
        c = conv3.conv_fp32(x, args[1])
        allowed += _bf16_ulp(torch.maximum(c.abs(), c.to(torch.bfloat16).float().abs()))
    floor = 2.0**-16 * want.float().abs().max()
    return bool(((got.float() - want.float()).abs() <= allowed + floor).all())


def _sums_ratio(tol, got, want, args) -> float:
    """The largest error of the fp32 sums (the outputs after the first) of
    a fused kernel over its bound under ``tol`` (STATS or DX_EPILOGUE),
    entry by entry; within tolerance when <= 1."""
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import conv3

    f64 = torch.float64
    if tol == STATS:  # per channel, over (B, D, H, W)
        dims = (0, 2, 3, 4)
        yk, yp = got[0].to(f64), want[0].to(f64)
        terms = [(yk, yp), (yk * yk, yp * yp)]
        bounds = [(k - p).abs().sum(dims) + STATS_TOL * p.abs().sum(dims) for k, p in terms]
    else:  # per (batch, channel), over (D, H, W): du from the plain arithmetic
        g, w, x, a, t = args
        dims = (2, 3, 4)
        xf = x.float()
        u = xf * a[:, :, None, None, None] + t[:, :, None, None, None]
        du = torch.where(u > 0, conv3.conv_fp32(g, conv3.flip_transpose(w)), 0.0)
        bounds = [DADT_TOL * (du * xf).abs().to(f64).sum(dims),
                  DADT_TOL * du.abs().to(f64).sum(dims)]
    worst = 0.0
    for k, p, bound in zip(got[1:], want[1:], bounds):
        err = (k.to(f64) - p.to(f64)).abs()
        worst = max(worst, (err / bound.clamp_min(1e-30)).max().item())
    return worst


def _head_dw_ratio(got, want, args) -> float:
    """The largest error of the head's dk, db (kernel against plain) over
    its bound, HEAD_DW_TOL times the entry's sum of |terms|."""
    import torch

    x, ct = args
    xa, ca = x.float().abs(), ct.float().abs()
    bounds = (HEAD_DW_TOL * torch.einsum("bidhw,bodhw->io", xa, ca),
              HEAD_DW_TOL * ca.sum(dim=(0, 2, 3, 4)))
    return max(((k - p).abs() / b.clamp_min(1e-30)).max().item()
               for k, p, b in zip(got, want, bounds))


def _errors(label: str, kern, plain, inputs, tol):
    """(max abs error, max error scaled by max|plain|, within tolerance,
    worst sum error over its bound or None) of the kernel against its plain
    version over ``inputs``. ``tol`` is a key of ELEMENTWISE (each element
    within its bf16 allowance), STATS or DX_EPILOGUE (a bf16 output within
    one ulp per element and fp32 sums within their bounds), HEAD_DW (every
    output a sum within its bound), 0 (exact) or a bound on the scaled
    error; the errors are those of the first output (for HEAD_DW, of all)."""
    import torch

    err = rel = 0.0
    sums = None
    ok = True
    for args in inputs:
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        elem_tol = tol
        if tol == HEAD_DW:
            ratio = _head_dw_ratio(got, want, args)
            sums = max(sums or 0.0, ratio)
            ok = ok and ratio <= 1.0
            got, want = (torch.cat([t.flatten() for t in out]) for out in (got, want))
        elif tol in (STATS, DX_EPILOGUE):
            ratio = _sums_ratio(tol, got, want, args)
            sums = max(sums or 0.0, ratio)
            ok = ok and ratio <= 1.0
            got, want, elem_tol = got[0], want[0], BF16_ONE_ULP
        fail_unless(got.shape == want.shape and got.dtype == want.dtype,
                    f"{label}: {tuple(got.shape)}/{got.dtype} vs "
                    f"{tuple(want.shape)}/{want.dtype}")
        fail_unless(bool(torch.isfinite(want).all()), f"{label}: non-finite plain result")
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        rel = max(rel, e / max(want.float().abs().max().item(), 1e-30))
        if elem_tol in ELEMENTWISE:
            ok = ok and _elementwise_ok(elem_tol, got, want, args)
    if tol == 0.0:
        ok = err == 0.0
    elif not isinstance(tol, str):
        ok = rel <= tol
    return err, rel, ok, sums


def _tol_label(tol) -> str:
    if isinstance(tol, str):
        return f"each element within {tol}" if tol in ELEMENTWISE else tol
    return "== 0 (exact)" if tol == 0.0 else f"<= {tol:.3g} scaled"


def _count(shapes) -> list:
    """Unique shapes in first-seen order, each with its launches per pass."""
    out: dict = {}
    for shape in shapes:
        out[shape] = out.get(shape, 0) + 1
    return list(out.items())


def _kernel_plan():
    """name -> (kernel, plain, library call, inputs(shape), shapes, tolerance,
    work(shape) = (bytes, FLOPs, peak FLOP/s[, fp32 FLOPs besides]), library
    label)."""
    import torch
    import torch.nn.functional as F

    from multimodal_segmentation_project_tpu_torch.ops import conv3, conv3_fused, head, pool
    from multimodal_segmentation_project_tpu_torch.ops import upconv

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def conv_w(cin, cout):
        return randn(3, 3, 3, cin, cout, scale=(2.0 / (27 * cin)) ** 0.5, dtype=torch.float32)

    def conv_inputs(cin, cout, s):
        w, b = conv_w(cin, cout), randn(cout, scale=0.1, dtype=torch.float32)
        return [(randn(1, cin, s, s, s), w, b) for _ in range(N_TIMED)]

    def dx_inputs(gc, xc, s):  # cotangent channels (the conv's Cout), dx channels
        w = conv_w(xc, gc)
        return [(randn(1, gc, s, s, s), w) for _ in range(N_TIMED)]

    def dw_inputs(cin, cout, s):
        return [(randn(1, cin, s, s, s), randn(1, cout, s, s, s, scale=1e-2))
                for _ in range(N_TIMED)]

    def affine(c, n=1):
        """A boundary conv's (a, t) as the fused block makes them: BatchNorm's
        scale / std and shift, t of both signs, Dropout3d's 0.1 folded in."""
        m = (torch.rand(n, c, generator=gen, device=dev) >= 0.1).float() / 0.9
        a = (torch.rand(n, c, generator=gen, device=dev) + 0.5) * m
        return a, torch.randn(n, c, generator=gen, device=dev) * 0.5 * m

    def boundary_inputs(cin, cout, s):
        w, b = conv_w(cin, cout), randn(cout, scale=0.1, dtype=torch.float32)
        return [(randn(1, cin, s, s, s), w, b, *affine(cin)) for _ in range(N_TIMED)]

    def dx_epilogue_inputs(cin, cout, s):  # the boundary conv's channels
        w = conv_w(cin, cout)
        return [(randn(1, cout, s, s, s, scale=1e-2), w, randn(1, cin, s, s, s), *affine(cin))
                for _ in range(N_TIMED)]

    def dw_prologue_inputs(cin, cout, s):
        return [(randn(1, cin, s, s, s), randn(1, cout, s, s, s, scale=1e-2), *affine(cin))
                for _ in range(N_TIMED)]

    def pool_inputs(c, s):
        return [(randn(1, c, s, s, s),) for _ in range(N_TIMED)]

    def pool_bwd_inputs(c, s):
        """Inputs rounded to integers in [-4, 4]: most windows hold tied maxima."""
        out = []
        for _ in range(N_TIMED):
            x = (randn(1, c, s, s, s, scale=2.0, dtype=torch.float32).round()
                 .clamp(-4, 4).to(torch.bfloat16))
            out.append((x, pool.max_pool2x_cf(x), randn(1, c, s // 2, s // 2, s // 2)))
        return out

    def upconv_inputs(cin, cout, s):
        k = randn(2, 2, 2, cin, cout, scale=(1.0 / cin) ** 0.5, dtype=torch.float32)
        b = randn(cout, scale=0.1, dtype=torch.float32)
        return [(randn(1, cin, s, s, s), k, b) for _ in range(N_TIMED)]

    # the head's kernel (Cin, Co) as the model passes it: the transposed
    # view of its (Co, Cin) parameter
    def head_inputs(cin, co, s):
        k = randn(co, cin, scale=(1.0 / cin) ** 0.5, dtype=torch.float32).t()
        b = randn(co, scale=0.1, dtype=torch.float32)
        return [(randn(1, cin, s, s, s), k, b) for _ in range(N_TIMED)]

    def head_dx_inputs(co, cin, s):
        k = randn(co, cin, scale=(1.0 / cin) ** 0.5, dtype=torch.float32).t()
        return [(randn(1, co, s, s, s, scale=1e-3, dtype=torch.float32), k)
                for _ in range(N_TIMED)]

    def head_dw_inputs(cin, co, s):
        return [(randn(1, cin, s, s, s), randn(1, co, s, s, s, scale=1e-3, dtype=torch.float32))
                for _ in range(N_TIMED)]

    # library calls: one PyTorch call computing the same function, bf16
    def lib_conv(x, w, b):
        return F.conv3d(x, w.permute(4, 3, 0, 1, 2).to(x.dtype), b.to(x.dtype), padding=1)

    def lib_dx(g, w):
        return F.conv3d(g, conv3.flip_transpose(w).permute(4, 3, 0, 1, 2).to(g.dtype),
                        padding=1)

    def lib_dw(x, g):
        return torch.nn.grad.conv3d_weight(x, (g.shape[1], x.shape[1], 3, 3, 3), g, padding=1)

    # the fused kernels' conv part only: no single call computes the fusion
    def lib_boundary(x, w, b, a, t):
        return lib_conv(x, w, b)

    def lib_dx_epilogue(g, w, x, a, t):
        return lib_dx(g, w)

    def lib_dw_prologue(x, g, a, t):
        return lib_dw(x, g)

    def lib_pool_bwd(x, y, g):
        _, idx = F.max_pool3d(x, 2, 2, return_indices=True)
        return torch.ops.aten.max_pool3d_with_indices_backward(
            g, x, [2, 2, 2], [2, 2, 2], [0, 0, 0], [1, 1, 1], False, idx)

    def lib_upconv(x, k, b):
        return F.conv_transpose3d(x, k.permute(3, 4, 0, 1, 2).to(x.dtype), b.to(x.dtype),
                                  stride=2)

    def lib_head(x, k, b):
        return F.conv3d(x, k.t()[:, :, None, None, None].to(x.dtype), b.to(x.dtype))

    def lib_head_dx(ct, k):
        return F.conv3d(ct, k[:, :, None, None, None])

    def lib_head_dw(x, ct):  # what the port ran before the kernel, as one einsum plus a sum
        return (torch.einsum("bidhw,bodhw->io", x.float(), ct),
                ct.sum(dim=(0, 2, 3, 4)))

    no_grad = torch.no_grad()

    def ng(fn):
        def call(*a):
            with no_grad:
                return fn(*a)
        return call

    def v(s):
        return float(s) ** 3

    # each input read once, each output written once; FLOPs of the function
    def conv_work(cin, cout, s):  # x and out bf16, w fp32; also dx and dW
        nbytes = 2 * v(s) * (cin + cout) + 27 * cin * cout * 4
        return nbytes, 2 * 27 * cin * cout * v(s), BF16_FLOPS

    # the fused kernels: the conv's, and the fp32 work of the prologue (mul,
    # add, max per input element) and the epilogues (stats: bias add, square,
    # two sums per output; dx mask: mul, add, compare, mul, two products and
    # two sums per output)
    def stats_work(cin, cout, s):
        return (*conv_work(cin, cout, s), 4 * cout * v(s))

    def boundary_stats_work(cin, cout, s):
        return (*conv_work(cin, cout, s), (3 * cin + 4 * cout) * v(s))

    def boundary_work(cin, cout, s):
        return (*conv_work(cin, cout, s), (3 * cin + 1 * cout) * v(s))

    def dx_epilogue_work(cin, cout, s):  # g and x read, dy written
        nbytes = 2 * v(s) * (cout + 2 * cin) + 27 * cin * cout * 4
        return nbytes, 2 * 27 * cin * cout * v(s), BF16_FLOPS, 8 * cin * v(s)

    def dw_prologue_work(cin, cout, s):
        return (*conv_work(cin, cout, s), 3 * cin * v(s))

    def pool_work(c, s):
        return 2 * c * v(s) * (1 + 1 / 8), 0.0, BF16_FLOPS

    def pool_bwd_work(c, s):  # x, y, g read, dx written
        return 2 * c * v(s) * (2 + 2 / 8), 0.0, BF16_FLOPS

    def upconv_work(cin, cout, s):
        return 2 * v(s) * (cin + 8 * cout), 2 * 8 * cin * cout * v(s), BF16_FLOPS

    def head_work(cin, co, s):  # bf16 in, fp32 out, fp32 FMAs
        return v(s) * (2 * cin + 4 * co), 2 * cin * co * v(s), FP32_FLOPS

    def head_dx_work(co, cin, s):  # fp32 in, bf16 out
        return v(s) * (4 * co + 2 * cin), 2 * cin * co * v(s), FP32_FLOPS

    def head_dw_work(cin, co, s):  # bf16 x and fp32 ct in; dk's FMAs and db's adds
        return v(s) * (2 * cin + 4 * co), (2 * cin + 1) * co * v(s), FP32_FLOPS

    return {
        "conv3x3x3_cf_relu": (conv3.conv3x3x3_cf_relu, conv3.conv3x3x3_cf_relu_reference,
                              lib_conv, conv_inputs, CONV_SHAPES, BF16_ONE_ULP, conv_work,
                              "F.conv3d bf16 (no ReLU)"),
        "conv3x3x3_cf": (ng(conv3.conv3x3x3_cf), conv3.conv3x3x3_cf_reference, lib_conv,
                         conv_inputs, TRAIN_CONV_SHAPES, BF16_TWO_ROUNDINGS, conv_work,
                         "F.conv3d bf16"),
        "conv3x3x3_cf_dx": (conv3.conv3x3x3_cf_dx, conv3.conv3x3x3_cf_dx_reference, lib_dx,
                            dx_inputs, DX_SHAPES, BF16_ONE_ULP, conv_work, "F.conv3d bf16"),
        "conv3x3x3_cf_dw": (conv3.conv3x3x3_cf_dw, conv3.conv3x3x3_cf_dw_reference, lib_dw,
                            dw_inputs, DW_SHAPES, DW_TOL, conv_work,
                            "torch.nn.grad.conv3d_weight bf16"),
        "conv3x3x3_cf_stats": (ng(conv3_fused.conv3x3x3_cf_stats),
                               conv3_fused.conv3x3x3_cf_stats_reference, lib_conv, conv_inputs,
                               CONV0_SHAPES, STATS, stats_work,
                               "F.conv3d bf16, conv part only"),
        "conv3x3x3_cf_boundary_stats": (ng(conv3_fused.conv3x3x3_cf_boundary_stats),
                                        conv3_fused.conv3x3x3_cf_boundary_stats_reference,
                                        lib_boundary, boundary_inputs, CONV1_SHAPES, STATS,
                                        boundary_stats_work, "F.conv3d bf16, conv part only"),
        "conv3x3x3_cf_dx_epilogue": (conv3_fused.conv3x3x3_cf_dx_epilogue,
                                     conv3_fused.conv3x3x3_cf_dx_epilogue_reference,
                                     lib_dx_epilogue, dx_epilogue_inputs, CONV1_SHAPES,
                                     DX_EPILOGUE, dx_epilogue_work,
                                     "F.conv3d bf16 of the dx, conv part only"),
        "conv3x3x3_cf_dw_prologue": (conv3_fused.conv3x3x3_cf_dw_prologue,
                                     conv3_fused.conv3x3x3_cf_dw_prologue_reference,
                                     lib_dw_prologue, dw_prologue_inputs, CONV1_SHAPES, DW_TOL,
                                     dw_prologue_work,
                                     "torch.nn.grad.conv3d_weight bf16, conv part only"),
        "conv3x3x3_cf_boundary": (ng(conv3_fused.conv3x3x3_cf_boundary),
                                  conv3_fused.conv3x3x3_cf_boundary_reference, lib_boundary,
                                  boundary_inputs, CONV1_SHAPES, BF16_TWO_ROUNDINGS,
                                  boundary_work, "F.conv3d bf16, conv part only"),
        "max_pool2x_cf": (ng(pool.max_pool2x_cf), pool.max_pool2x_cf_reference,
                          lambda x: F.max_pool3d(x, 2, 2), pool_inputs, POOL_SHAPES, 0.0,
                          pool_work, "F.max_pool3d bf16"),
        "max_pool2x_cf_bwd": (pool.max_pool2x_cf_bwd, pool.max_pool2x_cf_bwd_reference,
                              lib_pool_bwd, pool_bwd_inputs, POOL_SHAPES, 0.0, pool_bwd_work,
                              "F.max_pool3d backward bf16 (first-match ties, not the same "
                              "function)"),
        "upconv2x_cf": (ng(upconv.upconv2x_cf), upconv.upconv2x_cf_reference, lib_upconv,
                        upconv_inputs, UPCONV_SHAPES, BF16_ONE_ULP, upconv_work,
                        "F.conv_transpose3d bf16"),
        "head1x1_cf": (ng(head.head1x1_cf), head.head1x1_cf_reference, lib_head, head_inputs,
                       HEAD_SHAPES, HEAD_TOL, head_work, "1x1x1 F.conv3d bf16"),
        "head1x1_cf_dx": (lambda ct, k: head.head1x1_cf_dx(ct, k, torch.bfloat16),
                          lambda ct, k: head.head1x1_cf_dx_reference(ct, k, torch.bfloat16),
                          lib_head_dx, head_dx_inputs, HEAD_DX_SHAPES, BF16_ONE_ULP,
                          head_dx_work, "1x1x1 F.conv3d fp32"),
        "head1x1_cf_dw": (head.head1x1_cf_dw, head.head1x1_cf_dw_reference, lib_head_dw,
                          head_dw_inputs, HEAD_DW_SHAPES, HEAD_DW, head_dw_work,
                          "torch.einsum fp32 of x.float() plus sum, the port's code before "
                          "the kernel"),
    }, randn


def bare_calls() -> dict:
    """name -> the call builder of each kernel, ready to launch bare
    (operands packed, scratch and outputs allocated outside any timing
    window)."""
    from multimodal_segmentation_project_tpu_torch.ops import conv3, conv3_fused, head, pool
    from multimodal_segmentation_project_tpu_torch.ops import upconv

    return {"conv3x3x3_cf_relu": conv3.relu_call, "conv3x3x3_cf": conv3.conv_call,
            "conv3x3x3_cf_dx": conv3.dx_call, "conv3x3x3_cf_stats": conv3_fused.stats_call,
            "conv3x3x3_cf_boundary_stats": conv3_fused.boundary_stats_call,
            "conv3x3x3_cf_boundary": conv3_fused.boundary_call,
            "conv3x3x3_cf_dx_epilogue": conv3_fused.dx_epilogue_call,
            "conv3x3x3_cf_dw": conv3.dw_call,
            "conv3x3x3_cf_dw_prologue": conv3_fused.dw_prologue_call,
            "max_pool2x_cf": pool.pool_call, "max_pool2x_cf_bwd": pool.bwd_call,
            "upconv2x_cf": upconv.upconv_call, "head1x1_cf": head.head_call,
            "head1x1_cf_dx": head.dx_call, "head1x1_cf_dw": head.dw_call}


# the conv-body instances of the train step (12 has no caller, 7 is eval's)
TRAIN_BODY = ("conv3x3x3_cf", "conv3x3x3_cf_dx", "conv3x3x3_cf_stats",
              "conv3x3x3_cf_boundary_stats", "conv3x3x3_cf_dx_epilogue")
# the dW body's instances: 2 over DW_SHAPES, 6 over CONV1_SHAPES
TRAIN_DW = ("conv3x3x3_cf_dw", "conv3x3x3_cf_dw_prologue")


def phase_kernels() -> dict:
    """Each kernel vs its plain version at every slice shape."""
    import torch

    plan, randn = _kernel_plan()
    bare = bare_calls()
    fail_unless(set(bare) == set(plan), "every kernel needs a bare call")
    results = {}
    for name, (kern, plain, lib, make, shapes, tol, work, lib_label) in plan.items():
        tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"), 0.0)
        bare_tot = 0.0
        max_abs = bytes_ms = ops_ms = 0.0
        for shape, mult in _count(shapes):
            inputs = make(*shape)
            err, rel, ok, sums = _errors(f"{name} {shape}", kern, plain, inputs, tol)
            ms = _time_ms(kern, inputs)
            plain_ms = _time_ms(plain, inputs)
            lib_ms = _time_ms(lib, inputs)
            nbytes, flops, peak, *fp32_flops = work(*shape)
            op_s = flops / peak + sum(fp32_flops) / FP32_FLOPS
            b_ms = max(nbytes / HBM_BYTES_PER_S, op_s) * 1e3
            bytes_ms += mult * nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms += mult * op_s * 1e3
            sums_label = "" if sums is None else f", sums at {sums:.4g} of their bound"
            bare_ms = _time_bare_ms(name, bare[name], inputs)
            bare_tot += mult * bare_ms
            bare_label = (f", bare launch {bare_ms:.4f} ms | kernel/library "
                          f"{ms / lib_ms:.3f}, bare/library {bare_ms / lib_ms:.3f}")
            print(f"[kernel] {name} {shape} x{mult}: max_abs_err {err:.4g} scaled {rel:.4g}"
                  f"{sums_label}, {_tol_label(tol)}: {'ok' if ok else 'FAIL'} | "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms, "
                  f"library {lib_ms:.4f} ms "
                  f"({lib_label}){bare_label}", flush=True)
            fail_unless(ok, f"{name} {shape}: error {err} (scaled {rel}) over tolerance")
            max_abs = max(max_abs, err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", b_ms),
                             ("library_ms", lib_ms)):
                tot[key] += mult * val
            del inputs
            torch.cuda.empty_cache()
        results[name] = {"max_abs_err": max_abs, **tot, "bare_ms": bare_tot,
                         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        print(f"[kernel] {name}: summed over one pass (eval forward or train step; "
              f"kernel 12 over the train step's conv1 shapes): "
              + ", ".join(f"{k} {v:.4f}" for k, v in tot.items())
              + f", bare_ms {bare_tot:.4f}", flush=True)
    step = {k: sum(results[n][k] for n in TRAIN_BODY) for k in ("ms", "bare_ms", "library_ms")}
    print(f"[kernel] conv body per train step ({', '.join(TRAIN_BODY)}): kernel as called "
          f"{step['ms']:.4f} ms, bare launches {step['bare_ms']:.4f} ms, library "
          f"{step['library_ms']:.4f} ms", flush=True)
    step = {k: sum(results[n][k] for n in TRAIN_DW) for k in ("ms", "bare_ms", "library_ms")}
    print(f"[kernel] dW body per train step ({', '.join(TRAIN_DW)}): as called / bare / "
          f"library {step['ms']:.4f} / {step['bare_ms']:.4f} / {step['library_ms']:.4f} ms",
          flush=True)
    # ragged shapes the slice does not reach: batch 2, odd extents, partial
    # channel chunks and channel groups; correctness only
    f32 = torch.float32
    x_odd = (randn(2, 3, 5, 7, 9, scale=2.0, dtype=f32).round().to(torch.bfloat16))
    edges = [
        ("conv3x3x3_cf_relu", (randn(2, 3, 5, 7, 37), randn(3, 3, 3, 3, 8, scale=0.2, dtype=f32),
                               randn(8, scale=0.1, dtype=f32))),
        ("conv3x3x3_cf", (randn(1, 40, 3, 9, 20), randn(3, 3, 3, 40, 20, scale=0.05, dtype=f32),
                          randn(20, scale=0.1, dtype=f32))),
        ("conv3x3x3_cf_dx", (randn(2, 20, 3, 9, 37), randn(3, 3, 3, 40, 20, scale=0.05,
                                                           dtype=f32))),
        ("max_pool2x_cf", (randn(2, 3, 5, 7, 9),)),
        ("max_pool2x_cf_bwd", (x_odd, plan["max_pool2x_cf"][1](x_odd), randn(2, 3, 2, 3, 4))),
        ("conv3x3x3_cf_stats", (randn(2, 40, 3, 9, 20),
                                randn(3, 3, 3, 40, 20, scale=0.05, dtype=f32),
                                randn(20, scale=0.1, dtype=f32))),
    ]
    a2, t2 = (randn(2, 40, scale=s, dtype=f32) for s in (1.0, 0.5))
    w40 = randn(3, 3, 3, 40, 20, scale=0.05, dtype=f32)
    for name in ("conv3x3x3_cf_boundary_stats", "conv3x3x3_cf_boundary"):
        edges.append((name, (randn(2, 40, 3, 9, 37), w40, randn(20, scale=0.1, dtype=f32),
                             a2, t2)))
    edges.append(("conv3x3x3_cf_dx_epilogue", (randn(2, 20, 3, 9, 37, scale=1e-2), w40,
                                               randn(2, 40, 3, 9, 37), a2, t2)))

    def unaligned(*shape, dtype=torch.bfloat16):
        """A contiguous tensor whose data starts one element (2 bytes in bf16,
        4 in fp32) past a 16-byte boundary."""
        return randn(math.prod(shape) + 1, dtype=dtype)[1:].view(*shape)

    # the upconv (10): W = 7, 9, 37 and 8 (V % 8 != 0: 2-byte staging; W % 4
    # != 0: 4-byte stores), Cin = 70 (five K steps, the last partial) and 16,
    # Cout = 20 (a partial channel group) and 64, batch 2, a partial last
    # tile, an unaligned view; the head's dx (11-dx): V % 8 != 0, Cf = 16, 40
    # and 64, batch 2, an unaligned fp32 view; the head's forward (11) and
    # weight gradient (11-dw): V % 8 != 0, Cf = 5, 16, 40 and 64 (11-dw: from
    # one partial channel slice to ten), classes 1, 3, 4 and 8, batch 2,
    # unaligned bf16 and fp32 views, and 2 x 67^3 voxels, where 11-dw's
    # threads walk one or two groups each
    for x, cout in ((randn(2, 70, 3, 5, 7), 20), (randn(2, 16, 3, 4, 9), 64),
                    (randn(1, 16, 2, 3, 37), 20), (randn(1, 70, 3, 5, 8), 20),
                    (unaligned(2, 16, 2, 4, 8), 64)):
        edges.append(("upconv2x_cf", (x, randn(2, 2, 2, x.shape[1], cout, scale=0.1, dtype=f32),
                                      randn(cout, scale=0.1, dtype=f32))))
    for ct, cf in ((randn(2, 3, 3, 5, 7, dtype=f32), 40), (randn(2, 4, 2, 4, 8, dtype=f32), 64),
                   (unaligned(2, 4, 2, 4, 8, dtype=f32), 40), (randn(1, 4, 3, 3, 3, dtype=f32), 16)):
        edges.append(("head1x1_cf_dx", (ct, randn(cf, ct.shape[1], dtype=f32))))
    for x, co in ((randn(2, 5, 3, 5, 7), 3), (randn(2, 40, 3, 5, 7), 8),
                  (randn(2, 64, 2, 4, 8), 1), (randn(1, 64, 3, 3, 3), 4),
                  (unaligned(2, 40, 2, 4, 8), 4), (randn(2, 16, 2, 4, 8), 8),
                  (randn(2, 16, 67, 67, 67), 4)):
        cf = x.shape[1]
        edges.append(("head1x1_cf", (x, randn(co, cf, scale=cf ** -0.5, dtype=f32).t(),
                                     randn(co, scale=0.1, dtype=f32))))
        ct = randn(x.shape[0], co, *x.shape[2:], scale=1e-3, dtype=f32)
        edges.append(("head1x1_cf_dw", (x, ct)))
    edges.append(("head1x1_cf_dw", (randn(2, 40, 2, 4, 8), unaligned(2, 4, 2, 4, 8, dtype=f32))))

    # the dW body (2, 6): W = 9, 20, 37 and an unaligned view (2-byte staging),
    # Cin = 1 and 40 (three chunks, the last partial), Cout = 20 and 48, batch 2
    for x, g in ((randn(2, 40, 3, 9, 37), randn(2, 20, 3, 9, 37)),
                 (randn(2, 40, 3, 9, 9), randn(2, 48, 3, 9, 9)),
                 (randn(1, 1, 3, 9, 20), randn(1, 20, 3, 9, 20)),
                 (randn(1, 40, 3, 9, 20), randn(1, 48, 3, 9, 20)),
                 (unaligned(2, 16, 3, 9, 16), unaligned(2, 20, 3, 9, 16))):
        a, t = (randn(*x.shape[:2], scale=s, dtype=f32) for s in (1.0, 0.5))
        edges += [("conv3x3x3_cf_dw", (x, g)), ("conv3x3x3_cf_dw_prologue", (x, g, a, t))]
    for name, args in edges:
        kern, plain, *_, tol, _, _ = plan[name]
        label = f"{name} edge input {tuple(args[0].shape)}"
        if name in TRAIN_DW:
            label += f", Cout {args[1].shape[1]}"
        elif name == "upconv2x_cf":
            label += f", Cout {args[1].shape[4]}"
        elif name == "head1x1_cf_dx":
            label += f", Cf {args[1].shape[0]}"
        elif name in ("head1x1_cf", "head1x1_cf_dw"):
            label += f", classes {args[1].shape[1]}"
        if any(a.data_ptr() % 16 for a in args[:2]):
            label += ", unaligned"
        err, rel, ok, _ = _errors(label, kern, plain, [args], tol)
        print(f"[kernel] {label}: scaled err {rel:.4g} {'ok' if ok else 'FAIL'}", flush=True)
        fail_unless(ok, f"{label}: error {err} over tolerance")

    # the kernels that sum across blocks sum per-block partials in a fixed
    # order, and the others sum in a fixed order within a thread: the same
    # bits every run
    x32, x16 = randn(1, 32, 192, 192, 192), randn(1, 16, 192, 192, 192)
    g16 = randn(1, 16, 192, 192, 192, scale=1e-2)
    a16, t16 = randn(1, 16, dtype=f32) + 1.0, randn(1, 16, scale=0.5, dtype=f32)
    w16, b16 = randn(3, 3, 3, 16, 16, scale=0.1, dtype=f32), randn(16, scale=0.1, dtype=f32)
    twice = [
        ("conv3x3x3_cf_dw", (32, 16, 192), (x32, g16)),
        ("conv3x3x3_cf_stats", (32, 16, 192),
         (x32, randn(3, 3, 3, 32, 16, scale=0.05, dtype=f32), b16)),
        ("conv3x3x3_cf_boundary_stats", (16, 16, 192), (x16, w16, b16, a16, t16)),
        ("conv3x3x3_cf_dx_epilogue", (16, 16, 192), (g16, w16, x16, a16, t16)),
        ("conv3x3x3_cf_dw_prologue", (16, 16, 192), (x16, g16, a16, t16)),
        ("upconv2x_cf", (32, 16, 96), (randn(1, 32, 96, 96, 96),
                                       randn(2, 2, 2, 32, 16, scale=0.2, dtype=f32), b16)),
        ("head1x1_cf_dx", (4, 16, 192), (randn(1, 4, 192, 192, 192, scale=1e-3, dtype=f32),
                                         randn(16, 4, scale=0.5, dtype=f32))),
        ("head1x1_cf_dw", (16, 4, 192), (x16, randn(1, 4, 192, 192, 192, scale=1e-3,
                                                     dtype=f32))),
    ]
    for name, shape, args in twice:
        kern = plan[name][0]
        first, second = kern(*args), kern(*args)
        if isinstance(first, torch.Tensor):
            first, second = (first,), (second,)
        same = all(torch.equal(u, v) for u, v in zip(first, second))
        print(f"[kernel] {name} {shape} run twice on the same inputs: "
              f"{'the same bits' if same else 'DIFFERENT bits'}", flush=True)
        fail_unless(same, f"{name} is not deterministic")
    return results


# background, spleen, liver, kidneys: CT in HU; MRI in arbitrary T1-like
# units, which the MRI preprocessing z-scores; and the noise's sigma
INTENSITIES = {"ct": ((-40.0, 110.0, 60.0, 180.0), 20.0),
               "mri": ((150.0, 420.0, 520.0, 650.0), 40.0)}


def write_case(path_img: Path, path_lbl: Path, size: int, seed: int,
               modality: str = "ct") -> None:
    """One synthetic abdominal CT (HU) or MRI volume and its labels: a liver,
    a spleen and two kidneys as ellipsoids with organ-typical intensities
    over soft-tissue noise. Uncompressed NIfTI, so host decode stays short."""
    import numpy as np

    from multimodal_segmentation_project_tpu_torch.data import save_nifti

    rng = np.random.default_rng(seed)
    g = (np.arange(size, dtype=np.float32) + 0.5) / size
    z, y, x = g[:, None, None], g[None, :, None], g[None, None, :]
    lbl = np.zeros((size,) * 3, np.uint8)
    organs = [  # (label, centre, radii) in unit coordinates
        (2, (0.45, 0.35, 0.55), (0.22, 0.18, 0.25)),  # liver
        (1, (0.50, 0.70, 0.35), (0.10, 0.09, 0.12)),  # spleen
        (3, (0.55, 0.40, 0.25), (0.07, 0.06, 0.09)),  # kidneys
        (3, (0.55, 0.65, 0.75), (0.07, 0.06, 0.09)),
    ]
    for label, (cz, cy, cx), (rz, ry, rx) in organs:
        jit = rng.uniform(-0.03, 0.03, 3)
        inside = (((z - cz - jit[0]) / rz) ** 2 + ((y - cy - jit[1]) / ry) ** 2
                  + ((x - cx - jit[2]) / rx) ** 2) <= 1.0
        lbl[inside] = label
    levels, sigma = INTENSITIES[modality]
    img = np.array(levels, np.float32)[lbl] + rng.normal(0.0, sigma, lbl.shape).astype(np.float32)
    affine = np.diag([1.5, 1.5, 1.5, 1.0])
    save_nifti(img, str(path_img), affine=affine)
    save_nifti(lbl.astype(np.int16), str(path_lbl), affine=affine)


def write_split(root: Path, split: str, n: int, size: int, seed: int,
                modality: str = "ct") -> None:
    case_dir = root / split / f"synth_{modality}"
    (case_dir / "images").mkdir(parents=True)
    (case_dir / "labels").mkdir(parents=True)
    for i in range(n):
        write_case(case_dir / "images" / f"case{i:02d}.nii",
                   case_dir / "labels" / f"case{i:02d}.nii", size, seed=seed + i,
                   modality=modality)


def make_model(dtype, seed: int = SEED, dropout_rate: float = 0.0):
    """Default-width UNet3D with seeded He-normal weights and seeded,
    non-trivial eval BatchNorm statistics (so the fold is exercised)."""
    import torch

    from multimodal_segmentation_project_tpu_torch.models import UNet3D

    gen = torch.Generator().manual_seed(seed)
    model = UNet3D(in_channels=1, out_channels=4, features=(16, 32, 64, 128),
                   dropout_rate=dropout_rate, dtype=dtype, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                n = m.num_features
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model.eval()


def _check_eval_results(exp: Path, model_name: str, n_cases: int, size: int) -> list:
    """The eval CLI's artifacts under ``exp``; returns its per-volume times."""
    import csv

    import numpy as np

    from multimodal_segmentation_project_tpu_torch.data import load_nifti

    (rd,) = exp.glob(f"test_results_{model_name}_*")
    metrics = json.loads((rd / "metrics" / "metrics.json").read_text())
    for key in ("mean_dice_overall", "mean_iou_overall", "total_inference_time"):
        fail_unless(np.isfinite(metrics.get(key, np.nan)), f"metrics.json: {key} missing")
    with open(rd / "metrics" / "per_sample_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    fail_unless(len(rows) == n_cases, f"per_sample_metrics.csv has {len(rows)} rows")
    preds = sorted((rd / "predictions").glob("*_pred.nii.gz"))
    fail_unless(len(preds) == n_cases, f"{len(preds)} predictions written")
    for p in preds:
        img = load_nifti(str(p))
        fail_unless(img.data.dtype == np.uint8 and img.data.shape == (size,) * 3,
                    f"{p.name}: {img.data.dtype} {img.data.shape}")
        fail_unless(set(np.unique(img.data)) <= {0, 1, 2, 3}, f"{p.name}: labels outside 0..3")
    print(f"[eval] artifacts ok in {rd.relative_to(ROOT)}: metrics.json, {len(rows)} CSV rows, "
          f"{len(preds)} uint8 predictions | mean dice {metrics['mean_dice_overall']:.4f}",
          flush=True)
    return [float(r["inference_time"]) for r in rows]


def _run_eval_cli(pth: str, data: Path, exp: Path, model_name: str, n_cases: int,
                  size: int) -> dict:
    """The eval CLI on the GPU; checks per-forward launches and artifacts."""
    import torch

    from multimodal_segmentation_project_tpu_torch import ops
    from multimodal_segmentation_project_tpu_torch.workloads import test_model

    args = test_model.build_parser().parse_args([
        "--model_path", pth, "--data_root", str(data), "--experiment_dir", str(exp),
        "--model_name", model_name, "--no_visualizations",
    ])
    ops.reset_launch_counts()
    test_model.main(args)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    n_forwards = 1 + n_cases  # the untimed warm-up, then one per case (batch 1)
    print(f"[eval] launches over {n_forwards} forwards: {counts}", flush=True)
    for name, n in counts.items():
        want = PER_FORWARD.get(name, 0) * n_forwards
        fail_unless(n == want, f"{name}: {n} launches, want {want} over {n_forwards} forwards")
    per_volume = _check_eval_results(exp, model_name, n_cases, size)
    print(f"[eval] per-volume inference (host clock, H2D + forward + argmax + metrics + D2H) "
          f"{[round(t, 4) for t in per_volume]} s", flush=True)
    return counts


def phase_slice(n_cases: int = 2, size: int = 192) -> dict:
    """The port's eval CLI on the GPU with a seeded, BN-folded model."""
    import torch

    from multimodal_segmentation_project_tpu_torch.engine.checkpoint import save_pth

    data = SCRATCH / "eval_data"
    t0 = time.perf_counter()
    write_split(data, "test", n_cases, size, SEED)
    pth = save_pth(str(SCRATCH / "unet3d_seed0.pth"), make_model(torch.bfloat16))
    print(f"[slice] wrote {n_cases} synthetic {size}^3 CT cases and {Path(pth).name} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    counts = _run_eval_cli(pth, data, SCRATCH / "eval_exp", "smoke", n_cases, size)

    # the forward alone, device-resident input, CUDA events, distinct inputs
    model = make_model(torch.bfloat16).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xs = [torch.rand(1, 1, size, size, size, generator=gen, device="cuda")
          for _ in range(N_TIMED)]
    with torch.inference_mode():
        fwd_ms = _time_ms(lambda x: model(x), [(x,) for x in xs])
        torch.cuda.reset_peak_memory_stats()
        model(xs[0])
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[slice] UNet3D eval forward at {size}^3, batch 1, bf16: median {fwd_ms:.3f} ms "
          f"(CUDA events, {N_TIMED} distinct inputs) | peak allocated {peak:.2f} GiB", flush=True)
    return counts


# slice parity: bf16 on the GPU against fp32 on the CPU, full width.
# bf16 rounds every activation (8 significant bits) through 22 convs, so
# logits move by about a percent of their range; a voxel whose two top
# logits are that close may change class.
PARITY_SIZE = 64
PARITY_LOGIT_TOL = 0.05   # max |gpu - cpu| / max |cpu|
PARITY_ARGMAX_MIN = 0.98  # share of voxels with the same class


def _parity_case(seed: int, s: int):
    import numpy as np
    import torch

    from multimodal_segmentation_project_tpu_torch.data import load_nifti, preprocess_ct

    img_p, lbl_p = SCRATCH / f"parity_img{seed}.nii", SCRATCH / f"parity_lbl{seed}.nii"
    write_case(img_p, lbl_p, s, seed=seed)
    img = preprocess_ct(load_nifti(str(img_p)).data.astype(np.float32))
    lbl = load_nifti(str(lbl_p)).data.astype(np.int32)
    return torch.from_numpy(img)[None, None], torch.from_numpy(lbl)[None]


def phase_parity() -> None:
    import torch

    s = PARITY_SIZE
    x, _ = _parity_case(SEED + 100, s)
    with torch.inference_mode():
        want = make_model(torch.float32)(x)
        got = make_model(torch.bfloat16).cuda()(x.cuda()).cpu()
    fail_unless(got.shape == want.shape == (1, 4, s, s, s), f"shapes {got.shape} {want.shape}")
    fail_unless(bool(torch.isfinite(got).all()), "non-finite logits on the GPU")
    err = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
    ok = err <= PARITY_LOGIT_TOL and agree >= PARITY_ARGMAX_MIN
    print(f"[parity] {s}^3 full width, GPU bf16 kernels vs CPU fp32 plain: scaled max logit "
          f"error {err:.4g} (<= {PARITY_LOGIT_TOL}), argmax agreement {agree:.6f} "
          f"(>= {PARITY_ARGMAX_MIN}) {'ok' if ok else 'FAIL'}", flush=True)
    fail_unless(ok, "slice parity over tolerance")


TRAIN_SPLITS = {"train": 2, "val": 1, "test": 1}
TRAIN_EPOCHS = 2
N_STEPS_TIMED = 6
N_STEPS_PROFILED = 3


OTHER_CATEGORY = "elementwise and other torch kernels"


def _kernel_category(name: str) -> str:
    """Device-time category of a kernel in the profiler trace."""
    for key, cat in (("conv3_dw", "conv3_dw (dW kernels, plain and prologue: partial sums + "
                                  "reduce)"),
                     ("conv3_stats_reduce", "conv3_stats_reduce (the fused convs' channel sums)"),
                     ("conv3_kernel", "conv3 (forward, fused stats/boundary and dx kernels)"),
                     ("pool2x_bwd", "pool2x_bwd kernel"), ("pool2x", "pool2x kernel"),
                     ("upconv_d2s", "upconv_d2s kernel"), ("head1x1", "head1x1 kernels"),
                     ("Memcpy", "memcpy / memset"), ("Memset", "memcpy / memset")):
        if key in name:
            return cat
    low = name.lower()
    if any(k in low for k in ("cudnn", "xmma", "conv", "implicit", "wgrad", "dgrad")):
        return "cuDNN (deep region convs and their layout kernels)"
    if any(k in low for k in ("gemm", "cutlass", "sm90")):
        return "matmul (upconv backward)"
    if "reduce" in low:
        return "reductions (BatchNorm, losses, metrics)"
    if "cat" in low:
        return "torch.cat (skip concat)"
    return OTHER_CATEGORY


def _profile_steps(run, inputs) -> None:
    """Device time of a few train steps by kernel category, the largest
    elementwise kernels by name, and the device's idle share over the
    window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for args in inputs:
            run(*args)
        torch.cuda.synchronize()
    spans, cats, other = [], {}, {}
    for evt in prof.events():
        # device kernels and copies only: a user annotation's device-side span
        # (Optimizer.step#AdamW.step) overlaps the kernels it launched
        if ("cuda" not in str(getattr(evt, "device_type", "")).lower()
                or getattr(evt, "is_user_annotation", False)):
            continue
        start, end = evt.time_range.start, evt.time_range.end
        if end <= start:
            continue
        spans.append((start, end))
        cat = _kernel_category(evt.name)
        n, t = cats.get(cat, (0, 0.0))
        cats[cat] = (n + 1, t + (end - start))
        if cat == OTHER_CATEGORY:
            n, t = other.get(evt.name, (0, 0.0))
            other[evt.name] = (n + 1, t + (end - start))
    fail_unless(bool(spans), "the profiler recorded no device time")
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    n = len(inputs)
    total = sum(t for _, t in cats.values())
    for cat, (cnt, t) in sorted(cats.items(), key=lambda kv: -kv[1][1]):
        print(f"[profile] {cat}: {t / n / 1e3:.3f} ms/step ({t / total * 100:.1f} %), "
              f"{cnt / n:.0f} launches/step", flush=True)
    for name, (cnt, t) in sorted(other.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"[profile]   of which {t / n / 1e3:.3f} ms/step, {cnt / n:.0f} launches/step: "
              f"{name[:160]}", flush=True)
    print(f"[profile] {n} steps: device busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms "
          f"window, idle share {1 - busy / window:.4f}; summed kernel time "
          f"{total / n / 1e3:.3f} ms/step", flush=True)


def phase_train(size: int = 192) -> dict:
    """The port's train CLI at full width on the GPU, then the step alone.
    The CLI runs run_training.sh's recipe (batch 1, lr 1e-3, wd 1e-4,
    bf16, ce_tversky, early stopping) with gradient accumulation 2, not 8,
    so that its four steps apply two AdamW updates."""
    import csv

    import torch

    from multimodal_segmentation_project_tpu_torch import ops
    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import make_train_step
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn
    from multimodal_segmentation_project_tpu_torch.workloads import train_unet

    data, exp = SCRATCH / "train_data", SCRATCH / "train_exp"
    t0 = time.perf_counter()
    for i, (split, n) in enumerate(TRAIN_SPLITS.items()):
        write_split(data, split, n, size, SEED + 10 * (i + 1))
    print(f"[train] wrote {TRAIN_SPLITS} synthetic {size}^3 CT cases in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    args = train_unet.build_parser().parse_args([
        "--data_root", str(data), "--experiment_dir", str(exp), "--batch_size", "1",
        "--epochs", str(TRAIN_EPOCHS), "--lr", "1e-3", "--weight_decay", "1e-4",
        "--gradient_accumulation_steps", "2", "--mixed_precision", "bf16",
        "--loss", "ce_tversky", "--early_stopping", "--patience", "10", "--seed", "42",
    ])
    args.experiment_name = "smoke_train"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    train_unet.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = TRAIN_SPLITS["train"] * TRAIN_EPOCHS
    evals = TRAIN_SPLITS["val"] * TRAIN_EPOCHS
    print(f"[train] CLI: {TRAIN_EPOCHS} epochs, {steps} steps and {evals} validation forwards "
          f"in {secs:.2f} s; launches {counts}", flush=True)
    for name, n in counts.items():
        want = PER_STEP.get(name, 0) * steps + PER_FORWARD.get(name, 0) * evals
        fail_unless(n == want, f"{name}: {n} launches, want {want} ({PER_STEP.get(name, 0)}"
                               f"/step, {PER_FORWARD.get(name, 0)}/forward)")
    with open(exp / "smoke_train" / "logs" / "train_log.csv") as f:
        rows = list(csv.DictReader(f))
    fail_unless(len(rows) == TRAIN_EPOCHS, f"train_log.csv has {len(rows)} rows")
    for r in rows:
        for key in ("train_loss", "val_loss", "train_dice", "val_dice"):
            fail_unless(math.isfinite(float(r[key])), f"epoch {r['epoch']}: {key} {r[key]}")
    print("[train] epochs (loss, dice): " + "; ".join(
        f"{r['epoch']}: train {float(r['train_loss']):.4f}/{float(r['train_dice']):.4f} "
        f"val {float(r['val_loss']):.4f}/{float(r['val_dice']):.4f}" for r in rows), flush=True)
    best = exp / "smoke_train" / "checkpoints" / "best_model_smoke_train.pth"
    fail_unless(best.exists(), f"no best checkpoint at {best}")
    _run_eval_cli(str(best), data, SCRATCH / "train_eval_exp", "smoke_trained",
                  TRAIN_SPLITS["test"], size)

    # the step alone: distinct device-resident inputs, as the CLI runs it
    model = make_model(torch.bfloat16, dropout_rate=0.1).cuda()
    state = TrainState(model, 1e-3, 1e-4)
    step = make_train_step(get_loss_fn("ce_tversky"), augment=True, nan_guard=True)
    dgen = torch.Generator(device="cuda").manual_seed(SEED)

    def batch(i):
        images = torch.rand(1, 1, size, size, size, generator=dgen, device="cuda")
        labels = torch.randint(0, 4, (1, size, size, size), generator=dgen, device="cuda",
                               dtype=torch.int32)
        return images, labels, torch.Generator().manual_seed(i)

    for i in range(2):  # warm-up: cuDNN's algorithm choice, allocator growth
        step(state, *batch(i))
    times = []
    for i in range(N_STEPS_TIMED):
        images, labels, gen = batch(100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, images, labels, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        fail_unless(math.isfinite(float(metrics["loss"])), f"timed step {i}: non-finite loss")
    torch.cuda.reset_peak_memory_stats()
    step(state, *batch(200))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(times)
    print(f"[train] step at {size}^3, batch 1, bf16, ce_tversky, augmentation on: median "
          f"{med:.3f} ms over {N_STEPS_TIMED} distinct inputs (host clock around "
          f"synchronize; all {[round(t, 3) for t in times]}) | peak allocated {peak:.2f} GiB",
          flush=True)
    _profile_steps(lambda *args: step(state, *args),
                   [batch(300 + i) for i in range(N_STEPS_PROFILED)])
    return counts


# The other three workloads, per step (default widths, 192^3). The train
# step's counts are its forward's and its backward's. A distillation step is
# a train step plus the teacher's eval forward. A DANN step runs two whole
# train-mode forwards (source, then target), the source's whole backward,
# and the target's backward from the bottleneck's mean down through the
# bottleneck (cuDNN) and the encoder only, since its logits are dropped:
# the four pools, enc0-enc2's fused blocks (dx epilogue and prologue dW of
# conv1, dW of conv0) and the dx of enc1's and enc2's conv0 (enc0's conv0
# takes the image, which needs no gradient).
STEP_FORWARD = {"conv3x3x3_cf_stats": 5, "conv3x3x3_cf_boundary_stats": 5, "conv3x3x3_cf": 1,
                "max_pool2x_cf": 4, "upconv2x_cf": 3, "head1x1_cf": 1}
ENCODER_BACKWARD = {"conv3x3x3_cf_dx": 2, "conv3x3x3_cf_dx_epilogue": 3, "conv3x3x3_cf_dw": 3,
                    "conv3x3x3_cf_dw_prologue": 3, "max_pool2x_cf_bwd": 4}


def _add_counts(*counts: dict) -> dict:
    out: dict = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


PER_DISTILL_STEP = _add_counts(PER_STEP, PER_FORWARD)
PER_DANN_STEP = _add_counts(PER_STEP, STEP_FORWARD, ENCODER_BACKWARD)
# the recipes' shared flags (run_finetune_ct.sh, run_distillation.sh,
# run_dann.sh), with one epoch and gradient accumulation 2, not 8, as phase 6
RECIPE = ["--batch_size", "1", "--epochs", "1", "--weight_decay", "1e-4",
          "--gradient_accumulation_steps", "2", "--mixed_precision", "bf16",
          "--early_stopping", "--patience", "10", "--seed", "42"]
# the workloads phase's device: a CPU rehearsal of the phase, at a small
# size, sets it to "cpu"
DEVICE = "cuda"
DANN_SPLITS = {"train": ("mri", 1), "dann_add_labeled": ("ct", 1), "val": ("ct", 1),
               "target": ("ct", 1), "dann_add_unlabeled": ("ct", 1)}
LAMBDA_DOMAIN = 0.2


def _run_workload(experiment: str, argv: list, steps: int, per_step: dict, evals: int,
                  log_name: str, columns: tuple) -> Path:
    """One experiment through the port's orchestrator on the GPU: the exact
    launches per kernel over its steps and validation forwards, finite CSV
    rows; returns the run's directory."""
    import csv

    import torch

    from multimodal_segmentation_project_tpu_torch import ops
    from multimodal_segmentation_project_tpu_torch.workloads import main as orchestrator

    exp = SCRATCH / f"{experiment}_exp"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    orchestrator.main(["--experiment", experiment, "--experiment_dir", str(exp),
                       "--device", DEVICE, *argv])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"[{experiment}] main.py --experiment {experiment}: {steps} steps and {evals} "
          f"validation forwards in {secs:.2f} s; launches {counts}", flush=True)
    for name, n in counts.items():
        want = per_step.get(name, 0) * steps + PER_FORWARD.get(name, 0) * evals
        fail_unless(n == want, f"{experiment}: {name}: {n} launches, want {want} ("
                               f"{per_step.get(name, 0)}/step, {PER_FORWARD.get(name, 0)}/forward)")
    (run,) = [p for p in exp.iterdir() if p.is_dir()]
    with open(run / "logs" / log_name) as f:
        rows = list(csv.DictReader(f))
    fail_unless(len(rows) == 1, f"{experiment}: {log_name} has {len(rows)} rows")
    for key in columns:
        fail_unless(math.isfinite(float(rows[0][key])), f"{experiment}: {key} {rows[0][key]}")
    print(f"[{experiment}] epoch 1: " + ", ".join(f"{k} {float(rows[0][k]):.4f}" for k in columns),
          flush=True)
    return run


def _time_step(label: str, step, batch, per_step: dict, size: int) -> None:
    """A step alone: its launches counted over one call, then the median of
    N_STEPS_TIMED calls on distinct device-resident inputs after two warm-up
    calls (host clock around synchronize), the peak allocated memory, and
    a profiled breakdown of N_STEPS_PROFILED calls."""
    import torch

    from multimodal_segmentation_project_tpu_torch import ops

    for i in range(2):  # warm-up: cuDNN's algorithm choice, allocator growth
        step(*batch(i))
    inputs = batch(50)
    ops.reset_launch_counts()
    step(*inputs)
    torch.cuda.synchronize()
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    fail_unless(counts == {k: n for k, n in per_step.items() if n},
                f"{label} step launches {counts}, want {per_step}")
    times = []
    for i in range(N_STEPS_TIMED):
        inputs = batch(100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(*inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        fail_unless(math.isfinite(float(metrics["loss"])), f"timed {label} step {i}: loss")
    torch.cuda.reset_peak_memory_stats()
    step(*batch(200))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{label}] step at {size}^3, batch 1, bf16: median {statistics.median(times):.3f} ms "
          f"over {N_STEPS_TIMED} distinct inputs (host clock around synchronize; all "
          f"{[round(t, 3) for t in times]}) | peak allocated {peak:.2f} GiB | launches per step "
          f"{sum(counts.values())}: {counts}", flush=True)
    _profile_steps(step, [batch(300 + i) for i in range(N_STEPS_PROFILED)])


def phase_workloads(size: int = 192) -> None:
    """Fine-tune, distillation and DANN through the port's orchestrator at
    full width, from phase 6's data and best checkpoint (the pretrained
    model and the teacher), each one epoch of two steps; then the
    distillation and DANN steps alone, and one DANN step against the CPU."""
    import torch

    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import (
        make_dann_step,
        make_distill_step,
    )
    from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator
    from multimodal_segmentation_project_tpu_torch.ops.losses import (
        distillation_loss,
        get_loss_fn,
    )

    data = SCRATCH / "train_data"  # phase 6's: 2 train, 1 val, 1 test CT cases
    best = SCRATCH / "train_exp" / "smoke_train" / "checkpoints" / "best_model_smoke_train.pth"
    steps, evals = TRAIN_SPLITS["train"], TRAIN_SPLITS["val"]

    run = _run_workload(
        "finetune", ["--pretrained_model", str(best), "--data_root", str(data), "--lr", "1e-4",
                     "--modalities", "ct", "--n_samples", "5", "--freeze_encoder", *RECIPE],
        steps, PER_STEP, evals, "finetune_log.csv", ("train_loss", "val_loss", "val_dice"))
    (tuned,) = (run / "checkpoints").glob("best_finetuned_model_*.pth")
    before = torch.load(best, weights_only=True)["model_state_dict"]
    after = torch.load(tuned, weights_only=True)["model_state_dict"]
    names = [n for n, _ in make_model(torch.float32).named_parameters()]
    frozen = [n for n in names if n.startswith(("encoder.", "bottleneck."))]
    changed = [n for n in frozen if not torch.equal(before[n], after[n])]
    moved = [n for n in names if n not in frozen and not torch.equal(before[n], after[n])]
    print(f"[finetune] {tuned.name}: {len(frozen)} encoder and bottleneck parameters, "
          f"{len(changed)} changed; {len(moved)} of the other {len(names) - len(frozen)} moved",
          flush=True)
    fail_unless(not changed, f"frozen parameters changed: {changed}")
    fail_unless(bool(moved), "the fine-tune moved no parameter")

    run = _run_workload(
        "distill", ["--teacher_model", str(best), "--data_root", str(data), "--lr", "1e-3",
                    "--modalities", "ct", "--alpha", "0.7", "--temperature", "2.0",
                    "--n_samples", "5", *RECIPE],
        steps, PER_DISTILL_STEP, evals, "distill_log.csv", ("train_loss", "val_loss", "val_dice"))
    ckpts = sorted(p.name for p in (run / "checkpoints").iterdir())
    fail_unless(ckpts == [f"best_student_{run.name}.pth"], f"distill checkpoints {ckpts}")

    dann_data = SCRATCH / "dann_data"
    for i, (split, (modality, n)) in enumerate(DANN_SPLITS.items()):
        write_split(dann_data, split, n, size, SEED + 400 + 10 * i, modality)
    n_src = DANN_SPLITS["train"][1] + DANN_SPLITS["dann_add_labeled"][1]
    n_tgt = DANN_SPLITS["target"][1] + DANN_SPLITS["dann_add_unlabeled"][1]
    run = _run_workload(
        "dann", ["--source_modality", "mri", "--target_modality", "ct", "--data_root",
                 str(dann_data), "--lr", "1e-3", "--lambda_domain", str(LAMBDA_DOMAIN),
                 "--loss", "ce_tversky", "--pretrained_model", str(best), *RECIPE],
        min(n_src, n_tgt), PER_DANN_STEP, DANN_SPLITS["val"][1], "train_log.csv",
        ("train_loss", "task_loss", "domain_loss", "val_loss", "val_dice"))
    (dann_best,) = (run / "checkpoints").glob("best_model_*.pth")
    saved = torch.load(dann_best, weights_only=True)
    fail_unless("discriminator_state_dict" in saved, "no discriminator in the DANN checkpoint")
    _run_eval_cli(str(dann_best), data, SCRATCH / "dann_eval_exp", "smoke_dann",
                  TRAIN_SPLITS["test"], size)

    # the two steps alone, from seeded weights, on distinct device-resident inputs
    dgen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def volume():
        return torch.rand(1, 1, size, size, size, generator=dgen, device=DEVICE)

    def labels():
        return torch.randint(0, 4, (1, size, size, size), generator=dgen, device=DEVICE,
                             dtype=torch.int32)

    student = TrainState(make_model(torch.bfloat16, dropout_rate=0.1).to(DEVICE), 1e-3, 1e-4)
    teacher = make_model(torch.bfloat16, seed=SEED + 1).to(DEVICE).requires_grad_(False)
    distill = make_distill_step(
        lambda s, t, y: distillation_loss(s, t, y, alpha=0.7, temperature=2.0), nan_guard=True)
    _time_step("distill", lambda *a: distill(student, teacher, *a),
               lambda i: (volume(), labels(), torch.Generator().manual_seed(i)), PER_DISTILL_STEP,
               size)
    del student, teacher

    seg = TrainState(make_model(torch.bfloat16, dropout_rate=0.1).to(DEVICE), 1e-3, 1e-4)
    disc = TrainState(DomainDiscriminator(256, generator=torch.Generator().manual_seed(SEED))
                      .to(DEVICE), 1e-3, 1e-4)
    dann = make_dann_step(get_loss_fn("ce_tversky"), LAMBDA_DOMAIN, nan_guard=True)
    _time_step("dann", lambda *a: dann(seg, disc, *a),
               lambda i: (volume(), labels(), volume(), torch.Generator().manual_seed(i)),
               PER_DANN_STEP, size)
    del seg, disc
    _dann_parity()


# DANN parity: one step at 64^3, full width, dropout 0 in the UNet3D and the
# discriminator's 0.2 (its masks are drawn on the CPU generator, so every
# side gets the same), from the same weights, three ways as phase 7: CPU
# fp32 plain, CPU bf16 plain (the emulation) and the GPU's bf16 kernels.
# The task and domain losses are held to phase 7's loss bound, and each
# discriminator gradient to phase 7's two bounds from the emulation's own
# error e there (GPU vs fp32 <= 2e + 0.02, GPU vs emulation <= min(e +
# 0.02, 0.3)); a zeroed fc0 weight gradient must be refused.
DANN_PARITY_SIZE = 64
DANN_CONTROL = "fc0.weight"


def _dann_grads(dtype, device, src, lbl, tgt):
    """(task loss, domain loss, {discriminator param: gradient}) of one DANN
    step of the port's make_dann_step, from seeded weights."""
    import torch

    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import make_dann_step
    from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn

    seg = TrainState(make_model(dtype).to(device), 1e-3, 1e-4)
    disc = TrainState(DomainDiscriminator(256, generator=torch.Generator().manual_seed(SEED))
                      .to(device), 1e-3, 1e-4)
    step = make_dann_step(get_loss_fn("ce_tversky"), LAMBDA_DOMAIN)
    m = step(seg, disc, src.to(device), lbl.to(device), tgt.to(device),
             torch.Generator().manual_seed(SEED))
    # apply_gradients leaves in p.grad what AdamW was given: the gradient
    return (float(m["task_loss"]), float(m["domain_loss"]),
            {n: p.grad.detach().float().cpu() for n, p in disc.model.named_parameters()})


def _dann_parity() -> None:
    import torch

    s = DANN_PARITY_SIZE
    src, lbl = _parity_case(SEED + 300, s)
    tgt, _ = _parity_case(SEED + 301, s)
    task_w, dom_w, want = _dann_grads(torch.float32, "cpu", src, lbl, tgt)
    task_e, dom_e, emul = _dann_grads(torch.bfloat16, "cpu", src, lbl, tgt)
    task_g, dom_g, got = _dann_grads(torch.bfloat16, DEVICE, src, lbl, tgt)
    errs = {"task": abs(task_g - task_w) / abs(task_w), "domain": abs(dom_g - dom_w) / abs(dom_w)}
    rel_e, rel_g, rel_ge = grad_rel(emul, want), grad_rel(got, want), grad_rel(got, emul)
    bounds = ({n: TRAIN_GRAD_FACTOR * e + TRAIN_GRAD_FLOOR for n, e in rel_e.items()},
              {n: min(e + TRAIN_GRAD_FLOOR, TRAIN_GRAD_EMU_CAP) for n, e in rel_e.items()})
    failed = grad_failures(rel_g, rel_ge, bounds)
    ok = max(errs.values()) <= TRAIN_LOSS_TOL and not failed
    print(f"[dann-parity] {s}^3 full width, one DANN step, GPU bf16 kernels vs CPU fp32 plain: "
          f"task loss {task_g:.6f} vs {task_w:.6f} (emulation {task_e:.6f}), domain loss "
          f"{dom_g:.6f} vs {dom_w:.6f} (emulation {dom_e:.6f}); scaled errors "
          f"{errs['task']:.4g}, {errs['domain']:.4g} (<= {TRAIN_LOSS_TOL})", flush=True)
    for n in rel_g:
        print(f"[dann-parity] discriminator {n}: norm-relative gradient error GPU vs fp32 "
              f"{rel_g[n]:.4g} (<= {bounds[0][n]:.4g}), GPU vs emulation {rel_ge[n]:.4g} "
              f"(<= {bounds[1][n]:.4g}), emulation vs fp32 {rel_e[n]:.4g}", flush=True)
    print(f"[dann-parity] over a bound: {failed or 'none'} {'ok' if ok else 'FAIL'}", flush=True)
    fail_unless(ok, "DANN parity over tolerance")
    bad = {**got, DANN_CONTROL: got[DANN_CONTROL] * 0.0}
    rel_bad = grad_rel(bad, emul)
    refused = DANN_CONTROL in grad_failures(grad_rel(bad, want), rel_bad, bounds)
    print(f"[dann-parity] control, {DANN_CONTROL} gradient zeroed: GPU vs emulation "
          f"{rel_bad[DANN_CONTROL]:.4g}, bound {bounds[1][DANN_CONTROL]:.4g}: "
          f"{'refused' if refused else 'ACCEPTED'}", flush=True)
    fail_unless(refused, f"the DANN parity check accepts a zeroed {DANN_CONTROL} gradient")


# train parity: one step at 128^3, full width, dropout 0, augmentation off,
# from the same weights, three ways: CPU fp32 plain (the function), CPU bf16
# plain (the bf16 emulation: the port's plain path, which rounds to bf16
# where the kernels round) and the GPU's bf16 kernels. bf16 leaves the deep
# levels' gradients far from fp32: the cotangent is rounded to bf16 before
# each train-mode BatchNorm's backward subtracts its mean and projection,
# which cancel most of it, level after level. In CPU runs of the emulation
# against fp32 on this phase's inputs, the norm-relative gradient error was
# 0.001-0.03 at the first level and 0.37-0.51 at the two deepest, at 64^3
# and at 128^3 alike; the same amplification moves the GPU off the
# emulation by about half as much, since its fp32 sums run in another
# order (0.23 at most at the bottleneck, on the H100). So each gradient is
# held to two bounds, both from the emulation's own error e there:
# - GPU vs fp32: <= 2e + 0.02 (the function, as far as bf16 allows);
# - GPU vs the emulation: <= min(e + 0.02, 0.3) (a missing or garbled
#   gradient, deep ones included: a zeroed one is 1.0 off);
# and the loss, scaled, GPU vs fp32. A conv bias that feeds a BatchNorm
# (true gradient 0) is held by its gradient norm against its weight's.
# Controls zero and halve three gradients on the GPU side: two deep ones,
# the C = 128 level's conv (behind the deep pool's backward) and the first
# upconv, and a fused block's BatchNorm0 scale (enc0's, reached only through
# the folded affine's (da, dt) and the statistics' cotangents); the check
# must refuse each.
TRAIN_PARITY_SIZE = 128
TRAIN_LOSS_TOL = 0.01        # |gpu - cpu| / |cpu|
TRAIN_GRAD_FACTOR, TRAIN_GRAD_FLOOR, TRAIN_GRAD_EMU_CAP = 2.0, 0.02, 0.3
TRAIN_BN_BIAS_RATIO = 0.01   # ||db|| / ||dW|| of a conv that feeds a BatchNorm
TRAIN_CONTROLS = ("encoder.3.double_conv.0.weight", "upconvs.0.weight",
                  "encoder.0.double_conv.1.weight")


def bn_fed_bias(name: str) -> bool:
    """Conv biases followed by a train-mode BatchNorm: their true gradient is 0."""
    return name.endswith(("double_conv.0.bias", "double_conv.4.bias"))


def train_grads(model, x, y):
    """(loss, {param name: gradient}) of one train-mode ce_tversky step."""
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn

    model.train()
    model.zero_grad(set_to_none=True)
    loss = get_loss_fn("ce_tversky")(model(x), y)
    loss.backward()
    return loss.item(), {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}


def grad_rel(got: dict, want: dict) -> dict:
    """Norm-relative error of each gradient but the BN-fed biases'."""
    return {n: float((got[n] - w).norm() / w.norm()) for n, w in want.items()
            if not bn_fed_bias(n)}


def grad_failures(rel_fp32: dict, rel_emu: dict, bounds: tuple) -> list:
    """The gradients over either bound."""
    b_fp32, b_emu = bounds
    return [n for n in rel_fp32 if rel_fp32[n] > b_fp32[n] or rel_emu[n] > b_emu[n]]


def phase_train_parity() -> None:
    import torch

    s = TRAIN_PARITY_SIZE
    x, y = _parity_case(SEED + 200, s)
    cpu = make_model(torch.float32)
    emu, gpu = make_model(torch.bfloat16), make_model(torch.bfloat16)
    emu.load_state_dict(cpu.state_dict())
    gpu.load_state_dict(cpu.state_dict())
    loss_w, want = train_grads(cpu, x, y)
    loss_e, emul = train_grads(emu, x, y)
    loss_g, got = train_grads(gpu.cuda(), x.cuda(), y.cuda())
    fail_unless(math.isfinite(loss_g), "non-finite loss on the GPU")
    loss_err = abs(loss_g - loss_w) / abs(loss_w)
    rel_e, rel_g, rel_ge = grad_rel(emul, want), grad_rel(got, want), grad_rel(got, emul)
    bounds = ({n: TRAIN_GRAD_FACTOR * e + TRAIN_GRAD_FLOOR for n, e in rel_e.items()},
              {n: min(e + TRAIN_GRAD_FLOOR, TRAIN_GRAD_EMU_CAP) for n, e in rel_e.items()})
    ratio = {n: float(g.norm() / got[n[: -len("bias")] + "weight"].norm())
             for n, g in got.items() if bn_fed_bias(n)}
    levels: dict = {}  # encoder.0, ..., bottleneck, upconvs.0, ..., final_conv
    for n in rel_g:
        level = n.split(".double_conv")[0] if ".double_conv" in n else n.rsplit(".", 1)[0]
        levels.setdefault(level, []).append(n)
    for level, names in levels.items():
        print(f"[train-parity] {level}: largest norm-relative gradient error, GPU vs fp32 "
              f"{max(rel_g[n] for n in names):.4g}, emulation vs fp32 "
              f"{max(rel_e[n] for n in names):.4g}, GPU vs emulation "
              f"{max(rel_ge[n] for n in names):.4g}", flush=True)
    failed = grad_failures(rel_g, rel_ge, bounds)
    worst_b = max(ratio, key=ratio.get)
    ok = loss_err <= TRAIN_LOSS_TOL and not failed and ratio[worst_b] <= TRAIN_BN_BIAS_RATIO
    near = [max(rel, key=lambda n: rel[n] / b[n]) for rel, b in zip((rel_g, rel_ge), bounds)]
    print(f"[train-parity] {s}^3 full width, one step, GPU bf16 kernels vs CPU fp32 plain: "
          f"loss {loss_g:.6f} vs {loss_w:.6f}, scaled error {loss_err:.4g} (<= {TRAIN_LOSS_TOL}; "
          f"emulation {abs(loss_e - loss_w) / abs(loss_w):.4g}) | gradients, nearest their "
          f"bounds: GPU vs fp32 {near[0]} {rel_g[near[0]]:.4g} <= {bounds[0][near[0]]:.4g}, "
          f"GPU vs emulation {near[1]} {rel_ge[near[1]]:.4g} <= {bounds[1][near[1]]:.4g}; "
          f"over a bound: {failed or 'none'} | BN-fed bias gradient norm / weight gradient "
          f"norm at most {ratio[worst_b]:.4g} ({worst_b}, <= {TRAIN_BN_BIAS_RATIO}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    fail_unless(ok, "train parity over tolerance")
    for name in TRAIN_CONTROLS:  # the check must refuse a missing or garbled gradient
        for how, scale in (("zeroed", 0.0), ("halved", 0.5)):
            bad = {**got, name: got[name] * scale}
            rel_bad = grad_rel(bad, emul)
            refused = name in grad_failures(grad_rel(bad, want), rel_bad, bounds)
            print(f"[train-parity] control, {name} gradient {how}: GPU vs emulation "
                  f"{rel_bad[name]:.4g}, bound {bounds[1][name]:.4g}: "
                  f"{'refused' if refused else 'ACCEPTED'}", flush=True)
            fail_unless(refused, f"the parity check accepts a {how} {name} gradient")


def main() -> int:
    t_start = time.perf_counter()
    try:
        name, _ = phase_device()
        phase_build()
        shutil.rmtree(SCRATCH, ignore_errors=True)
        SCRATCH.mkdir(parents=True)
        kernels = phase_kernels()
        phase_slice()
        phase_parity()
        launches = phase_train()
        phase_workloads()
        phase_train_parity()
    except Exception as e:  # every phase's failure fails the run
        import traceback

        traceback.print_exc()
        print(f"[FAIL] {type(e).__name__}: {e}", flush=True)
        return 1
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    import torch

    # launches: the count of each kernel over the train CLI's run (its
    # train steps and its validation forwards), this slice's main path
    report = {"kernels": [
        {"name": kname, "route": "cuda", "source": KERNEL_INFO[kname][0],
         "replaces": KERNEL_INFO[kname][1], "launches": launches[kname],
         **{k: kernels[kname][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}}
        for kname in KERNEL_INFO
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
