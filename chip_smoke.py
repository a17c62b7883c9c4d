#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line per check; any failure exits non-zero:

1. device: a CUDA device must be present; prints its name, the
   ``nvidia-smi`` name and power limit, and the torch and CUDA versions;
2. build: compiles every kernel of ``multimodal_segmentation_project_tpu_torch/csrc``
   with nvcc (one process per source, in parallel), from this checkout;
   prints ptxas's registers and spills of each of the 24 instances of the
   conv body (``csrc/conv3.cu``), of the 12 of the fp32 conv body
   (``csrc/conv3_f32.cu``), of the 8 of the dW body (``csrc/conv3_dw.cu``),
   of the fp32 dW body's 4 (``csrc/conv3_dw_f32.cu``) and of the head's and
   the upconv's 66 (``csrc/head1x1.cu``, ``csrc/upconv_d2s.cu``; none of the
   last 90 may spill), and their dynamic shared memory per block; from
   ``cuobjdump -sass``, that every fp32 conv-body instance multiplies in
   ``HGMMA ... TF32`` instructions and holds no FFMA, and the digest of the
   fp32 dW body's SASS;
3. kernels: each kernel against its plain PyTorch version at every shape
   the 192^3 eval forward and train step give it, in bf16, the fp32
   instances of 7, 8 and 11 at every shape of the fp32 eval forward, and
   those of 1, 1-dx, 2, 3, 4, 5, 6, 9, 11-dx and 11-dw at every shape of
   the fp32 train step (12, which nothing calls, at conv1's; 1, 1-dx and 2
   also at every shape of the per-conv chain, correctness only), on seeded
   inputs; prints the error against the stated tolerance, the median
   time of the kernel as called, of its plain version and of one library
   call over distinct inputs (CUDA events; cuDNN's TF32 off), and its bound:
   the larger of its bytes over 3.35 TB/s and its FLOPs over 989 TFLOP/s
   (bf16) or 67 TFLOP/s (fp32), where the fp32 conv body's seven instances
   and the fp32 dW body's two, which multiply in 3xTF32, count their
   products' FLOPs three times over 494.7 TFLOP/s (TF32) and print the FFMA
   bound (the same FLOPs over 67 TFLOP/s) beside it; for the dW the library
   call again with ``cudnn.benchmark`` on (its best algorithm, not only its
   default). The fp32 pool also with NaNs planted, and
   two controls: the 16->16 192^3 conv and its weight gradient by cuDNN
   with TF32 allowed must miss the fp32 bound. For every kernel
   also the bare launch (operands packed before the timed window,
   BARE_REPS runs over the distinct inputs between two CUDA events, over
   the count) and the kernel/library ratios per shape, and the conv and
   dW bodies' sums per train step (bf16 and fp32); ragged edge inputs
   (the fused block's fp32 instances at W = 7, 9, 20, 37, Cin = 1 and 40,
   Cout = 20 and 48, batch 2 and an unaligned view, t > 0 on some
   channels); the same bits twice where blocks' partials are summed (the
   head's weight gradient and the fused block's fp32 sums too), and for
   the upconv and the head's dx; and every kernel the quickstart
   (``examples/quickstart_torch.py``) launches at its shapes (UNet3D (8,
   16) at 32^3: Cout = 8 at 32^3, 16 at 16^3, the 32-wide bottleneck at
   8^3, batch 2, and batch 1 for the eval forward's kernels), under the
   same tolerances, with its time as called and its plain version's; and
   the multi-device path's shapes: 1, 1-dx, 2 and 7 (bf16 and fp32) at
   every per-conv chain shape with D the haloed slab's planes at 1 x 2 and
   1 x 4 (98, 50, 26; 50, 26, 14), 8 and 9 (bf16 and fp32) at the slabs' D;
4. slice: writes two synthetic 192^3 CT cases and a seeded default-width
   UNet3D ``.pth``, runs the port's eval CLI (``workloads.test_model``) on
   the GPU, checks its artifacts and that every forward launched exactly
   11 conv, 4 pool, 3 upconv and 1 head kernel;
5. parity: the GPU's bf16 eval forward against the port's fp32 plain
   forward on the CPU, one 64^3 volume at full width;
5b. fp32 eval: the eval CLI with ``--precision fp32`` on phase 4's cases
   and model, with cuDNN's flags at PyTorch's defaults (TF32 allowed): 11
   fp32 conv, 4 fp32 pool and 1 fp32 head launches per forward and no
   upconv kernel, and 7 library convs and 4 library transpose convs; the
   GPU's fp32 forward against the CPU's at 64^3; the fp32 forward's time
   and peak beside bf16's, and their predictions' agreement;
6. train: writes two train, one val and one test synthetic 192^3 CT case,
   runs the port's train CLI (``workloads.train_unet``) as
   ``run_training.sh`` does (batch 1, bf16, ce_tversky, augmentation on)
   for two epochs, checks finite losses and the launches of every kernel
   from the host per eager train step (the fused DoubleConv's kernels in
   enc0-enc2, dec2 and dec3, the per-conv chain in dec1; the two steps
   after the two eager ones replay as CUDA graphs, which launch nothing
   from the host) and per validation forward, that the
   checkpoints are the JAX CLI's files (``best_model_<name>.msgpack`` and
   its JSON sidecar), evaluates the best checkpoint with the eval CLI;
   then times the train step (median over distinct inputs, host clock
   around ``torch.cuda.synchronize()``),
   reports the peak allocated and reserved memory (a replayed step's
   activations lie in its graphs' pool, which only the reserved peak
   sees), and breaks a few steps' device time down from a
   ``torch.profiler`` trace; every step alone (6b, 8, 8b too) has its
   kernels counted on the device over an eager and a replayed call, from
   the profiler's trace, and the replay must run the eager call's kernels
   of the port;
6b. fp32 train: the train CLI on phase 6's data and recipe with no
   ``--mixed_precision`` flag (fp32, the JAX CLIs' default): the fused
   block where bf16 takes it, on its fp32 instances, exact launches of the
   fp32 kernels per step (43, bf16's table without the upconv) and per
   validation forward and the library's convs and transpose convs, fp32
   parameters in its ``.msgpack``; then the fp32 step alone (time, peak,
   profile);
7. train parity: one train step at 128^3 and full width, GPU bf16 against
   CPU fp32 and against the CPU bf16 emulation, from the same weights: the
   loss and every parameter's gradient, and controls that the check
   refuses a zeroed or halved deep gradient and a fused block's bn0
   scale gradient;
7b. fp32 train parity: one fp32 step at 64^3 and full width, GPU (the
   fused block's fp32 kernels) against the CPU's plain fp32 step from the
   same weights: the loss and every
   gradient; and a control that the same GPU step with the backward's TF32
   scope removed moves the gradients off the scoped step's;
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
   that a zeroed fc0 gradient is refused;
8b. fp32 workloads: ``finetune``, ``distill`` and ``dann`` again in fp32 on
   phase 8's data, through the fused block, exact launches (a distillation
   step 59 with the teacher's eval forward in fp32, a DANN step 74), and
   the fp32 DANN step alone (time, peak);
10. entry points (run after phase 8b, before phase 7): the five ``_torch``
   recipes through bash from this checkout's root, with ``python`` this
   interpreter, at full width on phases 6 and 8's 192^3 splits, one epoch
   each, cut only through their own variables (``EPOCHS=1``,
   ``N_SAMPLES=2``, ``GRAD_ACCUM=2`` in ``run_training_torch.sh``;
   ``MODALITIES=ct`` for its CT split): ``run_training_torch.sh``, then
   ``run_testing_torch.sh`` on its best checkpoint, which
   ``run_finetune_ct_torch.sh`` (``PRETRAINED``) and
   ``run_distillation_torch.sh`` (``TEACHER``) take too, and
   ``run_dann_torch.sh`` on the MRI -> CT splits; each exit code and the
   files each CLI writes; the quickstart in this process (one epoch), its
   launches of every kernel exact (3 steps at batch 2, 5 eval forwards);
   the QA script's augmentation on a CUDA tensor (shapes, dtypes, labels
   within 0..3, p = 0 the identity); the phase's time;
9. checkpoints and preprocessing (run after phase 7b): writes phase 6's
   trained state (its optimizer and its ``optax.MultiSteps`` accumulator
   included) as the
   JAX package's ``.msgpack`` with the port's writer, reads it back and
   holds every leaf bit-equal (size, write and read seconds); serves it:
   the eval CLI on the ``.msgpack`` gives the predictions of the ``.pth``
   train checkpoint of the same weights (which the trainer writes) and
   its per-sample Dice bit for bit, and ``main.py --experiment distill
   --teacher_model`` and ``finetune --pretrained_model`` take it, with exact
   launches; resume continuity: a train run (and a DANN run) of two epochs
   of two steps saved as ``.msgpack`` after epoch 1 and resumed by a fresh
   trainer gives bit-equal epoch-2 step losses and final weights to an
   uninterrupted run (cuDNN held deterministic for these runs); resampling:
   ``workloads.resample --backend torch`` on one synthetic 512x512x160 CT
   case at 0.78x0.78x2.5 mm (int16, uint8 labels) on the GPU, then the eval
   CLI on its 192^3 result; the card's image against the same function on
   the CPU within 1e-5 * max |x|, the labels equal; the seconds per case and
   the peak device memory;
11. multi-device: (a) the train CLI under ``torchrun
   --standalone --nproc_per_node 1`` (NCCL, one rank) writes phase 6's
   files, and in this process a world-1 step gives the bits of the step
   with no process group (cuDNN deterministic); (b) two processes of this
   script (``--mesh-rank``) on the one card over gloo, which the phase
   names (NCCL refuses two ranks on one device), at 192^3 and full width in
   fp32 and bf16: meshes 1 x 2 at batch 1 and 2 x 1 at batch 2, one train
   step each through the per-conv chain, against one process running the
   global batch through the per-conv chain (fp32: phase 7b's bounds; bf16:
   phase 7's, with e the one process's bf16 step against its fp32 step),
   the noise floor printed; controls that must be refused: every halo
   zeroed (fp32, 1 x 2) and the gradient all-reduce without its division;
   the ranks' gradients the same bits; (c) the eval forward at 1 x 2
   against the unsharded one (fp32 within 1e-4 of max |logit|, argmax >=
   0.999; bf16 argmax >= 0.98); (d) one fp32 DANN and one fp32
   distillation step at 1 x 2 against one process; (e) every rank's
   launches exact, the halo bytes each rank sends, the steps' times (two
   processes on one card: not multi-GPU performance) and the phase's
   seconds; and which gloo operations take CUDA tensors (all_reduce,
   broadcast and all_gather must; point-to-point, which the halo stages
   through host memory, must not, checked in a pair of processes of its
   own).

12. window attention (``ops/window_attn.py``, SwinUNETR's W-MSA and
   SW-MSA): its three Triton kernels against the plain version at the
   four Swin stages' 192^3 shapes (96^3 x 48 channels, 3 heads; 48^3 x 96,
   6; 24^3 x 192, 12; 12^3 x 384, 24), unshifted and shifted by 3, and at
   a clipped window (4^3), batch 2 and a ragged 9 x 12 x 16 volume: the
   output within two bf16 ulps plus 2^-8 max |v|, the gradients of qkv,
   the qkv bias and the position table within 1.5e-2 of the plain
   version's norm; the forward and forward + backward timed beside their
   bound, the plain version and SDPA (with the bias as its float mask, the
   library's yardstick, which the port never calls); then SwinUNETR's bf16
   train step at 192^3 on the one-card step's CUDA graph: the forward
   kernel's launches from the host over six steps (24: 8 blocks in each of
   the two eager steps and the capture; the replays launch none from the
   host), the window_attn kernels a replayed step runs, counted on the
   device (24: 8 blocks, a forward and two backward kernels each), the
   step's seconds and the allocator's peaks.

13. InstanceNorm with the residual block's tail (``ops/instance_norm.py``,
   SwinUNETR's 25 norms): its six Triton kernels against the plain version
   at every shape and tail of a 192^3 step (192^3 and 96^3 x 48 channels,
   48^3 x 96, 24^3 x 192, 12^3 x 384, 6^3 x 768; no tail, LeakyReLU,
   residual and LeakyReLU) in bf16: the output, dx and dresidual within
   two bf16 ulps plus 1e-5 of the largest magnitude; each timed forward and
   forward + backward as called, by CUDA events, median of five, beside its
   device time (the profiler), its bound (bytes at 3.35 TB/s), the plain
   version and the library's composition (``torch.group_norm``, the add,
   ``F.leaky_relu``, which the port no longer calls), and summed over the
   step; then SwinUNETR's train step: the instance_norm kernels a replayed
   step runs, counted on the device (150: 25 norms, six kernels each), and
   the op's launches from the host over six steps (300: the two eager
   steps; a capture counts none).

``python3 chip_smoke.py --window-attn`` runs phase 12 alone,
``python3 chip_smoke.py --instance-norm`` phase 13.
``python3 chip_smoke.py --multi-gpu`` instead runs (b)-(e) across the
machine's N > 1 cards over NCCL, at 1 x N, N x 1 and, for an even N >= 4,
(N/2) x 2, with each rank's step time and halo bytes.
``python3 chip_smoke.py --time-scipy-resample`` instead times the resampling
case once with the scipy backend on the host and once with the torch
backend on the GPU, and nothing else. ``python3 chip_smoke.py
--time-accum-step [ROOT]`` instead times and profiles the full-width train
step with gradient accumulation 2, with the port imported from ROOT (this
checkout by default): run it on a parent's checkout and on this one in one
call to compare the two. ``python3 chip_smoke.py --time-dw-f32 [ROOT]``
and ``--time-conv-f32 [ROOT]`` do the same for the fp32 dW body's two
instances (kernels 2 and 6 in fp32, at the fp32 train step's shapes) and
for the fp32 conv body's seven (7-fp32 over the fp32 eval forward, 1-,
1-dx-, 3-, 4-, 5-fp32 over the fp32 train step, 12-fp32 over its conv1
shapes): each checked against its plain version, timed as called and bare
beside its bound (its multiplies as 3xTF32 products) and the FFMA bound,
summed per pass and per step; each prints the digest of the fp32 dW body's
SASS too, so that a parent's and this checkout's can be held side by side.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Scratch files go to
``build/chip_smoke/`` in this checkout.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import signal
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
TF32_FLOPS = 494.7e12      # dense TF32 tensor-core peak, same source

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
# the per-conv chain's dx convs: all eleven convs but the image's, Cin/Cout
# swapped (with CONV_SHAPES, where phase 3 also holds the fp32 training
# conv, its dx and its dW: every conv of a step on the per-conv chain)
PER_CONV_DX_SHAPES = [(cout, cin, s) for cin, cout, s in CONV_SHAPES if cin > 1]
# the quickstart's model (examples/quickstart_torch.py): UNet3D (8, 16) at
# 32^3, bf16, every conv <= 64 wide, so the fused block in every block
# (enc0, enc1, the bottleneck, dec0, dec1), two pools and two upconvs; its
# train steps run at batch 2, its validation and eval forwards at batch 1.
# Its splits (make_dataset there): one epoch runs 6 / 2 = 3 train steps and 2
# validation forwards, then the eval CLI's warm-up forward and one forward
# per test case.
QS_SPLITS = {"train": 6, "val": 2, "test": 2}
QS_BATCH = 2
# (Cin, Cout, S) of conv0 and conv1 of each block:
QS_CONV0 = [(1, 8, 32), (8, 16, 16), (16, 32, 8), (32, 16, 16), (16, 8, 32)]
QS_CONV1 = [(8, 8, 32), (16, 16, 16), (32, 32, 8), (16, 16, 16), (8, 8, 32)]
QS_POOLS = [(8, 32), (16, 16)]
QS_UPCONVS = [(32, 16, 8), (16, 8, 16)]
QS_EVAL_CONVS = [shape for pair in zip(QS_CONV0, QS_CONV1) for shape in pair]
# phase 3 holds every kernel the quickstart launches at its shapes: the
# train step's at batch 2, the eval forward's at batch 1 and 2
QUICKSTART_SHAPES = {
    "conv3x3x3_cf_stats": [(*sh, QS_BATCH) for sh in QS_CONV0],
    "conv3x3x3_cf_boundary_stats": [(*sh, QS_BATCH) for sh in QS_CONV1],
    "conv3x3x3_cf_dx": [(cout, cin, s, QS_BATCH) for cin, cout, s in QS_CONV0 if cin > 1],
    "conv3x3x3_cf_dx_epilogue": [(*sh, QS_BATCH) for sh in QS_CONV1],
    "conv3x3x3_cf_dw": [(*sh, QS_BATCH) for sh in QS_CONV0],
    "conv3x3x3_cf_dw_prologue": [(*sh, QS_BATCH) for sh in QS_CONV1],
    "max_pool2x_cf": [(*sh, n) for sh in QS_POOLS for n in (1, QS_BATCH)],
    "max_pool2x_cf_bwd": [(*sh, QS_BATCH) for sh in QS_POOLS],
    "upconv2x_cf": [(*sh, n) for sh in QS_UPCONVS for n in (1, QS_BATCH)],
    "head1x1_cf": [(8, 4, 32, n) for n in (1, QS_BATCH)],
    "head1x1_cf_dx": [(4, 8, 32, QS_BATCH)],
    "head1x1_cf_dw": [(8, 4, 32, QS_BATCH)],
    "conv3x3x3_cf_relu": [(*sh, n) for sh in QS_EVAL_CONVS for n in (1, QS_BATCH)],
}

# launches per eval forward and per train step (default widths, 192^3)
PER_FORWARD = {"conv3x3x3_cf_relu": 11, "max_pool2x_cf": 4, "upconv2x_cf": 3, "head1x1_cf": 1}
# per fp32 eval forward: the fp32 instances of 7, 8 and 11, no upconv kernel
# (the JAX package's fp32 upconv is XLA), and the library's convs (the deep
# region) and transpose convs (every upconv)
PER_FP32_FORWARD = {"conv3x3x3_cf_relu_f32": 11, "max_pool2x_cf_f32": 4, "head1x1_cf_f32": 1}
LIBRARY_PER_FP32_FORWARD = {"conv3d": 7, "conv_transpose3d": 4}
F32_KERNELS = tuple(PER_FP32_FORWARD)
PER_STEP = {"conv3x3x3_cf_stats": 5, "conv3x3x3_cf_boundary_stats": 5, "conv3x3x3_cf": 1,
            "conv3x3x3_cf_dx": 5, "conv3x3x3_cf_dx_epilogue": 5, "conv3x3x3_cf_dw": 6,
            "conv3x3x3_cf_dw_prologue": 5, "max_pool2x_cf": 4, "max_pool2x_cf_bwd": 4,
            "upconv2x_cf": 3, "head1x1_cf": 1, "head1x1_cf_dx": 1, "head1x1_cf_dw": 1}
# the quickstart's launches per train step (batch 2) and per eval forward:
# conv0's dx in every block but enc0 (whose input is the image), conv1's by
# the dx epilogue
QS_PER_STEP = {"conv3x3x3_cf_stats": 5, "conv3x3x3_cf_boundary_stats": 5, "conv3x3x3_cf_dx": 4,
               "conv3x3x3_cf_dx_epilogue": 5, "conv3x3x3_cf_dw": 5,
               "conv3x3x3_cf_dw_prologue": 5, "max_pool2x_cf": 2, "max_pool2x_cf_bwd": 2,
               "upconv2x_cf": 2, "head1x1_cf": 1, "head1x1_cf_dx": 1, "head1x1_cf_dw": 1}
QS_PER_FORWARD = {"conv3x3x3_cf_relu": 10, "max_pool2x_cf": 2, "upconv2x_cf": 2, "head1x1_cf": 1}


def _f32_counts(counts: dict) -> dict:
    """A bf16 table of launches in fp32: the same kernels' fp32 instances,
    and no upconv kernel (every fp32 upconv is the library's)."""
    return {f"{k}_f32": n for k, n in counts.items() if k != "upconv2x_cf"}


# per fp32 train step: the bf16 step's table on the fp32 instances (43),
# and the library's convs (the deep region) and transpose convs (every
# upconv) of its forward; the backward's cuDNN calls run under autograd and
# are not counted
PER_FP32_STEP = _f32_counts(PER_STEP)
F32_TRAIN_KERNELS = ("conv3x3x3_cf_f32", "conv3x3x3_cf_dx_f32", "conv3x3x3_cf_dw_f32",
                     "max_pool2x_cf_bwd_f32", "head1x1_cf_dx_f32", "head1x1_cf_dw_f32",
                     "conv3x3x3_cf_stats_f32", "conv3x3x3_cf_boundary_stats_f32",
                     "conv3x3x3_cf_dx_epilogue_f32", "conv3x3x3_cf_dw_prologue_f32",
                     "conv3x3x3_cf_boundary_f32")
CONV3 = "multimodal_segmentation_project_tpu_torch/csrc/conv3.cu"
CONV3_F32 = "multimodal_segmentation_project_tpu_torch/csrc/conv3_f32.cu"
CONV3_DW = "multimodal_segmentation_project_tpu_torch/csrc/conv3_dw.cu"
CONV3_DW_F32 = "multimodal_segmentation_project_tpu_torch/csrc/conv3_dw_f32.cu"
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
    # the fp32 instances the JAX package's fp32 policy runs in its eval forward
    "conv3x3x3_cf_relu_f32": (CONV3_F32, f"{PALLAS_CONV}:314"),
    "max_pool2x_cf_f32": ("multimodal_segmentation_project_tpu_torch/csrc/pool2x.cu",
                          "multimodal_segmentation_project_tpu/ops/pool.py:65"),
    "head1x1_cf_f32": ("multimodal_segmentation_project_tpu_torch/csrc/head1x1.cu",
                       "multimodal_segmentation_project_tpu/ops/head.py:39"),
    # the fp32 instances the JAX package's fp32 policy runs in its train step
    "conv3x3x3_cf_f32": (CONV3_F32, f"{PALLAS_CONV}:293"),
    "conv3x3x3_cf_dx_f32": (CONV3_F32, f"{PALLAS_CONV}:293"),
    "conv3x3x3_cf_dw_f32": (CONV3_DW_F32, f"{PALLAS_CONV}:468"),
    "max_pool2x_cf_bwd_f32": ("multimodal_segmentation_project_tpu_torch/csrc/pool2x.cu",
                              "multimodal_segmentation_project_tpu/ops/pool.py:145"),
    "head1x1_cf_dx_f32": ("multimodal_segmentation_project_tpu_torch/csrc/head1x1.cu",
                          "multimodal_segmentation_project_tpu/ops/head.py:39"),
    "head1x1_cf_dw_f32": ("multimodal_segmentation_project_tpu_torch/csrc/head1x1.cu",
                          "multimodal_segmentation_project_tpu/ops/head.py:108"),
    # the fused DoubleConv's fp32 instances
    "conv3x3x3_cf_stats_f32": (CONV3_F32, f"{PALLAS_CONV}:341"),
    "conv3x3x3_cf_boundary_stats_f32": (CONV3_F32, f"{PALLAS_CONV}:1039"),
    "conv3x3x3_cf_dx_epilogue_f32": (CONV3_F32, f"{PALLAS_CONV}:886"),
    "conv3x3x3_cf_dw_prologue_f32": (CONV3_DW_F32, f"{PALLAS_CONV}:799"),
    "conv3x3x3_cf_boundary_f32": (CONV3_F32, f"{PALLAS_CONV}:732"),
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
# the fp32 instances (7, 1, 1-dx, 2, 11, 11-dx, and the fused block's y, dy
# and dW of 3, 4, 5, 6, 12): the same fp32 products as the plain version,
# summed in another order, scaled by max|plain| (the port's fp32 ops'
# tolerance since its first slice); a TF32 pass (10 mantissa bits a
# product) errs far above it, which the TF32 controls show on the card (the
# dW's sums run over up to 7.1M voxels: their order moves an entry by about
# 1e-6 of max|dW|, a TF32 pass by about 1e-4)
F32_TOL = 2e-5
# the fused block's fp32 sums: s1, s2 per channel within sum |y - y_plain|
# (of y^2 for s2) plus STATS_TOL of sum |y| (sum y^2), as in bf16, with y
# within F32_TOL; da, dt per (batch, channel) within DADT_TOL of sum |du x|
# and sum |du|, as in bf16 (both sides mask the same fp32 u = x a + t, each
# product rounded before it is added), with dy within F32_TOL
F32_STATS = "y: F32_TOL scaled; s1, s2: sum |dy| + STATS_TOL sum |y|"
F32_DX_EPILOGUE = "dy: F32_TOL scaled; da, dt: DADT_TOL sum |du x|, sum |du|"
SUM_TOLS = {STATS: BF16_ONE_ULP, DX_EPILOGUE: BF16_ONE_ULP, F32_STATS: F32_TOL,
            F32_DX_EPILOGUE: F32_TOL}  # -> the first output's tolerance


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


# conv3_f32.cu: slices of NS = 16 and 32 output channels (a wgmma N of 3
# NS), each with the bias+ReLU epilogue (7), the cast-then-bias one without
# and with the prologue (1, 1-dx; 12), the stats one without and with it (3;
# 4) and the dx mask (5), as conv3.cu
F32_BODY_INSTANCES = 12


def f32_body_resources(log: str) -> list:
    """conv3_f32.cu's conv3_f32_kernel<NS, EPI, PRO> instances."""
    return ptxas_resources(
        log, r"conv3_f32_kernelILi(\d+)ELi(\d)ELb(\d)E",
        lambda ns, epi, pro: f"conv3_f32_kernel<NS={ns}, {EPILOGUES[epi]}, prologue={pro}>")


DW_INSTANCES = 8  # conv3_dw.cu: COUT 16, 32, 48, 64, each without and with the prologue


def dw_body_resources(log: str) -> list:
    """conv3_dw.cu's conv3_dw_partial_kernel<COUT, PRO> instances."""
    return ptxas_resources(
        log, r"conv3_dw_partial_kernelILi(\d+)ELb(\d)E",
        lambda cout, pro: f"conv3_dw_partial_kernel<COUT={cout}, prologue={pro}>")


# conv3_dw_f32.cu: MW = 1, 2 m16 tiles of a block's output channels (Cout
# <= 16, or more), each without and with the prologue (2; 6)
DW_F32_INSTANCES = 4


def dw_f32_body_resources(log: str) -> list:
    """conv3_dw_f32.cu's conv3_dw_f32_partial_kernel<MW, PRO> instances."""
    return ptxas_resources(log, r"conv3_dw_f32_partial_kernelILi(\d)ELb(\d)E",
                           lambda mw, pro: f"conv3_dw_f32_partial_kernel<MW={mw}, "
                                           f"prologue={pro}>")


# head1x1.cu: 16 forward (bf16 and fp32 features, CO = 1..8), 16 dx (bf16
# and fp32 out, NC = 1..8), 32 weight-gradient (bf16 and fp32 features, NC
# = 1..8, 16-byte or guarded loads) and the weight gradient's block
# reduce; upconv_d2s.cu: 1
SMALL_INSTANCES = 66


def small_kernel_resources(log: str) -> list:
    """head1x1.cu's and upconv_d2s.cu's kernel instances."""
    def label(kname, dtype, n, vec):
        if n is None:
            return kname
        return (f"{kname}<"
                + ("" if dtype is None else f"{'fp32' if dtype == 'f' else 'bf16'}, ")
                + f"{'CO' if kname == 'head1x1_kernel' else 'NC'}={n}"
                + ("" if vec is None else f", {'16-byte' if vec == '1' else 'guarded'} loads")
                + ">")

    return ptxas_resources(
        log, r"(head1x1_kernel|head1x1_dx_kernel|head1x1_dw_kernel|head1x1_dw_reduce_kernel"
             r"|upconv_d2s_kernel)(?:I(13__nv_bfloat16|f)?Li(\d+)E(?:Lb(\d)E)?)?", label)


def find_cuobjdump() -> str:
    """cuobjdump of the toolkit whose nvcc builds the kernels."""
    from multimodal_segmentation_project_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    fail_unless(tool.is_file(), f"no cuobjdump beside {tool.parent / 'nvcc'}")
    return str(tool)


def sass_functions(lib: Path) -> dict:
    """mangled kernel name -> its SASS lines (instructions only, the
    namespace's path hash blanked), from cuobjdump -sass of the library."""
    out = subprocess.run([find_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=600)
    fail_unless(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    funcs = {}
    for part in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        name, body = part.split("\n", 1)
        name = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}", r"\1::",
                      name.strip())
        funcs[name] = [re.sub(r"/\*[0-9a-fx]+\*/", "", ln).strip()
                       for ln in body.splitlines() if re.search(r"/\*[0-9a-f]{4,}\*/", ln)]
    return funcs


def dw_f32_sass_digest(lib: Path) -> tuple:
    """(functions, lines, sha256) of conv3_dw_f32.cu's kernels' SASS, the
    namespace's path hash blanked: equal digests mean the same SASS line
    for line."""
    import hashlib

    funcs = {k: v for k, v in sass_functions(lib).items() if "conv3_dw_f32" in k}
    h = hashlib.sha256()
    for name in sorted(funcs):
        h.update(name.encode())
        h.update("\n".join(funcs[name]).encode())
    return len(funcs), sum(len(v) for v in funcs.values()), h.hexdigest()[:16]


def _f32_sass_checks(lib: Path) -> None:
    """Every conv3_f32_kernel instance multiplies on the tensor cores
    (HGMMA ... TF32) and issues no FFMA at all (its K loop's multiplies are
    the wgmmas; the prologue, the split and the epilogues round each
    operation); the fp32 dW body's digest, to hold against a parent's."""
    funcs = sass_functions(lib)
    body = {k: v for k, v in funcs.items() if "conv3_f32_kernel" in k}
    fail_unless(len(body) == F32_BODY_INSTANCES,
                f"cuobjdump found {len(body)} conv3_f32_kernel instances")
    counts = []
    for name, lines in sorted(body.items()):
        hgmma = sum(1 for ln in lines if re.search(r"\bHGMMA\.64x\d+x8\.F32\.TF32\b", ln))
        ffma = sum(1 for ln in lines if re.search(r"\bFFMA\b", ln))
        counts.append((hgmma, ffma))
        fail_unless(hgmma > 0 and ffma == 0,
                    f"{name}: {hgmma} HGMMA TF32 and {ffma} FFMA in its SASS")
    example = next(ln for lines in body.values() for ln in lines if "HGMMA" in ln)
    print(f"[build] SASS: every conv3_f32_kernel instance ({len(body)}) holds "
          f"{min(c[0] for c in counts)}-{max(c[0] for c in counts)} HGMMA TF32 and 0 FFMA, "
          f"e.g. {example}", flush=True)
    n, lines, sha = dw_f32_sass_digest(lib)
    print(f"[build] SASS of conv3_dw_f32.cu: {n} kernels, {lines} lines, sha256 {sha}", flush=True)


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
    lines = f32_body_resources(log)
    fail_unless(len(lines) == F32_BODY_INSTANCES, f"ptxas reported {len(lines)} "
                f"conv3_f32_kernel instances, not {F32_BODY_INSTANCES}")
    for line in lines:
        print(f"[build] ptxas {line}", flush=True)
        fail_unless("0 bytes spill stores, 0 bytes spill loads" in line,
                    f"fp32 conv body spills: {line}")
    print("[build] conv3_f32_kernel dynamic shared memory per block (its ring of stages), "
          "Cin = 1 / 64: " + ", ".join(
              f"COUT={c} {lib.mmseg_conv3_f32_smem_bytes(c, 1)} / "
              f"{lib.mmseg_conv3_f32_smem_bytes(c, 64)} B" for c in (16, 32, 48, 64)), flush=True)
    warned = [line.strip() for line in log.splitlines() if "wgmma" in line.lower()]
    for line in warned:
        print(f"[build] ptxas: {line}", flush=True)
    _f32_sass_checks(_build.library_path())
    lines = dw_body_resources(log)
    fail_unless(len(lines) == DW_INSTANCES, f"ptxas reported {len(lines)} "
                f"conv3_dw_partial_kernel instances, not {DW_INSTANCES}")
    for line in lines:
        print(f"[build] ptxas {line}", flush=True)
        fail_unless("0 bytes spill stores, 0 bytes spill loads" in line, f"dW spills: {line}")
    print("[build] conv3_dw_partial_kernel dynamic shared memory per block: " + ", ".join(
        f"COUT={c} {lib.mmseg_conv3_dw_smem_bytes(c)} B" for c in (16, 32, 48, 64)), flush=True)
    lines = dw_f32_body_resources(log)
    fail_unless(len(lines) == DW_F32_INSTANCES, f"ptxas reported {len(lines)} "
                f"conv3_dw_f32_partial_kernel instances, not {DW_F32_INSTANCES}")
    for line in lines:
        print(f"[build] ptxas {line}", flush=True)
        fail_unless("0 bytes spill stores, 0 bytes spill loads" in line, f"fp32 dW spills: {line}")
    print("[build] conv3_dw_f32_partial_kernel dynamic shared memory per block: " + ", ".join(
        f"Cout={c} {lib.mmseg_conv3_dw_f32_smem_bytes(c)} B" for c in (16, 32)), flush=True)
    lines = small_kernel_resources(log)
    fail_unless(len(lines) == SMALL_INSTANCES, f"ptxas reported {len(lines)} head and upconv "
                f"kernel instances, not {SMALL_INSTANCES}")
    for line in lines:
        print(f"[build] ptxas {line}", flush=True)
    spills = [line for line in lines if "0 bytes spill stores, 0 bytes spill loads" not in line]
    fail_unless(not spills, f"head or upconv spills: {spills}")
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
    a fused kernel over its bound under ``tol`` (a key of SUM_TOLS), entry
    by entry; within tolerance when <= 1."""
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import conv3

    f64 = torch.float64
    if tol in (STATS, F32_STATS):  # per channel, over (B, D, H, W)
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
    within its bf16 allowance), of SUM_TOLS (the first output within its
    tolerance there, a bf16 one per element or an fp32 one scaled, and fp32
    sums within their bounds), HEAD_DW (every output a sum within its
    bound), 0 (exact) or a bound on the scaled error; the errors are those
    of the first output (for HEAD_DW, of all)."""
    import torch

    err = rel = 0.0
    sums = None
    ok = True
    scaled_tol = SUM_TOLS.get(tol, tol)
    for args in inputs:
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        elem_tol = tol
        if tol == HEAD_DW:
            ratio = _head_dw_ratio(got, want, args)
            sums = max(sums or 0.0, ratio)
            ok = ok and ratio <= 1.0
            got, want = (torch.cat([t.flatten() for t in out]) for out in (got, want))
        elif tol in SUM_TOLS:
            ratio = _sums_ratio(tol, got, want, args)
            sums = max(sums or 0.0, ratio)
            ok = ok and ratio <= 1.0
            got, want, elem_tol = got[0], want[0], SUM_TOLS[tol]
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
    elif not isinstance(scaled_tol, str):
        ok = ok and rel <= scaled_tol
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

    def tied_f32(*shape):
        """fp32 values rounded to halves in [-4, 4]: most pool windows hold tied maxima."""
        return (randn(*shape, scale=4.0, dtype=torch.float32).round().clamp(-8, 8) / 2)

    def conv_w(cin, cout):
        return randn(3, 3, 3, cin, cout, scale=(2.0 / (27 * cin)) ** 0.5, dtype=torch.float32)

    # the bf16 makers take the batch n last: 1 at the 192^3 shapes, 2 at the
    # quickstart's train shapes (QUICKSTART_SHAPES)
    def conv_inputs(cin, cout, s, n=1):
        w, b = conv_w(cin, cout), randn(cout, scale=0.1, dtype=torch.float32)
        return [(randn(n, cin, s, s, s), w, b) for _ in range(N_TIMED)]

    def dx_inputs(gc, xc, s, n=1):  # cotangent channels (the conv's Cout), dx channels
        w = conv_w(xc, gc)
        return [(randn(n, gc, s, s, s), w) for _ in range(N_TIMED)]

    def dw_inputs(cin, cout, s, n=1):
        return [(randn(n, cin, s, s, s), randn(n, cout, s, s, s, scale=1e-2))
                for _ in range(N_TIMED)]

    def affine(c, n=1):
        """A boundary conv's (a, t) as the fused block makes them: BatchNorm's
        scale / std and shift, t of both signs, Dropout3d's 0.1 folded in."""
        m = (torch.rand(n, c, generator=gen, device=dev) >= 0.1).float() / 0.9
        a = (torch.rand(n, c, generator=gen, device=dev) + 0.5) * m
        return a, torch.randn(n, c, generator=gen, device=dev) * 0.5 * m

    def boundary_inputs(cin, cout, s, n=1):
        w, b = conv_w(cin, cout), randn(cout, scale=0.1, dtype=torch.float32)
        return [(randn(n, cin, s, s, s), w, b, *affine(cin, n)) for _ in range(N_TIMED)]

    def dx_epilogue_inputs(cin, cout, s, n=1):  # the boundary conv's channels
        w = conv_w(cin, cout)
        return [(randn(n, cout, s, s, s, scale=1e-2), w, randn(n, cin, s, s, s), *affine(cin, n))
                for _ in range(N_TIMED)]

    def dw_prologue_inputs(cin, cout, s, n=1):
        return [(randn(n, cin, s, s, s), randn(n, cout, s, s, s, scale=1e-2), *affine(cin, n))
                for _ in range(N_TIMED)]

    def pool_inputs(c, s, n=1):
        return [(randn(n, c, s, s, s),) for _ in range(N_TIMED)]

    def pool_bwd_inputs(c, s, n=1):
        """Inputs rounded to integers in [-4, 4]: most windows hold tied maxima."""
        out = []
        for _ in range(N_TIMED):
            x = (randn(n, c, s, s, s, scale=2.0, dtype=torch.float32).round()
                 .clamp(-4, 4).to(torch.bfloat16))
            out.append((x, pool.max_pool2x_cf(x), randn(n, c, s // 2, s // 2, s // 2)))
        return out

    def upconv_inputs(cin, cout, s, n=1):
        k = randn(2, 2, 2, cin, cout, scale=(1.0 / cin) ** 0.5, dtype=torch.float32)
        b = randn(cout, scale=0.1, dtype=torch.float32)
        return [(randn(n, cin, s, s, s), k, b) for _ in range(N_TIMED)]

    # the head's kernel (Cin, Co) as the model passes it: the transposed
    # view of its (Co, Cin) parameter
    def head_inputs(cin, co, s, n=1):
        k = randn(co, cin, scale=(1.0 / cin) ** 0.5, dtype=torch.float32).t()
        b = randn(co, scale=0.1, dtype=torch.float32)
        return [(randn(n, cin, s, s, s), k, b) for _ in range(N_TIMED)]

    def head_dx_inputs(co, cin, s, n=1):
        k = randn(co, cin, scale=(1.0 / cin) ** 0.5, dtype=torch.float32).t()
        return [(randn(n, co, s, s, s, scale=1e-3, dtype=torch.float32), k)
                for _ in range(N_TIMED)]

    def head_dw_inputs(cin, co, s, n=1):
        return [(randn(n, cin, s, s, s), randn(n, co, s, s, s, scale=1e-3, dtype=torch.float32))
                for _ in range(N_TIMED)]

    f32 = torch.float32

    def conv_f32_inputs(cin, cout, s):
        w, b = conv_w(cin, cout), randn(cout, scale=0.1, dtype=f32)
        return [(randn(1, cin, s, s, s, dtype=f32), w, b) for _ in range(N_TIMED)]

    def pool_f32_inputs(c, s):
        return [(tied_f32(1, c, s, s, s),) for _ in range(N_TIMED)]

    def head_f32_inputs(cin, co, s):
        k = randn(co, cin, scale=(1.0 / cin) ** 0.5, dtype=f32).t()
        b = randn(co, scale=0.1, dtype=f32)
        return [(randn(1, cin, s, s, s, dtype=f32), k, b) for _ in range(N_TIMED)]

    def dx_f32_inputs(gc, xc, s):
        w = conv_w(xc, gc)
        return [(randn(1, gc, s, s, s, dtype=f32), w) for _ in range(N_TIMED)]

    def dw_f32_inputs(cin, cout, s):
        return [(randn(1, cin, s, s, s, dtype=f32), randn(1, cout, s, s, s, scale=1e-2, dtype=f32))
                for _ in range(N_TIMED)]

    def pool_bwd_f32_inputs(c, s):
        out = []
        for _ in range(N_TIMED):
            x = tied_f32(1, c, s, s, s)
            out.append((x, pool.max_pool2x_cf_reference(x),
                        randn(1, c, s // 2, s // 2, s // 2, dtype=f32)))
        return out

    def head_dx_f32_inputs(co, cin, s):
        k = randn(co, cin, scale=(1.0 / cin) ** 0.5, dtype=f32).t()
        return [(randn(1, co, s, s, s, scale=1e-3, dtype=f32), k) for _ in range(N_TIMED)]

    def head_dw_f32_inputs(cin, co, s):
        return [(randn(1, cin, s, s, s, dtype=f32), randn(1, co, s, s, s, scale=1e-3, dtype=f32))
                for _ in range(N_TIMED)]

    def boundary_f32_inputs(cin, cout, s):
        w, b = conv_w(cin, cout), randn(cout, scale=0.1, dtype=f32)
        return [(randn(1, cin, s, s, s, dtype=f32), w, b, *affine(cin)) for _ in range(N_TIMED)]

    def dx_epilogue_f32_inputs(cin, cout, s):  # the boundary conv's channels
        w = conv_w(cin, cout)
        return [(randn(1, cout, s, s, s, scale=1e-2, dtype=f32), w,
                 randn(1, cin, s, s, s, dtype=f32), *affine(cin)) for _ in range(N_TIMED)]

    def dw_prologue_f32_inputs(cin, cout, s):
        return [(randn(1, cin, s, s, s, dtype=f32), randn(1, cout, s, s, s, scale=1e-2, dtype=f32),
                 *affine(cin)) for _ in range(N_TIMED)]

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

    def lib_dx_input(g, w):  # the conv's input gradient, as cuDNN's backward computes it
        shape = (g.shape[0], w.shape[3], *g.shape[2:])
        return torch.nn.grad.conv3d_input(shape, w.permute(4, 3, 0, 1, 2), g, padding=1)

    def lib_head_dx_f32(ct, k):
        return torch.einsum("bodhw,io->bidhw", ct, k)

    # the fused fp32 kernels' library yardstick: the conv (cuDNN, TF32 off)
    # and the torch sums the kernel replaces; no prologue, no mask
    def lib_stats_f32(x, w, b, *affine_args):
        y = lib_conv(x, w, b)
        return y, y.sum(dim=(0, 2, 3, 4)), y.square().sum(dim=(0, 2, 3, 4))

    def lib_dx_epilogue_f32(g, w, x, a, t):
        dr = lib_dx_input(g, w)
        return dr, (dr * x).sum(dim=(2, 3, 4)), dr.sum(dim=(2, 3, 4))

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

    def conv_f32_work(cin, cout, s):  # fp32 x, w and out; FFMA
        return 4 * v(s) * (cin + cout) + 27 * cin * cout * 4, 2 * 27 * cin * cout * v(s), FP32_FLOPS

    def pool_f32_work(c, s):
        return 4 * c * v(s) * (1 + 1 / 8), 0.0, FP32_FLOPS

    def head_f32_work(cin, co, s):  # fp32 in and out, fp32 FMAs
        return 4 * v(s) * (cin + co), 2 * cin * co * v(s), FP32_FLOPS

    def pool_bwd_f32_work(c, s):  # x, y, g read, dx written, fp32
        return 4 * c * v(s) * (2 + 2 / 8), 0.0, FP32_FLOPS

    def head_dx_f32_work(co, cin, s):  # fp32 ct in, fp32 dx out
        return 4 * v(s) * (co + cin), 2 * cin * co * v(s), FP32_FLOPS

    def head_dw_f32_work(cin, co, s):  # fp32 x and ct in; dk's FMAs and db's adds
        return 4 * v(s) * (cin + co), (2 * cin + 1) * co * v(s), FP32_FLOPS

    # the fused fp32 kernels: the conv's FFMA and the fp32 work of the
    # prologue and the epilogues, as in bf16
    def stats_f32_work(cin, cout, s):
        return (*conv_f32_work(cin, cout, s), 4 * cout * v(s))

    def boundary_stats_f32_work(cin, cout, s):
        return (*conv_f32_work(cin, cout, s), (3 * cin + 4 * cout) * v(s))

    def boundary_f32_work(cin, cout, s):
        return (*conv_f32_work(cin, cout, s), (3 * cin + 1 * cout) * v(s))

    def dx_epilogue_f32_work(cin, cout, s):  # g and x read, dy written, fp32
        nbytes = 4 * v(s) * (cout + 2 * cin) + 27 * cin * cout * 4
        return nbytes, 2 * 27 * cin * cout * v(s), FP32_FLOPS, 8 * cin * v(s)

    def dw_prologue_f32_work(cin, cout, s):
        return (*conv_f32_work(cin, cout, s), 3 * cin * v(s))

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
        # the fp32 eval forward's instances; cuDNN's TF32 is off for every
        # plain and library call here (phase_device)
        "conv3x3x3_cf_relu_f32": (conv3.conv3x3x3_cf_relu_f32, conv3.conv3x3x3_cf_relu_reference,
                                  lib_conv, conv_f32_inputs, CONV_SHAPES, F32_TOL, conv_f32_work,
                                  "F.conv3d fp32, TF32 off (no ReLU)"),
        "max_pool2x_cf_f32": (pool.max_pool2x_cf_f32, pool.max_pool2x_cf_reference,
                              lambda x: F.max_pool3d(x, 2, 2), pool_f32_inputs, POOL_SHAPES, 0.0,
                              pool_f32_work, "F.max_pool3d fp32"),
        "head1x1_cf_f32": (head.head1x1_cf_f32, head.head1x1_cf_reference, lib_head,
                           head_f32_inputs, HEAD_SHAPES, F32_TOL, head_f32_work,
                           "1x1x1 F.conv3d fp32, TF32 off"),
        # the fp32 train step's instances, at the bf16 step's shapes
        "conv3x3x3_cf_f32": (conv3.conv3x3x3_cf_f32, conv3.conv3x3x3_cf_reference, lib_conv,
                             conv_f32_inputs, TRAIN_CONV_SHAPES, F32_TOL, conv_f32_work,
                             "F.conv3d fp32, TF32 off"),
        "conv3x3x3_cf_dx_f32": (conv3.conv3x3x3_cf_dx_f32, conv3.conv3x3x3_cf_dx_reference,
                                lib_dx_input, dx_f32_inputs, DX_SHAPES, F32_TOL,
                                conv_f32_work, "torch.nn.grad.conv3d_input fp32, TF32 off"),
        "conv3x3x3_cf_dw_f32": (conv3.conv3x3x3_cf_dw_f32, conv3.conv3x3x3_cf_dw_reference,
                                lib_dw, dw_f32_inputs, DW_SHAPES, F32_TOL, conv_f32_work,
                                "torch.nn.grad.conv3d_weight fp32, TF32 off"),
        "max_pool2x_cf_bwd_f32": (pool.max_pool2x_cf_bwd_f32, pool.max_pool2x_cf_bwd_reference,
                                  lib_pool_bwd, pool_bwd_f32_inputs, POOL_SHAPES, 0.0,
                                  pool_bwd_f32_work, "F.max_pool3d backward fp32 (first-match "
                                  "ties, not the same function)"),
        "head1x1_cf_dx_f32": (head.head1x1_cf_dx_f32,
                              lambda ct, k: head.head1x1_cf_dx_reference(ct, k, torch.float32),
                              lib_head_dx_f32, head_dx_f32_inputs, HEAD_DX_SHAPES, F32_TOL,
                              head_dx_f32_work, "torch.einsum fp32"),
        "head1x1_cf_dw_f32": (head.head1x1_cf_dw_f32, head.head1x1_cf_dw_reference, lib_head_dw,
                              head_dw_f32_inputs, HEAD_DW_SHAPES, HEAD_DW, head_dw_f32_work,
                              "torch.einsum fp32 plus sum"),
        # the fused DoubleConv's fp32 instances
        "conv3x3x3_cf_stats_f32": (ng(conv3_fused.conv3x3x3_cf_stats),
                                   conv3_fused.conv3x3x3_cf_stats_reference, lib_stats_f32,
                                   conv_f32_inputs, CONV0_SHAPES, F32_STATS, stats_f32_work,
                                   "F.conv3d fp32, TF32 off, + torch sums"),
        "conv3x3x3_cf_boundary_stats_f32": (ng(conv3_fused.conv3x3x3_cf_boundary_stats),
                                            conv3_fused.conv3x3x3_cf_boundary_stats_reference,
                                            lib_stats_f32, boundary_f32_inputs, CONV1_SHAPES,
                                            F32_STATS, boundary_stats_f32_work,
                                            "F.conv3d fp32, TF32 off, + torch sums; no prologue"),
        "conv3x3x3_cf_dx_epilogue_f32": (conv3_fused.conv3x3x3_cf_dx_epilogue,
                                         conv3_fused.conv3x3x3_cf_dx_epilogue_reference,
                                         lib_dx_epilogue_f32, dx_epilogue_f32_inputs,
                                         CONV1_SHAPES, F32_DX_EPILOGUE, dx_epilogue_f32_work,
                                         "torch.nn.grad.conv3d_input fp32, TF32 off, + torch "
                                         "sums; no mask"),
        "conv3x3x3_cf_dw_prologue_f32": (conv3_fused.conv3x3x3_cf_dw_prologue,
                                         conv3_fused.conv3x3x3_cf_dw_prologue_reference,
                                         lib_dw_prologue, dw_prologue_f32_inputs, CONV1_SHAPES,
                                         F32_TOL,
                                         dw_prologue_f32_work,
                                         "torch.nn.grad.conv3d_weight fp32, TF32 off; no "
                                         "prologue"),
        "conv3x3x3_cf_boundary_f32": (ng(conv3_fused.conv3x3x3_cf_boundary),
                                      conv3_fused.conv3x3x3_cf_boundary_reference,
                                      lib_boundary, boundary_f32_inputs, CONV1_SHAPES, F32_TOL,
                                      boundary_f32_work, "F.conv3d fp32, TF32 off; no prologue"),
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
            "head1x1_cf_dx": head.dx_call, "head1x1_cf_dw": head.dw_call,
            "conv3x3x3_cf_relu_f32": conv3.relu_f32_call, "max_pool2x_cf_f32": pool.pool_f32_call,
            "head1x1_cf_f32": head.head_f32_call, "conv3x3x3_cf_f32": conv3.conv_f32_call,
            "conv3x3x3_cf_dx_f32": conv3.dx_f32_call, "conv3x3x3_cf_dw_f32": conv3.dw_f32_call,
            "max_pool2x_cf_bwd_f32": pool.bwd_f32_call, "head1x1_cf_dx_f32": head.dx_f32_call,
            "head1x1_cf_dw_f32": head.dw_f32_call,
            # the fused ops' builders take the fp32 body for fp32 tensors
            "conv3x3x3_cf_stats_f32": conv3_fused.stats_call,
            "conv3x3x3_cf_boundary_stats_f32": conv3_fused.boundary_stats_call,
            "conv3x3x3_cf_dx_epilogue_f32": conv3_fused.dx_epilogue_call,
            "conv3x3x3_cf_dw_prologue_f32": conv3_fused.dw_prologue_call,
            "conv3x3x3_cf_boundary_f32": conv3_fused.boundary_call}


# the conv-body instances of the train step (12 has no caller, 7 is eval's)
TRAIN_BODY = ("conv3x3x3_cf", "conv3x3x3_cf_dx", "conv3x3x3_cf_stats",
              "conv3x3x3_cf_boundary_stats", "conv3x3x3_cf_dx_epilogue")
# the dW body's instances: 2 over DW_SHAPES, 6 over CONV1_SHAPES
TRAIN_DW = ("conv3x3x3_cf_dw", "conv3x3x3_cf_dw_prologue")
# the fp32 conv body's instances of the fp32 train step, and its dW body's
F32_TRAIN_BODY = ("conv3x3x3_cf_f32", "conv3x3x3_cf_dx_f32", "conv3x3x3_cf_stats_f32",
                  "conv3x3x3_cf_boundary_stats_f32", "conv3x3x3_cf_dx_epilogue_f32")
F32_TRAIN_DW = ("conv3x3x3_cf_dw_f32", "conv3x3x3_cf_dw_prologue_f32")
# the fp32 conv body's instances: 7-fp32 over the fp32 eval forward, the
# train step's (1-, 1-dx-, 3-, 4-, 5-fp32) and 12-fp32 over conv1's shapes
F32_CONV_BODY = ("conv3x3x3_cf_relu_f32", *F32_TRAIN_BODY, "conv3x3x3_cf_boundary_f32")
# the 3xTF32 bodies: their bound counts each multiply as three TF32
# tensor-core products; phase 3 prints the FFMA bound beside it
TF32X3 = (*F32_CONV_BODY, *F32_TRAIN_DW)


def _bounds_ms(name: str, work, shape) -> tuple:
    """(bytes, operations, FFMA) bounds of one call in ms: the bytes over the
    memory rate; the operations over their type's peak, a 3xTF32 body's
    multiplies (TF32X3) as three TF32 tensor-core products each; the same
    multiplies on the CUDA cores (the operations bound of every other row)."""
    nbytes, flops, peak, *fp32_flops = work(*shape)
    rest_s = sum(fp32_flops) / FP32_FLOPS
    mul_s = 3 * flops / TF32_FLOPS if name in TF32X3 else flops / peak
    return (nbytes / HBM_BYTES_PER_S * 1e3, (mul_s + rest_s) * 1e3,
            (flops / peak + rest_s) * 1e3)


def _pool_nan_checks(make) -> None:
    """The fp32 pool at every eval shape on tied inputs with a NaN planted
    in a few windows: the NaNs win where they are, every other value is
    the plain version's exactly."""
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import pool

    for c, s in POOL_SHAPES:
        (x,) = make(c, s)[0]
        flat = x.view(-1)
        planted = torch.arange(7, flat.numel(), flat.numel() // 5, device=x.device)[:5]
        flat[planted] = float("nan")
        got, want = pool.max_pool2x_cf_f32(x), pool.max_pool2x_cf_reference(x)
        nan_got, nan_want = got.isnan(), want.isnan()
        ok = (int(nan_want.sum()) == len(planted) and torch.equal(nan_got, nan_want)
              and torch.equal(got[~nan_got], want[~nan_want]))
        print(f"[kernel] max_pool2x_cf_f32 ({c}, {s}) with {len(planted)} NaNs planted: "
              f"{int(nan_got.sum())} NaN outputs where the plain version has "
              f"{int(nan_want.sum())}, the rest {'equal' if ok else 'DIFFERENT'}", flush=True)
        fail_unless(ok, f"max_pool2x_cf_f32 ({c}, {s}): NaN propagation differs")


def _tf32_dw_control(make) -> None:
    """The 16->16 192^3 weight gradient by cuDNN with TF32 allowed against
    the plain version (TF32 off): its error must read above F32_TOL, the
    fp32 dW's bound."""
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import conv3

    x, g = make(16, 16, 192)[0]
    want = conv3.conv3x3x3_cf_dw_reference(x, g)
    got = conv3.conv3x3x3_cf_dw_f32(x, g)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        tf32 = torch.nn.grad.conv3d_weight(x, (16, 16, 3, 3, 3), g, padding=1)
    tf32 = tf32.permute(2, 3, 4, 1, 0)  # (Cout, Cin, kd, kh, kw) -> (kd, kh, kw, Cin, Cout)
    scale = want.abs().max()
    err_tf32 = ((tf32 - want).abs().max() / scale).item()
    err_kernel = ((got - want).abs().max() / scale).item()
    print(f"[kernel] TF32 control, dW 16->16 at 192^3: torch.nn.grad.conv3d_weight with "
          f"cuDNN's TF32 allowed is {err_tf32:.4g} of max|plain| from the fp32 plain version "
          f"(must exceed {F32_TOL:g}); the fp32 kernel {err_kernel:.4g}", flush=True)
    fail_unless(err_tf32 > F32_TOL, "the dW TF32 control reads within the fp32 bound")
    fail_unless(not torch.backends.cudnn.allow_tf32, "cuDNN's TF32 left on after the control")


def _tf32_control(make) -> None:
    """The 16->16 192^3 conv by F.conv3d with cuDNN's TF32 allowed against
    the plain version (TF32 off): its error must read above F32_TOL, so that
    the bound can tell a TF32 pass from an fp32 one."""
    import torch
    import torch.nn.functional as F

    from multimodal_segmentation_project_tpu_torch.ops import conv3

    x, w, b = make(16, 16, 192)[0]
    want = conv3.conv3x3x3_cf_relu_reference(x, w, b)
    got = conv3.conv3x3x3_cf_relu_f32(x, w, b)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        tf32 = torch.relu(F.conv3d(x, w.permute(4, 3, 0, 1, 2), b, padding=1))
    scale = want.abs().max()
    err_tf32 = ((tf32 - want).abs().max() / scale).item()
    err_kernel = ((got - want).abs().max() / scale).item()
    print(f"[kernel] TF32 control, 16->16 at 192^3: F.conv3d with cuDNN's TF32 allowed is "
          f"{err_tf32:.4g} of max|plain| from the fp32 plain version (must exceed "
          f"{F32_TOL:g}); the fp32 kernel {err_kernel:.4g}", flush=True)
    fail_unless(err_tf32 > F32_TOL, "the TF32 control reads within the fp32 bound")
    fail_unless(not torch.backends.cudnn.allow_tf32, "cuDNN's TF32 left on after the control")


def _quickstart_kernel_checks(plan) -> None:
    """Every kernel the quickstart launches at its shapes (QUICKSTART_SHAPES:
    Cout = 8 at 32^3, 16 at 16^3, the 32-wide bottleneck at 8^3, batch 2,
    and 1 for the eval forward's kernels) against its plain version, under
    the tolerance of its 192^3 rows; prints its time as called and the plain
    version's."""
    for name, shapes in QUICKSTART_SHAPES.items():
        kern, plain, _, make, _, tol, *_ = plan[name]
        for shape in shapes:
            inputs = make(*shape)
            err, rel, ok, sums = _errors(f"{name} {shape}", kern, plain, inputs, tol)
            ms, plain_ms = _time_ms(kern, inputs), _time_ms(plain, inputs)
            sums_label = "" if sums is None else f", sums at {sums:.4g} of their bound"
            print(f"[kernel] {name} {shape[:-1]} batch {shape[-1]} (quickstart): max_abs_err "
                  f"{err:.4g} scaled {rel:.4g}{sums_label}, {_tol_label(tol)}: "
                  f"{'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms",
                  flush=True)
            fail_unless(ok, f"{name} {shape}: error {err} (scaled {rel}) over tolerance")


# the multi-device path (phase 11): every conv on a spatial mesh runs on its
# rank's haloed slab of D (Dl + 2 planes: at 1 x 2, 98, 50 and 26 at the
# kernels' 192, 96 and 48 levels; at 1 x 4, 50, 26 and 14), and every pool
# on its slab (Dl planes)
MESH_SPLITS = (2, 4)


def _haloed_d_checks(plan, randn) -> None:
    """Kernels 1, 1-dx, 2 and 7 (bf16 and fp32) at every per-conv chain shape
    with D the haloed slab's planes at 1 x 2 and 1 x 4, and 8 and 9 (bf16
    and fp32) at the slabs' D, against their plain versions under their
    192^3 rows' tolerances; correctness only."""
    import torch

    f32 = torch.float32

    def w_of(cin, cout):
        return randn(3, 3, 3, cin, cout, scale=(2.0 / (27 * cin)) ** 0.5, dtype=f32)

    def checks():  # made one at a time: the slabs are full width
        for n in MESH_SPLITS:
            for cin, cout, s in sorted(set(CONV_SHAPES)):
                d = s // n + 2
                for dt, suffix in ((torch.bfloat16, ""), (f32, "_f32")):
                    x = randn(1, cin, d, s, s, dtype=dt)
                    w, b = w_of(cin, cout), randn(cout, scale=0.1, dtype=f32)
                    yield f"conv3x3x3_cf_relu{suffix}", n, (x, w, b)
                    yield f"conv3x3x3_cf{suffix}", n, (x, w, b)
                    yield f"conv3x3x3_cf_dw{suffix}", n, (x, randn(1, cout, d, s, s, scale=1e-2,
                                                                   dtype=dt))
            for gc, xc, s in sorted(set(PER_CONV_DX_SHAPES)):
                for dt, suffix in ((torch.bfloat16, ""), (f32, "_f32")):
                    yield (f"conv3x3x3_cf_dx{suffix}", n,
                           (randn(1, gc, s // n + 2, s, s, dtype=dt), w_of(xc, gc)))
            for c, s in POOL_SHAPES:
                for dt, suffix in ((torch.bfloat16, ""), (f32, "_f32")):
                    # halves in [-4, 4]: tied maxima in most windows
                    x = randn(1, c, s // n, s, s, scale=4.0, dtype=f32).round().clamp(-8, 8)
                    x = x.div(2).to(dt)
                    yield f"max_pool2x_cf{suffix}", n, (x,)
                    yield (f"max_pool2x_cf_bwd{suffix}", n,
                           (x, plan["max_pool2x_cf"][1](x),
                            randn(1, c, s // n // 2, s // 2, s // 2, dtype=dt)))

    worst: dict = {}
    for name, n, args in checks():
        kern, plain, *_, tol, _, _ = plan[name]
        label = f"{name} at 1 x {n}, slab {tuple(args[0].shape)}"
        err, rel, ok, _ = _errors(label, kern, plain, [args], tol)
        worst[name] = max(worst.get(name, 0.0), rel)
        fail_unless(ok, f"{label}: error {err} (scaled {rel}) over {_tol_label(tol)}")
    torch.cuda.empty_cache()
    for name, rel in worst.items():
        print(f"[kernel] {name} on the haloed slabs of D (1 x {' and 1 x '.join(map(str, MESH_SPLITS))}"
              f"): worst scaled err {rel:.4g}, {_tol_label(plan[name][5])}: ok", flush=True)


def phase_kernels() -> dict:
    """Each kernel vs its plain version at every slice shape."""
    import torch

    plan, randn = _kernel_plan()
    bare = bare_calls()
    fail_unless(set(bare) == set(plan), "every kernel needs a bare call")
    results = {}
    for name, (kern, plain, lib, make, shapes, tol, work, lib_label) in plan.items():
        tot = dict.fromkeys(("ms", "plain_ms", "bound_ms", "library_ms"), 0.0)
        extra = dict.fromkeys(("ffma_bound_ms", "library_benchmark_ms"), 0.0)
        bare_tot = 0.0
        max_abs = bytes_ms = ops_ms = 0.0
        for shape, mult in _count(shapes):
            inputs = make(*shape)
            err, rel, ok, sums = _errors(f"{name} {shape}", kern, plain, inputs, tol)
            ms = _time_ms(kern, inputs)
            plain_ms = _time_ms(plain, inputs)
            lib_ms = _time_ms(lib, inputs)
            one_bytes_ms, one_ops_ms, one_ffma_ms = _bounds_ms(name, work, shape)
            b_ms = max(one_bytes_ms, one_ops_ms)
            bytes_ms += mult * one_bytes_ms
            ops_ms += mult * one_ops_ms
            sums_label = "" if sums is None else f", sums at {sums:.4g} of their bound"
            if name in TF32X3:  # the FFMA bound (and the dW's library at its best algorithm)
                ffma_ms = max(one_bytes_ms, one_ffma_ms)
                extra["ffma_bound_ms"] += mult * ffma_ms
                sums_label += f", FFMA bound {ffma_ms:.4f} ms"
            if name in F32_TRAIN_DW:
                with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                                deterministic=False, allow_tf32=False):
                    lib_best_ms = _time_ms(lib, inputs)
                extra["library_benchmark_ms"] += mult * lib_best_ms
                sums_label += f", library with cudnn.benchmark {lib_best_ms:.4f} ms"
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
        if name in TF32X3:
            results[name].update(extra, bytes_bound_ms=bytes_ms)
        print(f"[kernel] {name}: summed over one pass (eval forward or train step; "
              f"kernel 12 over the train step's conv1 shapes): "
              + ", ".join(f"{k} {v:.4f}" for k, v in tot.items())
              + f", bare_ms {bare_tot:.4f}"
              + (f", ffma_bound_ms {extra['ffma_bound_ms']:.4f}" if name in TF32X3 else "")
              + (f", library_benchmark_ms {extra['library_benchmark_ms']:.4f}"
                 if name in F32_TRAIN_DW else ""), flush=True)
    # the fp32 training conv, its dx and its dW at the per-conv chain's other
    # shapes (every conv of a step with no fused block, the JAX package's
    # data-mesh configuration); correctness only
    for name, shapes in (("conv3x3x3_cf_f32", CONV_SHAPES),
                         ("conv3x3x3_cf_dx_f32", PER_CONV_DX_SHAPES),
                         ("conv3x3x3_cf_dw_f32", CONV_SHAPES)):
        kern, plain, _, make, step_shapes, tol, *_ = plan[name]
        for shape in sorted(set(shapes) - set(step_shapes)):
            err, rel, ok, _ = _errors(f"{name} {shape}", kern, plain, make(*shape), tol)
            print(f"[kernel] {name} {shape} (per-conv chain): max_abs_err {err:.4g} scaled "
                  f"{rel:.4g}, {_tol_label(tol)}: {'ok' if ok else 'FAIL'}", flush=True)
            fail_unless(ok, f"{name} {shape}: error {err} (scaled {rel}) over tolerance")
            torch.cuda.empty_cache()
    _quickstart_kernel_checks(plan)
    _haloed_d_checks(plan, randn)
    step = {k: sum(results[n][k] for n in TRAIN_BODY) for k in ("ms", "bare_ms", "library_ms")}
    print(f"[kernel] conv body per train step ({', '.join(TRAIN_BODY)}): kernel as called "
          f"{step['ms']:.4f} ms, bare launches {step['bare_ms']:.4f} ms, library "
          f"{step['library_ms']:.4f} ms", flush=True)
    step = {k: sum(results[n][k] for n in TRAIN_DW) for k in ("ms", "bare_ms", "library_ms")}
    print(f"[kernel] dW body per train step ({', '.join(TRAIN_DW)}): as called / bare / "
          f"library {step['ms']:.4f} / {step['bare_ms']:.4f} / {step['library_ms']:.4f} ms",
          flush=True)
    for label, names in (("fp32 conv body", F32_TRAIN_BODY), ("fp32 dW body", F32_TRAIN_DW)):
        step = {k: sum(results[n][k] for n in names)
                for k in ("ms", "bare_ms", "bound_ms", "library_ms")}
        print(f"[kernel] {label} per fp32 train step ({', '.join(names)}): as called / bare / "
              f"bound / library {step['ms']:.4f} / {step['bare_ms']:.4f} / "
              f"{step['bound_ms']:.4f} / {step['library_ms']:.4f} ms", flush=True)
    for name in F32_CONV_BODY:
        r = results[name]
        print(f"[kernel] {name} per pass: as called {r['ms']:.4f} ms, bare {r['bare_ms']:.4f} "
              f"ms; bounds: 3xTF32 {r['bound_ms']:.4f} ms, FFMA {r['ffma_bound_ms']:.4f} ms, "
              f"bytes {r['bytes_bound_ms']:.4f} ms; library {r['library_ms']:.4f} ms", flush=True)
    for name in F32_TRAIN_DW:
        r = results[name]
        print(f"[kernel] {name} per fp32 train step: as called {r['ms']:.4f} ms, bare "
              f"{r['bare_ms']:.4f} ms; bounds: 3xTF32 {r['bound_ms']:.4f} ms, FFMA "
              f"{r['ffma_bound_ms']:.4f} ms, bytes {r['bytes_bound_ms']:.4f} ms; library "
              f"{r['library_ms']:.4f} ms, with cudnn.benchmark {r['library_benchmark_ms']:.4f} "
              f"ms", flush=True)
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
    # the fp32 instances: the conv body (7-fp32) at W = 37 and 33 (4-byte
    # staging and stores) and an unaligned view, Cin = 1, 3, 40 (five chunks,
    # the last partial) and 64, Cout = 8, 20, 48 and 64 (partial channel
    # groups), batch 2; the pool (8-fp32) at odd extents; the head (11-fp32)
    # at V % 8 != 0, an unaligned view, classes 3, 4 and 8, 2 x 67^3 voxels
    for x, cout in ((randn(2, 3, 5, 7, 37, dtype=f32), 8), (randn(1, 40, 3, 9, 20, dtype=f32), 20),
                    (unaligned(2, 16, 4, 8, 16, dtype=f32), 48),
                    (randn(1, 64, 5, 9, 33, dtype=f32), 64), (randn(1, 1, 3, 9, 16, dtype=f32), 16)):
        edges.append(("conv3x3x3_cf_relu_f32",
                      (x, randn(3, 3, 3, x.shape[1], cout, scale=(2 / (27 * x.shape[1])) ** 0.5,
                                dtype=f32), randn(cout, scale=0.1, dtype=f32))))
    edges.append(("max_pool2x_cf_f32", (randn(2, 3, 5, 7, 9, dtype=f32),)))
    for x, co in ((randn(2, 5, 3, 5, 7, dtype=f32), 3), (unaligned(2, 40, 2, 4, 8, dtype=f32), 4),
                  (randn(2, 16, 67, 67, 67, dtype=f32), 4), (randn(1, 64, 3, 3, 3, dtype=f32), 8)):
        cf = x.shape[1]
        edges.append(("head1x1_cf_f32", (x, randn(co, cf, scale=cf ** -0.5, dtype=f32).t(),
                                         randn(co, scale=0.1, dtype=f32))))
    # the fp32 train step's instances: the conv (1-fp32) and its dx at W = 7,
    # 9, 20 and 37 and an unaligned view, Cin = 1 and 40, Cout = 20 and 48,
    # batch 2; the dW (2-fp32) at the bf16 dW's ragged inputs and W = 7; the
    # pool backward (9-fp32) at odd extents with ties; the head's dx and
    # weight gradient (11-dx-fp32, 11-dw-fp32) at V % 8 != 0, Cf = 16, 40
    # and 64, classes 1, 3, 4 and 8, batch 2, unaligned views and 2 x 67^3
    for x, cout in ((randn(2, 3, 5, 7, 37, dtype=f32), 8), (randn(1, 40, 3, 9, 20, dtype=f32), 20),
                    (randn(2, 1, 3, 9, 9, dtype=f32), 48), (randn(1, 20, 3, 9, 7, dtype=f32), 48),
                    (unaligned(2, 16, 4, 8, 16, dtype=f32), 20)):
        cin = x.shape[1]
        w = randn(3, 3, 3, cin, cout, scale=(2 / (27 * cin)) ** 0.5, dtype=f32)
        edges.append(("conv3x3x3_cf_f32", (x, w, randn(cout, scale=0.1, dtype=f32))))
        edges.append(("conv3x3x3_cf_dx_f32", (randn(x.shape[0], cout, *x.shape[2:], dtype=f32),
                                              w)))
    for x, g in ((randn(2, 40, 3, 9, 37, dtype=f32), randn(2, 20, 3, 9, 37, dtype=f32)),
                 (randn(2, 40, 3, 9, 9, dtype=f32), randn(2, 48, 3, 9, 9, dtype=f32)),
                 (randn(1, 1, 3, 9, 20, dtype=f32), randn(1, 20, 3, 9, 20, dtype=f32)),
                 (randn(1, 40, 3, 9, 20, dtype=f32), randn(1, 48, 3, 9, 20, dtype=f32)),
                 (randn(1, 16, 5, 9, 7, dtype=f32), randn(1, 16, 5, 9, 7, dtype=f32)),
                 (unaligned(2, 16, 3, 9, 16, dtype=f32), unaligned(2, 20, 3, 9, 16, dtype=f32))):
        edges.append(("conv3x3x3_cf_dw_f32", (x, g)))
    x_odd32 = randn(2, 3, 5, 7, 9, scale=4.0, dtype=f32).round().clamp(-8, 8) / 2  # ties
    edges.append(("max_pool2x_cf_bwd_f32", (x_odd32, plan["max_pool2x_cf"][1](x_odd32),
                                            randn(2, 3, 2, 3, 4, dtype=f32))))
    for ct, cf in ((randn(2, 3, 3, 5, 7, dtype=f32), 40), (randn(2, 4, 2, 4, 8, dtype=f32), 64),
                   (unaligned(2, 4, 2, 4, 8, dtype=f32), 40), (randn(1, 4, 3, 3, 3, dtype=f32), 16)):
        edges.append(("head1x1_cf_dx_f32", (ct, randn(cf, ct.shape[1], dtype=f32))))
    for x, co in ((randn(2, 5, 3, 5, 7, dtype=f32), 3), (randn(2, 40, 3, 5, 7, dtype=f32), 8),
                  (randn(2, 64, 2, 4, 8, dtype=f32), 1), (unaligned(2, 40, 2, 4, 8, dtype=f32), 4),
                  (randn(2, 16, 67, 67, 67, dtype=f32), 4)):
        edges.append(("head1x1_cf_dw_f32",
                      (x, randn(x.shape[0], co, *x.shape[2:], scale=1e-3, dtype=f32))))
    # the fused block's fp32 instances (3-, 4-, 5-, 6- and 12-fp32): W = 7,
    # 9, 20 and 37 (4-byte staging and stores), Cin = 1 and 40 (five chunks,
    # the last partial), Cout = 20 and 48 (partial channel groups), batch 2,
    # an unaligned view; a, t as the fused block makes them (t > 0 on some
    # channels, where a leaking halo would show)
    for x, cout in ((randn(2, 40, 3, 9, 20, dtype=f32), 20), (randn(1, 16, 5, 9, 7, dtype=f32), 48),
                    (randn(2, 1, 3, 9, 9, dtype=f32), 48), (randn(2, 40, 3, 9, 37, dtype=f32), 20),
                    (unaligned(2, 16, 4, 8, 16, dtype=f32), 20)):
        cin = x.shape[1]
        w = randn(3, 3, 3, cin, cout, scale=(2 / (27 * cin)) ** 0.5, dtype=f32)
        b = randn(cout, scale=0.1, dtype=f32)
        a, t = (randn(x.shape[0], cin, scale=s_, dtype=f32) for s_ in (1.0, 0.5))
        a = a.abs() + 0.5
        g = (unaligned if x.data_ptr() % 16 else randn)(x.shape[0], cout, *x.shape[2:],
                                                        dtype=f32).mul_(1e-2)
        edges += [("conv3x3x3_cf_stats_f32", (x, w, b)),
                  ("conv3x3x3_cf_boundary_stats_f32", (x, w, b, a, t)),
                  ("conv3x3x3_cf_boundary_f32", (x, w, b, a, t)),
                  ("conv3x3x3_cf_dx_epilogue_f32", (g, w, x, a, t)),
                  ("conv3x3x3_cf_dw_prologue_f32", (x, g, a, t))]
    for name, args in edges:
        kern, plain, *_, tol, _, _ = plan[name]
        label = f"{name} edge input {tuple(args[0].shape)}"
        if name in (*TRAIN_DW, *F32_TRAIN_DW):
            label += f", Cout {args[1].shape[1]}"
        elif name == "upconv2x_cf":
            label += f", Cout {args[1].shape[4]}"
        elif name in ("head1x1_cf_dx", "head1x1_cf_dx_f32"):
            label += f", Cf {args[1].shape[0]}"
        elif name in ("head1x1_cf", "head1x1_cf_dw", "head1x1_cf_f32", "head1x1_cf_dw_f32"):
            label += f", classes {args[1].shape[1]}"
        elif name in ("conv3x3x3_cf_relu_f32", "conv3x3x3_cf_f32", "conv3x3x3_cf_stats_f32",
                      "conv3x3x3_cf_boundary_stats_f32", "conv3x3x3_cf_boundary_f32"):
            label += f", Cout {args[1].shape[4]}"
        elif name == "conv3x3x3_cf_dx_epilogue_f32":
            label += f", boundary conv Cin {args[1].shape[3]}"
        elif name == "conv3x3x3_cf_dx_f32":
            label += f", dx channels {args[1].shape[3]}"
        if any(a.data_ptr() % 16 for a in args[:2]):
            label += ", unaligned"
        err, rel, ok, _ = _errors(label, kern, plain, [args], tol)
        print(f"[kernel] {label}: scaled err {rel:.4g} {'ok' if ok else 'FAIL'}", flush=True)
        fail_unless(ok, f"{label}: error {err} over tolerance")

    _pool_nan_checks(plan["max_pool2x_cf_f32"][3])
    _tf32_control(plan["conv3x3x3_cf_relu_f32"][3])
    _tf32_dw_control(plan["conv3x3x3_cf_dw_f32"][3])

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
        ("conv3x3x3_cf_dw_f32", (32, 16, 192), (x32.float(), g16.float())),
        ("conv3x3x3_cf_stats_f32", (32, 16, 192),
         (x32.float(), randn(3, 3, 3, 32, 16, scale=0.05, dtype=f32), b16)),
        ("conv3x3x3_cf_boundary_stats_f32", (16, 16, 192),
         (x16.float(), w16, b16, a16, t16)),
        ("conv3x3x3_cf_dx_epilogue_f32", (16, 16, 192),
         (g16.float(), w16, x16.float(), a16, t16)),
        ("conv3x3x3_cf_dw_prologue_f32", (16, 16, 192), (x16.float(), g16.float(), a16, t16)),
        ("head1x1_cf_dw_f32", (16, 4, 192), (x16.float(), randn(1, 4, 192, 192, 192, scale=1e-3,
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
                  size: int, precision: str = "bf16") -> dict:
    """The eval CLI on the GPU; checks per-forward launches and artifacts."""
    import torch

    from multimodal_segmentation_project_tpu_torch import ops
    from multimodal_segmentation_project_tpu_torch.workloads import test_model

    args = test_model.build_parser().parse_args([
        "--model_path", pth, "--data_root", str(data), "--experiment_dir", str(exp),
        "--model_name", model_name, "--no_visualizations", "--precision", precision,
    ])
    per_forward = PER_FORWARD if precision == "bf16" else PER_FP32_FORWARD
    ops.reset_launch_counts()
    test_model.main(args)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    n_forwards = 1 + n_cases  # the untimed warm-up, then one per case (batch 1)
    print(f"[eval] {precision}: launches over {n_forwards} forwards: {counts}", flush=True)
    for name, n in counts.items():
        want = per_forward.get(name, 0) * n_forwards
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


# fp32 eval parity: the GPU's fp32 forward against the CPU's, 64^3, full
# width. Both compute in fp32 (cuDNN's TF32 off in the deep region and the
# upconvs); they differ by the sums' order, about 1e-6 of a conv's value,
# grown through 22 convs. A TF32 pass anywhere would put about 1e-3 there.
F32_PARITY_TOL = 1e-4         # max |gpu - cpu| / max |cpu|
F32_PARITY_ARGMAX_MIN = 0.999  # share of voxels with the same class


@contextlib.contextmanager
def _counting_library():
    """The model's library convs and transpose convs (``unet3d.F.conv3d``,
    ``conv_transpose3d``) called from the host while the block runs; yields
    the counts. As the kernel ops' counters do, it leaves out a call that a
    CUDA graph's capture records (``engine/steps.py:_Replay``): its kernels
    run at the graph's replays, on the device alone."""
    import torch

    from multimodal_segmentation_project_tpu_torch.models import unet3d

    counts = dict.fromkeys(LIBRARY_PER_FP32_FORWARD, 0)
    real = unet3d.F

    class Counting:
        def __getattr__(self, name):
            fn = getattr(real, name)
            if name not in counts:
                return fn

            def call(*args, **kwargs):
                if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
                    counts[name] += 1
                return fn(*args, **kwargs)
            return call

    unet3d.F = Counting()
    try:
        yield counts
    finally:
        unet3d.F = real


def _replayed() -> int:
    """The train steps replayed as CUDA graphs so far, over every step
    (``engine/steps.py:_Replay``): their kernels run with no launch from the
    host, so the host's launch counters leave them out."""
    from multimodal_segmentation_project_tpu_torch.engine.steps import _Replay

    return _Replay.replayed


# name prefixes of the port's own kernels (csrc/*.cu) in the profiler's trace
PORT_KERNELS = ("conv3_", "head1x1_", "pool2x_", "upconv_d2s_")


def _device_kernels(run, args) -> dict:
    """The kernels that one call ``run(*args)`` runs on the device, by name,
    counted in the profiler's trace: CUPTI records a replayed CUDA graph's
    kernels as it does kernels launched one by one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(*args)
        torch.cuda.synchronize()
    counts: dict = {}
    for evt in prof.events():
        if ("cuda" not in str(getattr(evt, "device_type", "")).lower()
                or getattr(evt, "is_user_annotation", False)):
            continue
        counts[evt.name] = counts.get(evt.name, 0) + 1
    return counts


def _of_port(kernels: dict) -> dict:
    return {k: n for k, n in kernels.items() if any(p in k for p in PORT_KERNELS)}


def _of_library(kernels: dict) -> int:
    return sum(n for k, n in kernels.items()
               if _kernel_category(k).startswith(("cuDNN", "matmul")))


def _library_calls(model, x) -> dict:
    """The library convs and transpose convs one forward of ``model`` calls."""
    import torch

    with _counting_library() as counts, torch.inference_mode():
        model(x)
    return counts


def phase_fp32_eval(n_cases: int = 2, size: int = 192) -> dict:
    """The eval CLI with --precision fp32 on phase 4's cases and model, the
    fp32 forward's library calls, its parity with the CPU at 64^3, and its
    time and peak beside bf16's. It runs with cuDNN's flags at PyTorch's
    defaults (TF32 allowed), as a user's process has them: the fp32
    forward must turn TF32 off itself."""
    import torch

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=True):
        counts = _run_eval_cli(str(SCRATCH / "unet3d_seed0.pth"), SCRATCH / "eval_data",
                               SCRATCH / "eval_fp32_exp", "smoke_fp32", n_cases, size,
                               precision="fp32")
        model32 = make_model(torch.float32).cuda()
        model16 = make_model(torch.bfloat16).cuda()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        xs = [torch.rand(1, 1, size, size, size, generator=gen, device="cuda")
              for _ in range(N_TIMED)]
        lib = _library_calls(model32, xs[0])
        print(f"[fp32] library calls per fp32 eval forward: {lib}", flush=True)
        fail_unless(lib == LIBRARY_PER_FP32_FORWARD,
                    f"library calls {lib}, want {LIBRARY_PER_FP32_FORWARD}")

        x, _ = _parity_case(SEED + 100, PARITY_SIZE)
        with torch.inference_mode():
            want = make_model(torch.float32)(x)
            got = model32(x.cuda()).cpu()
        fail_unless(got.shape == want.shape and bool(torch.isfinite(got).all()),
                    f"fp32 logits {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
        err = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
        ok = err <= F32_PARITY_TOL and agree >= F32_PARITY_ARGMAX_MIN
        print(f"[fp32] parity {PARITY_SIZE}^3 full width, GPU fp32 kernels vs CPU fp32 plain: "
              f"scaled max logit error {err:.4g} (<= {F32_PARITY_TOL:g}), argmax agreement "
              f"{agree:.6f} (>= {F32_PARITY_ARGMAX_MIN}) {'ok' if ok else 'FAIL'}", flush=True)
        fail_unless(ok, "fp32 eval parity over tolerance")

        times, peaks = {}, {}
        with torch.inference_mode():
            for label, model in (("fp32", model32), ("bf16", model16)):
                times[label] = _time_ms(lambda v, m=model: m(v), [(v,) for v in xs])
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                model(xs[0])
                torch.cuda.synchronize()
                peaks[label] = torch.cuda.max_memory_allocated() / 2**30
            case, _ = _parity_case(SEED + 500, size)
            case = case.cuda()
            pred32, pred16 = model32(case).argmax(1), model16(case).argmax(1)
            share = (pred32 == pred16).float().mean().item()
        print(f"[fp32] UNet3D eval forward at {size}^3, batch 1: fp32 median {times['fp32']:.3f} "
              f"ms, bf16 {times['bf16']:.3f} ms (CUDA events, {N_TIMED} distinct inputs) | peak "
              f"allocated fp32 {peaks['fp32']:.2f} GiB, bf16 {peaks['bf16']:.2f} GiB | fp32 and "
              f"bf16 predictions agree on {share:.6f} of a synthetic {size}^3 CT case's voxels",
              flush=True)
    fail_unless(not cudnn.allow_tf32, "cuDNN's TF32 left on after the fp32 phase")
    return counts


TRAIN_SPLITS = {"train": 2, "val": 1, "test": 1}
TRAIN_EPOCHS = 2
N_STEPS_TIMED = 6
N_STEPS_PROFILED = 3


OTHER_CATEGORY = "elementwise and other torch kernels"


def _kernel_category(name: str) -> str:
    """Device-time category of a kernel in the profiler trace."""
    for key, cat in (("conv3_dw", "conv3_dw (dW kernels, plain and prologue, bf16 and fp32: "
                                  "partial sums + reduce)"),
                     ("stats_reduce", "conv3_stats_reduce (the fused convs' channel sums, bf16 "
                                      "and fp32)"),
                     ("conv3_f32", "conv3_f32 (the fp32 conv body: forward, fused stats/boundary "
                                   "and dx kernels, eval conv)"),
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
    from multimodal_segmentation_project_tpu_torch.engine.steps import _Replay, make_train_step
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
    replayed = _replayed()
    t0 = time.perf_counter()
    train_unet.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    replayed = _replayed() - replayed
    steps = TRAIN_SPLITS["train"] * TRAIN_EPOCHS
    evals = TRAIN_SPLITS["val"] * TRAIN_EPOCHS
    print(f"[train] CLI: {TRAIN_EPOCHS} epochs, {steps} steps ({replayed} replayed as CUDA "
          f"graphs) and {evals} validation forwards in {secs:.2f} s; launches from the host "
          f"{counts}", flush=True)
    fail_unless(replayed == steps - _Replay.WARM_UP,
                f"{replayed} of the CLI's {steps} steps replayed, want all but the warm-up's")
    for name, n in counts.items():
        want = PER_STEP.get(name, 0) * (steps - replayed) + PER_FORWARD.get(name, 0) * evals
        fail_unless(n == want, f"{name}: {n} launches, want {want} ({PER_STEP.get(name, 0)}"
                               f"/eager step, {PER_FORWARD.get(name, 0)}/forward)")
    with open(exp / "smoke_train" / "logs" / "train_log.csv") as f:
        rows = list(csv.DictReader(f))
    fail_unless(len(rows) == TRAIN_EPOCHS, f"train_log.csv has {len(rows)} rows")
    for r in rows:
        for key in ("train_loss", "val_loss", "train_dice", "val_dice"):
            fail_unless(math.isfinite(float(r[key])), f"epoch {r['epoch']}: {key} {r[key]}")
    print("[train] epochs (loss, dice): " + "; ".join(
        f"{r['epoch']}: train {float(r['train_loss']):.4f}/{float(r['train_dice']):.4f} "
        f"val {float(r['val_loss']):.4f}/{float(r['val_dice']):.4f}" for r in rows), flush=True)
    ckpts = sorted(p.name for p in (exp / "smoke_train" / "checkpoints").iterdir())
    want_ckpts = ["best_model_smoke_train.msgpack", "best_model_smoke_train.msgpack.json"]
    print(f"[train] checkpoints: {ckpts}", flush=True)
    fail_unless(ckpts == want_ckpts, f"checkpoints {ckpts}, want the JAX CLI's {want_ckpts}")
    best = exp / "smoke_train" / "checkpoints" / "best_model_smoke_train.msgpack"
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
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step(state, *batch(200))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    med = statistics.median(times)
    print(f"[train] step at {size}^3, batch 1, bf16, ce_tversky, augmentation on: median "
          f"{med:.3f} ms over {N_STEPS_TIMED} distinct inputs (host clock around "
          f"synchronize; all {[round(t, 3) for t in times]}) | peak allocated {peak:.2f} GiB, "
          f"reserved {reserved:.2f} GiB (the replayed step's activations lie in its graphs' "
          f"pool, which only the reserved peak sees)", flush=True)
    _profile_steps(lambda *args: step(state, *args),
                   [batch(300 + i) for i in range(N_STEPS_PROFILED)])
    return counts


def _leaf_dtypes(tree) -> set:
    return {str(getattr(leaf, "dtype", type(leaf).__name__)) for leaf in _iter_leaves(tree)}


def phase_fp32_train(size: int = 192) -> dict:
    """Phase 6b: the train CLI on phase 6's data and recipe with no
    --mixed_precision flag (fp32, the JAX CLIs' default): the fused block
    where bf16 takes it, exact launches and library calls, fp32 parameters
    in the .msgpack it writes; then the fp32 step alone."""
    import csv

    import torch

    from multimodal_segmentation_project_tpu_torch import ops
    from multimodal_segmentation_project_tpu_torch.engine import checkpoint as ckpt
    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import _Replay, make_train_step
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn
    from multimodal_segmentation_project_tpu_torch.workloads import train_unet

    data, exp = SCRATCH / "train_data", SCRATCH / "train_fp32_exp"
    args = train_unet.build_parser().parse_args([
        "--data_root", str(data), "--experiment_dir", str(exp), "--batch_size", "1",
        "--epochs", str(TRAIN_EPOCHS), "--lr", "1e-3", "--weight_decay", "1e-4",
        "--gradient_accumulation_steps", "2", "--loss", "ce_tversky", "--early_stopping",
        "--patience", "10", "--seed", "42",
    ])
    fail_unless(args.mixed_precision == "no", f"the CLI's default is {args.mixed_precision}")
    args.experiment_name = "smoke_train_fp32"
    ops.reset_launch_counts()
    replayed = _replayed()
    t0 = time.perf_counter()
    with _counting_library() as lib:
        train_unet.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    replayed = _replayed() - replayed
    steps = TRAIN_SPLITS["train"] * TRAIN_EPOCHS
    evals = TRAIN_SPLITS["val"] * TRAIN_EPOCHS
    print(f"[train-fp32] CLI, no --mixed_precision flag (fp32): {TRAIN_EPOCHS} epochs, {steps} "
          f"steps ({replayed} replayed as CUDA graphs) and {evals} validation forwards in "
          f"{secs:.2f} s; launches from the host {counts}; library calls {lib}", flush=True)
    fail_unless(replayed == steps - _Replay.WARM_UP,
                f"{replayed} of the CLI's {steps} steps replayed, want all but the warm-up's")
    for name, n in counts.items():
        want = (PER_FP32_STEP.get(name, 0) * (steps - replayed)
                + PER_FP32_FORWARD.get(name, 0) * evals)
        fail_unless(n == want, f"{name}: {n} launches, want {want} ({PER_FP32_STEP.get(name, 0)}"
                               f"/eager step, {PER_FP32_FORWARD.get(name, 0)}/forward)")
    want_lib = {k: n * (steps - replayed + evals) for k, n in LIBRARY_PER_FP32_FORWARD.items()}
    fail_unless(lib == want_lib, f"library calls {lib}, want {want_lib}")
    with open(exp / "smoke_train_fp32" / "logs" / "train_log.csv") as f:
        rows = list(csv.DictReader(f))
    fail_unless(len(rows) == TRAIN_EPOCHS, f"train_log.csv has {len(rows)} rows")
    for r in rows:
        for key in ("train_loss", "val_loss", "train_dice", "val_dice"):
            fail_unless(math.isfinite(float(r[key])), f"epoch {r['epoch']}: {key} {r[key]}")
    print("[train-fp32] epochs (loss, dice): " + "; ".join(
        f"{r['epoch']}: train {float(r['train_loss']):.4f}/{float(r['train_dice']):.4f} "
        f"val {float(r['val_loss']):.4f}/{float(r['val_dice']):.4f}" for r in rows), flush=True)
    ckpt_dir = exp / "smoke_train_fp32" / "checkpoints"
    ckpts = sorted(p.name for p in ckpt_dir.iterdir())
    want_ckpts = ["best_model_smoke_train_fp32.msgpack", "best_model_smoke_train_fp32.msgpack.json"]
    fail_unless(ckpts == want_ckpts, f"checkpoints {ckpts}, want {want_ckpts}")
    dtypes = _leaf_dtypes(ckpt.load_checkpoint(str(ckpt_dir / want_ckpts[0]))["params"])
    print(f"[train-fp32] {want_ckpts[0]}: parameter dtypes {sorted(dtypes)}", flush=True)
    fail_unless(dtypes == {"float32"}, f"the fp32 run's parameters are {dtypes}")

    model = make_model(torch.float32, dropout_rate=0.1).cuda()
    state = TrainState(model, 1e-3, 1e-4)
    step = make_train_step(get_loss_fn("ce_tversky"), augment=True, nan_guard=True)
    dgen = torch.Generator(device="cuda").manual_seed(SEED)

    def batch(i):
        images = torch.rand(1, 1, size, size, size, generator=dgen, device="cuda")
        labels = torch.randint(0, 4, (1, size, size, size), generator=dgen, device="cuda",
                               dtype=torch.int32)
        return images, labels, torch.Generator().manual_seed(i)

    _time_step("train-fp32", lambda *a: step(state, *a), batch, PER_FP32_STEP, size, "fp32")
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
# in fp32 the same kernels' fp32 instances, without the upconv: 59 and 74
PER_FP32_DISTILL_STEP = _f32_counts(PER_DISTILL_STEP)
PER_FP32_DANN_STEP = _f32_counts(PER_DANN_STEP)
# the recipes' shared flags (run_finetune_ct.sh, run_distillation.sh,
# run_dann.sh), with one epoch and gradient accumulation 2, not 8, as phase 6
RECIPE = ["--batch_size", "1", "--epochs", "1", "--weight_decay", "1e-4",
          "--gradient_accumulation_steps", "2", "--mixed_precision", "bf16",
          "--early_stopping", "--patience", "10", "--seed", "42"]
# the same in fp32, the JAX CLIs' default: no --mixed_precision flag
RECIPE_FP32 = [a for a in RECIPE if a not in ("--mixed_precision", "bf16")]
# the workloads phase's device: a CPU rehearsal of the phase, at a small
# size, sets it to "cpu"
DEVICE = "cuda"
DANN_SPLITS = {"train": ("mri", 1), "dann_add_labeled": ("ct", 1), "val": ("ct", 1),
               "target": ("ct", 1), "dann_add_unlabeled": ("ct", 1)}
LAMBDA_DOMAIN = 0.2


def _run_workload(experiment: str, argv: list, steps: int, per_step: dict, evals: int,
                  log_name: str, columns: tuple, tag: str = "",
                  per_forward: dict = PER_FORWARD) -> Path:
    """One experiment through the port's orchestrator on the GPU: the exact
    launches per kernel over its steps and validation forwards, finite CSV
    rows; returns the run's directory (under ``<experiment><tag>_exp``)."""
    import csv

    import torch

    from multimodal_segmentation_project_tpu_torch import ops
    from multimodal_segmentation_project_tpu_torch.workloads import main as orchestrator

    exp = SCRATCH / f"{experiment}{tag}_exp"
    ops.reset_launch_counts()
    replayed = _replayed()
    t0 = time.perf_counter()
    orchestrator.main(["--experiment", experiment, "--experiment_dir", str(exp),
                       "--device", DEVICE, *argv])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    replayed = _replayed() - replayed
    print(f"[{experiment}{tag}] main.py --experiment {experiment}: {steps} steps ({replayed} "
          f"replayed as CUDA graphs) and {evals} validation forwards in {secs:.2f} s; launches "
          f"from the host {counts}", flush=True)
    for name, n in counts.items():
        want = per_step.get(name, 0) * (steps - replayed) + per_forward.get(name, 0) * evals
        fail_unless(n == want, f"{experiment}: {name}: {n} launches, want {want} ("
                               f"{per_step.get(name, 0)}/step, {per_forward.get(name, 0)}/forward)")
    (run,) = [p for p in exp.iterdir() if p.is_dir()]
    with open(run / "logs" / log_name) as f:
        rows = list(csv.DictReader(f))
    fail_unless(len(rows) == 1, f"{experiment}: {log_name} has {len(rows)} rows")
    for key in columns:
        fail_unless(math.isfinite(float(rows[0][key])), f"{experiment}: {key} {rows[0][key]}")
    print(f"[{experiment}] epoch 1: " + ", ".join(f"{k} {float(rows[0][k]):.4f}" for k in columns),
          flush=True)
    return run


def _time_step(label: str, step, batch, per_step: dict, size: int,
               precision: str = "bf16") -> None:
    """A step alone. Its launches counted from the host over an eager call
    (the second: a step the profiler records does not capture), and its
    kernels counted on the device over that call and over the fourth, which
    replays where the step replays as CUDA graphs (the third captures): the
    port's kernels must be the same, and the replay must launch none from
    the host. Then the median of N_STEPS_TIMED calls on distinct
    device-resident inputs (host clock around synchronize), the peak memory
    allocated and reserved over one call (a replayed step's activations lie
    in its graphs' pool, which only the reserved peak sees; the allocator's
    cache is emptied first), and a profiled breakdown of N_STEPS_PROFILED
    calls."""
    import torch

    from multimodal_segmentation_project_tpu_torch import ops

    step(*batch(0))  # warm-up: cuDNN's algorithm choice, allocator growth, the masks' plan
    ops.reset_launch_counts()
    eager = _device_kernels(step, batch(1))
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    fail_unless(counts == {k: n for k, n in per_step.items() if n},
                f"{label} step launches {counts}, want {per_step}")
    step(*batch(2))
    replayed = _replayed()
    ops.reset_launch_counts()
    kernels = _device_kernels(step, batch(50))
    replayed = _replayed() - replayed
    host = {k: n for k, n in ops.launch_counts().items() if n}
    fail_unless(host == ({} if replayed else counts),
                f"{label} step ({replayed} replays) launched {host} from the host")
    fail_unless(_of_port(kernels) == _of_port(eager),
                f"{label} step's kernels of the port on the device: {_of_port(kernels)} "
                f"({replayed} replays), {_of_port(eager)} eagerly")
    times = []
    for i in range(N_STEPS_TIMED):
        inputs = batch(100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(*inputs)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        fail_unless(math.isfinite(float(metrics["loss"])), f"timed {label} step {i}: loss")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step(*batch(200))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    reserved = torch.cuda.max_memory_reserved() / 2**30
    print(f"[{label}] step at {size}^3, batch 1, {precision}: median "
          f"{statistics.median(times):.3f} ms "
          f"over {N_STEPS_TIMED} distinct inputs (host clock around synchronize; all "
          f"{[round(t, 3) for t in times]}) | peak allocated {peak:.2f} GiB, reserved "
          f"{reserved:.2f} GiB | launches per eager step {sum(counts.values())}: {counts} | "
          f"on the device, {'a replayed' if replayed else 'an eager'} step ran "
          f"{sum(_of_port(kernels).values())} kernels of the port as the eager one did, and "
          f"{_of_library(kernels)} of the library's ({_of_library(eager)} eagerly)", flush=True)
    _profile_steps(step, [batch(300 + i) for i in range(N_STEPS_PROFILED)])


PHASE6_BEST = (SCRATCH / "train_exp" / "smoke_train" / "checkpoints"
               / "best_model_smoke_train.msgpack")


def _model_state(path: Path) -> dict:
    """The state dict of a default-width UNet3D loaded from a checkpoint."""
    import torch

    from multimodal_segmentation_project_tpu_torch.engine.checkpoint import load_params_any

    model = make_model(torch.float32)
    load_params_any(model, str(path))
    return model.state_dict()


def phase_workloads(size: int = 192) -> None:
    """Fine-tune, distillation and DANN through the port's orchestrator at
    full width, from phase 6's data and best checkpoint (the pretrained
    model and the teacher), each one epoch of two steps; then the
    distillation and DANN steps alone, and one DANN step against the CPU."""
    import torch

    from multimodal_segmentation_project_tpu_torch.engine import checkpoint as ckpt
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
    best = PHASE6_BEST
    steps, evals = TRAIN_SPLITS["train"], TRAIN_SPLITS["val"]

    run = _run_workload(
        "finetune", ["--pretrained_model", str(best), "--data_root", str(data), "--lr", "1e-4",
                     "--modalities", "ct", "--n_samples", "5", "--freeze_encoder", *RECIPE],
        steps, PER_STEP, evals, "finetune_log.csv", ("train_loss", "val_loss", "val_dice"))
    (tuned,) = (run / "checkpoints").glob("best_finetuned_model_*.msgpack")
    fail_unless(Path(f"{tuned}.json").exists(), f"no sidecar beside {tuned.name}")
    before, after = _model_state(best), _model_state(tuned)
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
    want_ckpts = [f"best_student_{run.name}.msgpack", f"best_student_{run.name}.msgpack.json"]
    fail_unless(ckpts == want_ckpts, f"distill checkpoints {ckpts}, want {want_ckpts}")

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
    (dann_best,) = (run / "checkpoints").glob("best_model_*.msgpack")
    saved = ckpt.load_checkpoint(str(dann_best))
    fail_unless({"disc_params", "disc_opt_state"} <= set(saved),
                "no discriminator in the DANN checkpoint")
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


def phase_fp32_workloads(size: int = 192) -> None:
    """Phase 8b: fine-tune, distillation and DANN through the orchestrator
    in fp32 (no --mixed_precision flag) on phase 8's data, exact launches;
    then the fp32 DANN step alone, the largest, with its peak."""
    import torch

    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import make_dann_step
    from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn

    data, dann_data, best = SCRATCH / "train_data", SCRATCH / "dann_data", PHASE6_BEST
    steps, evals = TRAIN_SPLITS["train"], TRAIN_SPLITS["val"]
    _run_workload(
        "finetune", ["--pretrained_model", str(best), "--data_root", str(data), "--lr", "1e-4",
                     "--modalities", "ct", "--n_samples", "5", "--freeze_encoder",
                     *RECIPE_FP32],
        steps, PER_FP32_STEP, evals, "finetune_log.csv", ("train_loss", "val_loss", "val_dice"),
        tag="_fp32", per_forward=PER_FP32_FORWARD)
    _run_workload(
        "distill", ["--teacher_model", str(best), "--data_root", str(data), "--lr", "1e-3",
                    "--modalities", "ct", "--alpha", "0.7", "--temperature", "2.0",
                    "--n_samples", "5", *RECIPE_FP32],
        steps, PER_FP32_DISTILL_STEP, evals, "distill_log.csv",
        ("train_loss", "val_loss", "val_dice"), tag="_fp32", per_forward=PER_FP32_FORWARD)
    n_src = DANN_SPLITS["train"][1] + DANN_SPLITS["dann_add_labeled"][1]
    n_tgt = DANN_SPLITS["target"][1] + DANN_SPLITS["dann_add_unlabeled"][1]
    _run_workload(
        "dann", ["--source_modality", "mri", "--target_modality", "ct", "--data_root",
                 str(dann_data), "--lr", "1e-3", "--lambda_domain", str(LAMBDA_DOMAIN),
                 "--loss", "ce_tversky", "--pretrained_model", str(best), *RECIPE_FP32],
        min(n_src, n_tgt), PER_FP32_DANN_STEP, DANN_SPLITS["val"][1], "train_log.csv",
        ("train_loss", "task_loss", "domain_loss", "val_loss", "val_dice"), tag="_fp32",
        per_forward=PER_FP32_FORWARD)

    dgen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def volume():
        return torch.rand(1, 1, size, size, size, generator=dgen, device=DEVICE)

    def labels():
        return torch.randint(0, 4, (1, size, size, size), generator=dgen, device=DEVICE,
                             dtype=torch.int32)

    seg = TrainState(make_model(torch.float32, dropout_rate=0.1).to(DEVICE), 1e-3, 1e-4)
    disc = TrainState(DomainDiscriminator(256, generator=torch.Generator().manual_seed(SEED))
                      .to(DEVICE), 1e-3, 1e-4)
    dann = make_dann_step(get_loss_fn("ce_tversky"), LAMBDA_DOMAIN, nan_guard=True)
    _time_step("dann-fp32", lambda *a: dann(seg, disc, *a),
               lambda i: (volume(), labels(), volume(), torch.Generator().manual_seed(i)),
               PER_FP32_DANN_STEP, size, "fp32")


# ---- phase 10: the port's public entry points ----------------------------------------

RECIPE_TIMEOUT = 600  # seconds per recipe


def _load_script(rel: str):
    """A script of the checkout (not in a package) as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the lines that mark a CLI's start of work and the end of its first epoch
# (or, for the eval CLI, of its first volume)
RECIPE_MARKS = {"start": ("[START]", "[TEST]"), "first epoch": ("[EPOCH]", "[1/")}


def _run_recipe(script: str, env: dict) -> None:
    """One ``_torch`` recipe through bash from the checkout's root, as a user
    runs it, with ``python`` this interpreter; its output goes to
    ``<SCRATCH>/<script>.log``. Prints when the CLI printed its first line
    and each of RECIPE_MARKS, so a recipe's time splits into process start,
    set-up, the first epoch and the rest. Fails on a non-zero exit; a recipe
    that outlives RECIPE_TIMEOUT is killed with its process group."""
    import threading

    shim = SCRATCH / "bin"
    shim.mkdir(exist_ok=True)
    # a script, not a symlink: a virtual environment's interpreter finds its
    # packages from the path it is started by
    (shim / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    (shim / "python").chmod(0o755)
    full_env = {**os.environ, "PATH": f"{shim}:{os.environ.get('PATH', '')}",
                "PYTHONUNBUFFERED": "1", **env}
    log = SCRATCH / f"{script}.log"
    seen: dict[str, float] = {}
    t0 = time.perf_counter()
    proc = subprocess.Popen(["bash", str(ROOT / script)], cwd=ROOT, env=full_env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)

    def copy_output() -> None:
        with open(log, "w") as out:
            for line in proc.stdout:
                now = time.perf_counter() - t0
                out.write(line)
                if line.strip():
                    seen.setdefault("first line", now)
                for mark, prefixes in RECIPE_MARKS.items():
                    if line.lstrip().startswith(prefixes):
                        seen.setdefault(mark, now)

    reader = threading.Thread(target=copy_output)
    reader.start()
    try:
        rc = proc.wait(timeout=RECIPE_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = "killed at the time limit"
    secs = time.perf_counter() - t0
    reader.join()
    marks = ", ".join(f"{k} at {v:.2f} s" for k, v in seen.items())
    print(f"[entry] bash {script} ({' '.join(f'{k}={v}' for k, v in env.items())}): exit {rc} "
          f"in {secs:.2f} s ({marks})", flush=True)
    if rc != 0:
        print(log.read_text()[-3000:], flush=True)
    fail_unless(rc == 0, f"{script} exited {rc}")


def _check_recipe_run(exp: Path, ckpt_glob: str, log_name: str) -> Path:
    """The one run directory a training recipe wrote under ``exp``: its best
    checkpoint (and JSON sidecar) and one finite CSV row; returns the
    checkpoint."""
    import csv

    (run,) = [p for p in exp.iterdir() if p.is_dir()]
    (best,) = (run / "checkpoints").glob(ckpt_glob)
    fail_unless(Path(f"{best}.json").exists(), f"no sidecar beside {best.name}")
    with open(run / "logs" / log_name) as f:
        rows = list(csv.DictReader(f))
    fail_unless(len(rows) == 1 and all(math.isfinite(float(rows[0][k]))
                                       for k in ("train_loss", "val_loss", "val_dice")),
                f"{run.name}/logs/{log_name}: {rows}")
    print(f"[entry] {exp.name}: {best.name} and its sidecar, {log_name} epoch 1 train loss "
          f"{float(rows[0]['train_loss']):.4f}, val dice {float(rows[0]['val_dice']):.4f}",
          flush=True)
    return best


def _phase_recipes(size: int) -> None:
    """(a) The five _torch recipes at full width on phases 6 and 8's 192^3
    splits, one epoch each, cut only through their own variables."""
    data, dann_data = SCRATCH / "train_data", SCRATCH / "dann_data"
    cut = {"EPOCHS": "1", "N_SAMPLES": "2"}
    exp = SCRATCH / "recipe_train_exp"
    _run_recipe("run_training_torch.sh", {"DATA_ROOT": str(data), "EXPERIMENT_DIR": str(exp),
                                          "MODALITIES": "ct", "GRAD_ACCUM": "2", **cut})
    best = _check_recipe_run(exp, "best_model_*.msgpack", "train_log.csv")
    exp = SCRATCH / "recipe_test_exp"
    _run_recipe("run_testing_torch.sh", {"MODEL_PATH": str(best), "DATA_ROOT": str(data),
                                         "EXPERIMENT_DIR": str(exp), "MODEL_NAME": "recipe"})
    _check_eval_results(exp, "recipe", TRAIN_SPLITS["test"], size)
    exp = SCRATCH / "recipe_finetune_exp"
    _run_recipe("run_finetune_ct_torch.sh", {"PRETRAINED": str(best), "DATA_ROOT": str(data),
                                             "EXPERIMENT_DIR": str(exp), **cut})
    _check_recipe_run(exp, "best_finetuned_model_*.msgpack", "finetune_log.csv")
    exp = SCRATCH / "recipe_distill_exp"
    _run_recipe("run_distillation_torch.sh", {"TEACHER": str(best), "DATA_ROOT": str(data),
                                              "EXPERIMENT_DIR": str(exp), **cut})
    _check_recipe_run(exp, "best_student_*.msgpack", "distill_log.csv")
    exp = SCRATCH / "recipe_dann_exp"
    _run_recipe("run_dann_torch.sh", {"DATA_ROOT": str(dann_data), "EXPERIMENT_DIR": str(exp),
                                      **cut})
    _check_recipe_run(exp, "best_model_*.msgpack", "train_log.csv")


def _phase_quickstart() -> None:
    """(b) The quickstart in this process, one epoch, on the card: its
    launches of every kernel against QS_PER_STEP and QS_PER_FORWARD."""
    import torch

    from multimodal_segmentation_project_tpu_torch import ops

    quickstart = _load_script("examples/quickstart_torch.py")
    workdir = SCRATCH / "quickstart"
    ops.reset_launch_counts()
    replayed = _replayed()
    t0 = time.perf_counter()
    out = quickstart.main(["--workdir", str(workdir), "--epochs", "1"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    replayed = _replayed() - replayed
    steps = QS_SPLITS["train"] // QS_BATCH
    forwards = QS_SPLITS["val"] + 1 + QS_SPLITS["test"]
    print(f"[entry] quickstart_torch.main --epochs 1 in {secs:.2f} s: {steps} train steps at "
          f"batch {QS_BATCH} ({replayed} replayed as CUDA graphs), {forwards} eval forwards; "
          f"launches from the host { {k: n for k, n in counts.items() if n} }", flush=True)
    for name, n in counts.items():
        want = (QS_PER_STEP.get(name, 0) * (steps - replayed)
                + QS_PER_FORWARD.get(name, 0) * forwards)
        fail_unless(n == want, f"quickstart: {name}: {n} launches, want {want} ("
                               f"{QS_PER_STEP.get(name, 0)}/step, "
                               f"{QS_PER_FORWARD.get(name, 0)}/forward)")
    fail_unless(Path(out["best"]).exists() and Path(f"{out['best']}.json").exists(),
                f"quickstart: no best checkpoint and sidecar at {out['best']}")
    dice = out["eval"]["mean_dice_overall"]
    fail_unless(math.isfinite(dice), f"quickstart: eval mean dice {dice}")
    print(f"[entry] quickstart: {Path(out['best']).name}, eval mean dice {dice:.4f}", flush=True)


def _phase_qa_augmentation() -> None:
    """(c) The QA script's augmentation on the card, on a 192^3 training case."""
    import torch

    qa = _load_script("scripts/plotting/visualize_augmentations_torch.py")
    split = SCRATCH / "train_data" / "train"
    vols = qa.augmented_pair(str(split), index=0, seed=0, prob=1.0, device="cuda")
    same = qa.augmented_pair(str(split), index=0, seed=0, prob=0.0, device="cuda")
    img, aug_img, lbl, aug_lbl = vols
    shape = tuple(img.shape)
    fail_unless(all(v.is_cuda and tuple(v.shape) == shape for v in vols),
                f"QA augmentation: {[(v.device.type, tuple(v.shape)) for v in vols]}")
    fail_unless(img.dtype == aug_img.dtype == torch.float32
                and lbl.dtype == aug_lbl.dtype == torch.int32,
                f"QA augmentation dtypes {[v.dtype for v in vols]}")
    labels = set(torch.unique(aug_lbl).tolist())
    fail_unless(labels <= {0, 1, 2, 3}, f"QA augmentation: labels {sorted(labels)}")
    fail_unless(bool(torch.isfinite(aug_img).all()), "QA augmentation: non-finite image")
    fail_unless(not torch.equal(img, aug_img), "QA augmentation at p = 1 left the image as it was")
    fail_unless(torch.equal(same[1], same[0]) and torch.equal(same[3], same[2]),
                "QA augmentation at p = 0 changed the volumes")
    print(f"[entry] QA augmentation on {img.device}: {shape} fp32 image and int32 labels, "
          f"labels {sorted(labels)}, |aug - orig| max {(aug_img - img).abs().max().item():.4g}; "
          f"p = 0 leaves both as they were", flush=True)


def phase_entry_points(size: int = 192) -> None:
    """Phase 10: the recipes, the quickstart and the QA script's augmentation."""
    t0 = time.perf_counter()
    _phase_recipes(size)
    t1 = time.perf_counter()
    _phase_quickstart()
    t2 = time.perf_counter()
    _phase_qa_augmentation()
    t3 = time.perf_counter()
    print(f"[entry] phase 10 in {t3 - t0:.2f} s: recipes {t1 - t0:.2f} s, quickstart "
          f"{t2 - t1:.2f} s, QA augmentation {t3 - t2:.2f} s", flush=True)


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


# fp32 train parity: one fp32 step at 64^3, full width, dropout 0,
# augmentation off, through make_train_step, from the same weights: the GPU
# (the fused block where bf16 takes it, the fp32 kernels, cuDNN with TF32
# off in the forward and the backward) against the CPU's plain fp32 step
# (which takes the fused block's plain versions). Both
# compute in fp32 and differ by the sums' order, and this network at 64^3
# amplifies that in its deep gradients (the loss barely moves): the phase
# prints that floor, the CPU step's gradients moved by one ulp of noise on
# its input, which reads a few 1e-3 at the deep levels. So the GPU is held
# to the CPU within F32_TRAIN_GRAD_TOL per gradient (the BN-fed biases,
# exact gradient 0, aside) and the loss within F32_TRAIN_LOSS_TOL scaled,
# and the backward's precision is held apart from the forward's noise: the
# same GPU step run again gives the same gradients (within the run-to-run
# floor nd of cuDNN's backward), and the control, that step with the
# backward's TF32 scope removed (TF32 allowed, as by PyTorch's default),
# must move some gradient by more than max(F32_BACKWARD_TOL, 10 nd): the
# forward is the same in both, so what moves is the backward's TF32.
F32_TRAIN_PARITY_SIZE = 64
F32_TRAIN_LOSS_TOL = 1e-5
F32_TRAIN_GRAD_TOL = 2e-2
F32_BACKWARD_TOL = 1e-5


def _fp32_step_grads(device, x, y):
    """(loss, {param name: gradient}) of one fp32 step of make_train_step
    from make_model's weights."""
    import torch

    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import make_train_step
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn

    model = make_model(torch.float32).to(device)
    state = TrainState(model, 1e-3, 1e-4)
    metrics = make_train_step(get_loss_fn("ce_tversky"))(state, x.to(device), y.to(device))
    # apply_gradients leaves in p.grad what AdamW was given: the gradient
    return float(metrics["loss"]), {n: p.grad.detach().float().cpu()
                                    for n, p in model.named_parameters()}


def _worst(rel: dict) -> tuple:
    name = max(rel, key=rel.get)
    return name, rel[name]


def phase_fp32_train_parity() -> None:
    import torch

    from multimodal_segmentation_project_tpu_torch.engine import steps

    s = F32_TRAIN_PARITY_SIZE
    x, y = _parity_case(SEED + 210, s)
    loss_w, want = _fp32_step_grads("cpu", x, y)
    ulp = torch.where(torch.rand(x.shape, generator=torch.Generator().manual_seed(SEED)) < 0.5,
                      -(2.0**-24), 2.0**-24)
    loss_n, noisy = _fp32_step_grads("cpu", x * (1 + ulp), y)
    name_n, floor_n = _worst(grad_rel(noisy, want))
    print(f"[train-parity-fp32] the CPU step with one ulp of noise on its input: loss moved by "
          f"{abs(loss_n - loss_w) / abs(loss_w):.4g} scaled, worst gradient {name_n} by "
          f"{floor_n:.4g} (the sum-order floor)", flush=True)
    loss_g, got = _fp32_step_grads("cuda", x, y)
    fail_unless(math.isfinite(loss_g), "non-finite fp32 loss on the GPU")
    loss_err = abs(loss_g - loss_w) / abs(loss_w)
    rel = grad_rel(got, want)
    levels: dict = {}
    for n in rel:
        level = n.split(".double_conv")[0] if ".double_conv" in n else n.rsplit(".", 1)[0]
        levels[level] = max(levels.get(level, 0.0), rel[n])
    print("[train-parity-fp32] largest norm-relative gradient error by level, GPU vs CPU: "
          + ", ".join(f"{k} {v:.4g}" for k, v in levels.items()), flush=True)
    worst, err = _worst(rel)
    ok = loss_err <= F32_TRAIN_LOSS_TOL and err <= F32_TRAIN_GRAD_TOL
    print(f"[train-parity-fp32] {s}^3 full width, one fp32 step, GPU fp32 kernels vs CPU fp32 "
          f"plain: loss {loss_g:.8f} vs {loss_w:.8f}, scaled error {loss_err:.4g} (<= "
          f"{F32_TRAIN_LOSS_TOL:g}) | worst gradient {worst} {err:.4g} (<= "
          f"{F32_TRAIN_GRAD_TOL:g}) {'ok' if ok else 'FAIL'}", flush=True)
    fail_unless(ok, "fp32 train parity over tolerance")

    _, again = _fp32_step_grads("cuda", x, y)
    nd = _worst(grad_rel(again, got))[1]

    @contextlib.contextmanager
    def no_scope(dtype):
        yield

    cudnn = torch.backends.cudnn
    real = steps.library_precision
    steps.library_precision = no_scope
    try:
        with cudnn.flags(enabled=True, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=True):
            _, ctrl = _fp32_step_grads("cuda", x, y)
    finally:
        steps.library_precision = real
    name_c, moved = _worst(grad_rel(ctrl, got))
    name_v, vs_cpu = _worst(grad_rel(ctrl, want))
    floor = max(F32_BACKWARD_TOL, 10 * nd)
    refused = moved > floor
    print(f"[train-parity-fp32] the GPU step run again: worst gradient moved by {nd:.4g} "
          f"(run to run) | control, the backward's TF32 scope removed (cuDNN's TF32 allowed): "
          f"worst gradient {name_c} moved by {moved:.4g} against the scoped step (must exceed "
          f"{floor:.4g}): {'refused' if refused else 'ACCEPTED'}; against the CPU {name_v} "
          f"{vs_cpu:.4g}", flush=True)
    fail_unless(refused, "the fp32 backward with TF32 reads as the scoped one")
    fail_unless(not cudnn.allow_tf32, "cuDNN's TF32 left on after the control")


# ---- phase 9: checkpoints and preprocessing ------------------------------------------

# a real abdominal CT scan's grid: 512 x 512 in-plane at 0.78 mm, 160 slices
# at 2.5 mm (int16 HU), and its labels (uint8)
RESAMPLE_SHAPE = (512, 512, 160)
RESAMPLE_SPACING = (0.78, 0.78, 2.5)
RESAMPLE_TOL = 1e-5  # card vs CPU, of max |x|


def _leaves_equal(got, want, path="") -> list:
    """Paths where two checkpoint trees differ in keys, dtype, shape or bits."""
    import numpy as np

    if isinstance(want, dict):
        if not isinstance(got, dict) or list(got) != list(want):
            return [path or "/"]
        return [p for k in want for p in _leaves_equal(got[k], want[k], f"{path}/{k}")]
    same = (type(got) is type(want) and got.dtype == want.dtype and got.shape == want.shape
            and got.tobytes() == want.tobytes())
    return [] if same else [path]


def _phase6_trainer(resume: str):
    """A Trainer of phase 6's recipe (run_training.sh's flags, accumulation 2)
    on its data, resumed from ``resume``."""
    from multimodal_segmentation_project_tpu_torch.data import CombinedDataset
    from multimodal_segmentation_project_tpu_torch.engine.trainer import Trainer

    data = SCRATCH / "train_data"
    return Trainer(_train_cfg("ckpt_source", 1, resume),
                   CombinedDataset(str(data / "train")), CombinedDataset(str(data / "val")))


def _train_cfg(name: str, epochs: int, resume=None, dann: bool = False):
    """train_unet's (or train_dann's) TrainerConfig for phase 6's recipe."""
    from multimodal_segmentation_project_tpu_torch.engine.trainer import TrainerConfig

    return TrainerConfig(
        experiment_dir=str(SCRATCH / "resume_exp"), experiment_name=name, epochs=epochs,
        batch_size=1, lr=1e-3, weight_decay=1e-4, grad_accum=2, loss="ce_tversky",
        dropout_rate=0.1, seed=42, augment=not dann, use_scheduler=not dann,
        early_stopping=True, patience=10, precision="bf16", resume=resume, device="cuda")


def _format_check() -> tuple:
    """Phase 6's trained state in the JAX layout, written and read back;
    returns its path and that of the same weights as a ``.pth`` train
    checkpoint, which the trainer writes for that suffix."""
    import numpy as np

    from multimodal_segmentation_project_tpu_torch.engine import checkpoint as ckpt
    from multimodal_segmentation_project_tpu_torch.engine import msgpack_codec

    trainer = _phase6_trainer(str(PHASE6_BEST))
    fail_unless(trainer.state.grad_accum_steps == 2, "phase 6 accumulates over 2 steps")
    extra = {"epoch": np.asarray(trainer.start_epoch, np.int32),
             "best_val_dice": np.asarray(trainer.best_val_dice, np.float32)}
    path = SCRATCH / "best_model_smoke_train.msgpack"
    t0 = time.perf_counter()
    tree = ckpt.state_checkpoint_tree(trainer.state, extra)
    ckpt.save_checkpoint(str(path), tree, metadata=trainer._metadata(
        trainer.start_epoch - 1, {}, {}))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt.load_checkpoint(str(path))
    t_read = time.perf_counter() - t0
    payload = path.read_bytes()
    t0 = time.perf_counter()
    msgpack_codec.unpackb(payload)
    t_decode = time.perf_counter() - t0
    diff = _leaves_equal(back, tree)
    fail_unless(set(tree["opt_state"]) == {"mini_step", "gradient_step", "inner_opt_state",
                                           "acc_grads", "skip_state"},
                f"opt_state is not optax.MultiSteps': {list(tree['opt_state'])}")
    n_leaves = sum(1 for _ in _iter_leaves(tree))
    print(f"[format] {path.name}: {len(payload) / 2**20:.2f} MiB, {n_leaves} leaves (params, "
          f"batch_stats, AdamW mu/nu/count, MultiSteps acc_grads/mini_step, mask, step, lr); "
          f"write (tree + encode + file) {t_write:.3f} s, read (file + decode) {t_read:.3f} s, "
          f"decode alone {t_decode:.3f} s | leaves not bit-equal after the round trip: "
          f"{diff or 'none'}", flush=True)
    fail_unless(not diff, f"the .msgpack round trip changed {diff}")
    fail_unless(msgpack_codec.packb(back) == payload, "re-encoding the read tree changed bytes")
    pth = SCRATCH / "best_model_smoke_train.pth"
    trainer.save_checkpoint(str(pth), trainer.start_epoch - 1, {}, {})
    return path, pth


def _iter_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_leaves(v)
    else:
        yield tree


def _serve_checks(msgpack_path: Path, pth: Path, size: int) -> None:
    """The eval CLI on the .msgpack against the .pth of the same weights, and
    the distillation teacher and the fine-tune's pretrained model from it."""
    import csv

    import numpy as np

    from multimodal_segmentation_project_tpu_torch.data import load_nifti

    data = SCRATCH / "train_data"
    _run_eval_cli(str(msgpack_path), data, SCRATCH / "msgpack_eval_exp", "smoke_msgpack",
                  TRAIN_SPLITS["test"], size)
    _run_eval_cli(str(pth), data, SCRATCH / "pth_eval_exp", "smoke_pth", TRAIN_SPLITS["test"],
                  size)
    (pth_dir,) = (SCRATCH / "pth_eval_exp").glob("test_results_smoke_pth_*")
    (mp_dir,) = (SCRATCH / "msgpack_eval_exp").glob("test_results_smoke_msgpack_*")
    rows = []
    for d in (pth_dir, mp_dir):
        with open(d / "metrics" / "per_sample_metrics.csv") as f:
            rows.append([{k: v for k, v in r.items() if k.startswith(("dice_", "iou_"))}
                         for r in csv.DictReader(f)])
    preds = [sorted((d / "predictions").glob("*_pred.nii.gz")) for d in (pth_dir, mp_dir)]
    same_preds = [p.name for p in preds[0]] == [p.name for p in preds[1]] and all(
        np.array_equal(load_nifti(str(a)).data, load_nifti(str(b)).data)
        for a, b in zip(*preds))
    print(f"[serve] eval CLI on {msgpack_path.name} vs on the .pth of the same weights: "
          f"predictions {'bit-equal' if same_preds else 'DIFFERENT'}, per-sample Dice and IoU "
          f"{'equal' if rows[0] == rows[1] else 'DIFFERENT'} (test cases: {len(rows[1])})",
          flush=True)
    fail_unless(same_preds and rows[0] == rows[1], ".msgpack eval differs from .pth eval")
    steps, evals = TRAIN_SPLITS["train"], TRAIN_SPLITS["val"]
    _run_workload(
        "distill", ["--teacher_model", str(msgpack_path), "--data_root", str(data), "--lr",
                    "1e-3", "--modalities", "ct", "--alpha", "0.7", "--temperature", "2.0",
                    "--n_samples", "5", *RECIPE],
        steps, PER_DISTILL_STEP, evals, "distill_log.csv", ("train_loss", "val_loss"),
        tag="_msgpack")
    _run_workload(
        "finetune", ["--pretrained_model", str(msgpack_path), "--data_root", str(data), "--lr",
                     "1e-4", "--modalities", "ct", "--n_samples", "5", "--freeze_encoder",
                     *RECIPE],
        steps, PER_STEP, evals, "finetune_log.csv", ("train_loss", "val_loss"), tag="_msgpack")


def _recorded(trainer, attr: str, losses: list) -> None:
    """Record every step's loss of ``trainer`` (its step function ``attr``)."""
    step = getattr(trainer, attr)

    def wrapped(*args):
        metrics = step(*args)
        losses.append(float(metrics["loss"]))
        return metrics

    setattr(trainer, attr, wrapped)


def _resume_continuity(label: str, make, attr: str, per_step: dict, steps_per_epoch: int,
                       evals_per_epoch: int) -> None:
    """Run A: epoch 1, saved as .msgpack, resumed by a fresh trainer for
    epoch 2; run B: both epochs uninterrupted. Epoch 2's step losses and the
    final weights must be the same bits; each run's launches exact."""
    import torch

    from multimodal_segmentation_project_tpu_torch import ops

    def run(trainer, epochs_run):
        losses: list = []
        _recorded(trainer, attr, losses)
        ops.reset_launch_counts()
        replayed = _replayed()
        trainer.run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        replayed = _replayed() - replayed
        for name, n in counts.items():
            want = (per_step.get(name, 0) * (steps_per_epoch * epochs_run - replayed)
                    + PER_FORWARD.get(name, 0) * evals_per_epoch * epochs_run)
            fail_unless(n == want, f"{label}: {name}: {n} launches, want {want}")
        return losses

    t0 = time.perf_counter()
    first = make(f"{label}_a1", 1, None)
    run(first, 1)
    path = SCRATCH / f"{label}_epoch1.msgpack"
    first.save_checkpoint(str(path), 0, {}, {})
    del first
    resumed = make(f"{label}_a2", 2, str(path))
    fail_unless(resumed.start_epoch == 1, f"{label}: resumed at epoch {resumed.start_epoch}")
    losses_a = run(resumed, 1)
    whole = make(f"{label}_b", 2, None)
    losses_b = run(whole, 2)[steps_per_epoch:]
    weights = [{k: v for k, v in t.state.model.state_dict().items()
                if "num_batches" not in k} for t in (resumed, whole)]
    if label == "dann":
        for t, w in zip((resumed, whole), weights):
            w.update({f"disc.{k}": v for k, v in t.disc_state.model.state_dict().items()})
    differ = [k for k in weights[1] if not torch.equal(weights[0][k], weights[1][k])]
    same_losses = losses_a == losses_b
    print(f"[resume] {label}: epoch-2 step losses resumed {losses_a} vs uninterrupted "
          f"{losses_b}: {'bit-equal' if same_losses else 'DIFFERENT'}; final weights "
          f"{'bit-equal' if not differ else f'DIFFERENT in {differ[:4]}'} "
          f"({len(weights[1])} tensors) | three runs in {time.perf_counter() - t0:.2f} s",
          flush=True)
    fail_unless(same_losses and not differ, f"{label}: the resumed run is not the uninterrupted")


def _resume_checks() -> None:
    import torch

    from multimodal_segmentation_project_tpu_torch.data import CombinedDataset, ConcatDataset
    from multimodal_segmentation_project_tpu_torch.engine.trainer import DannTrainer, Trainer

    train = SCRATCH / "train_data"

    def make_train(name, epochs, resume):
        return Trainer(_train_cfg(name, epochs, resume), CombinedDataset(str(train / "train")),
                       CombinedDataset(str(train / "val")))

    dann = SCRATCH / "dann_data"

    def make_dann(name, epochs, resume):
        source = ConcatDataset([CombinedDataset(str(dann / "train")),
                                CombinedDataset(str(dann / "dann_add_labeled"))])
        target = ConcatDataset([CombinedDataset(str(dann / "target")),
                                CombinedDataset(str(dann / "dann_add_unlabeled"))])
        return DannTrainer(_train_cfg(name, epochs, resume, dann=True), source, target,
                           CombinedDataset(str(dann / "val")), lambda_domain=LAMBDA_DOMAIN)

    # the port's own kernels sum in a fixed order; cuDNN (the deep region's
    # convs) may pick a non-deterministic algorithm unless asked not to
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        _resume_continuity("train", make_train, "train_step", PER_STEP,
                           TRAIN_SPLITS["train"], TRAIN_SPLITS["val"])
        n_src = DANN_SPLITS["train"][1] + DANN_SPLITS["dann_add_labeled"][1]
        n_tgt = DANN_SPLITS["target"][1] + DANN_SPLITS["dann_add_unlabeled"][1]
        _resume_continuity("dann", make_dann, "dann_step", PER_DANN_STEP, min(n_src, n_tgt),
                           DANN_SPLITS["val"][1])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


def _resample_case(root: Path):
    """One synthetic CT case on a real scan's grid: ellipsoid organs in HU
    over noise, int16, and its uint8 labels, as uncompressed NIfTI in an LPS
    orientation (the reorientation runs too)."""
    import numpy as np

    from multimodal_segmentation_project_tpu_torch.data import save_nifti

    rng = np.random.default_rng(SEED + 900)
    grids = [(np.arange(n, dtype=np.float32) + 0.5) / n for n in RESAMPLE_SHAPE]
    x, y, z = grids[0][:, None, None], grids[1][None, :, None], grids[2][None, None, :]
    lbl = np.zeros(RESAMPLE_SHAPE, np.uint8)
    for label, (cx, cy, cz), (rx, ry, rz) in ((2, (0.35, 0.45, 0.5), (0.2, 0.18, 0.3)),
                                                (1, (0.7, 0.5, 0.45), (0.08, 0.09, 0.15)),
                                                (3, (0.4, 0.7, 0.55), (0.06, 0.06, 0.12)),
                                                (3, (0.65, 0.7, 0.55), (0.06, 0.06, 0.12))):
        lbl[((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2 + ((z - cz) / rz) ** 2 <= 1.0] = label
    levels = np.array(INTENSITIES["ct"][0], np.float32)
    img = (levels[lbl] + rng.normal(0.0, 20.0, RESAMPLE_SHAPE).astype(np.float32)).astype(np.int16)
    affine = np.diag([-RESAMPLE_SPACING[0], -RESAMPLE_SPACING[1], RESAMPLE_SPACING[2], 1.0])
    for sub, vol in (("images", img), ("labels", lbl)):
        (root / sub).mkdir(parents=True, exist_ok=True)
        save_nifti(vol, str(root / sub / "scan00.nii"), affine=affine)
    return root / "images" / "scan00.nii", root / "labels" / "scan00.nii"


def _resample_checks(model_path: Path) -> None:
    """workloads.resample --backend torch on the GPU, the eval CLI on its
    result, and the card's output against the CPU's."""
    import numpy as np
    import torch

    from multimodal_segmentation_project_tpu_torch.data import load_nifti
    from multimodal_segmentation_project_tpu_torch.data import resample as rs
    from multimodal_segmentation_project_tpu_torch.workloads import resample as resample_cli

    src = SCRATCH / "resample_src"
    img_path, lbl_path = _resample_case(src)
    out = SCRATCH / "resample_data" / "test" / "synth_ct"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = resample_cli.main(["--input_dir", str(src / "images"), "--output_dir",
                           str(out / "images"), "--labels_dir", str(src / "labels"),
                           "--labels_out_dir", str(out / "labels"), "--backend", "torch"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    peak_cli = torch.cuda.max_memory_allocated() / 2**20
    fail_unless(n == 1, f"the resample CLI processed {n} cases")

    img, lbl = load_nifti(str(img_path)), load_nifti(str(lbl_path))
    times = []
    for _ in range(3):  # the first call includes cuBLAS's warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu_img, _ = rs.resample_volume(img, backend="torch", device="cuda")
        gpu_lbl, _ = rs.resample_volume(lbl, is_label=True, backend="torch", device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    cpu_img, _ = rs.resample_volume(img, backend="torch", device="cpu")
    cpu_lbl, _ = rs.resample_volume(lbl, is_label=True, backend="torch", device="cpu")
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(gpu_img - cpu_img).max() / np.abs(cpu_img).max())
    lbl_equal = bool(np.array_equal(gpu_lbl, cpu_lbl))
    written = load_nifti(str(out / "images" / "scan00.nii"))
    fail_unless(written.data.shape == rs.TARGET_SHAPE and np.isfinite(written.data).all(),
                f"resampled image {written.data.shape}")
    fail_unless(np.array_equal(written.data, gpu_img.astype(np.float32)),
                "the CLI's image is not the function's")
    print(f"[resample] {RESAMPLE_SHAPE} int16 at {RESAMPLE_SPACING} mm -> 1 mm "
          f"{tuple(int(round(s * f)) for s, f in zip(RESAMPLE_SHAPE, RESAMPLE_SPACING))} -> "
          f"{rs.TARGET_SHAPE}: CLI (NIfTI read + image and label resample + write) {cli_s:.3f} "
          f"s per case, peak allocated {peak_cli:.1f} MiB; resample_volume image + label on "
          f"the card {[round(t, 4) for t in times]} s (host clock around synchronize), on the "
          f"CPU {cpu_s:.2f} s | card vs CPU image error {err:.3g} of max |x| (<= "
          f"{RESAMPLE_TOL}), labels {'equal' if lbl_equal else 'DIFFERENT'}", flush=True)
    fail_unless(err <= RESAMPLE_TOL and lbl_equal, "the card's resample differs from the CPU's")
    _run_eval_cli(str(model_path), SCRATCH / "resample_data", SCRATCH / "resample_eval_exp",
                  "smoke_resampled", 1, rs.TARGET_SHAPE[0])


def time_scipy_resample() -> None:
    """The resampling case once with the scipy backend (host) and with the
    torch backend (card), each on the image and the labels."""
    import torch

    from multimodal_segmentation_project_tpu_torch.data import load_nifti
    from multimodal_segmentation_project_tpu_torch.data import resample as rs

    img_path, lbl_path = _resample_case(SCRATCH / "resample_src")
    img, lbl = load_nifti(str(img_path)), load_nifti(str(lbl_path))
    for backend in ("torch", "torch", "scipy"):  # the first torch call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs.resample_volume(img, backend=backend, device="cuda")
        rs.resample_volume(lbl, is_label=True, backend=backend, device="cuda")
        torch.cuda.synchronize()
        print(f"[resample-time] {backend}: image + label {time.perf_counter() - t0:.3f} s "
              f"(host clock)", flush=True)


def time_accum_step(root: Path, size: int = 192) -> None:
    """The train step with gradient accumulation over 2 steps (the train
    CLI's accumulating path through ``TrainState.apply_gradients``) at full
    width: the median of N_STEPS_TIMED distinct inputs (half of them apply
    AdamW), then the profile of four steps (launches and summed kernel time
    per step). The port is imported from ``root``, so that another checkout
    of it (a parent commit) is timed by the same code in the same call."""
    sys.path.insert(0, str(root))
    import torch

    import multimodal_segmentation_project_tpu_torch as pkg
    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import make_train_step
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn

    fail_unless(Path(pkg.__file__).resolve().is_relative_to(root),
                f"port package imported from {pkg.__file__}, not from {root}")
    print(f"[accum-step] port from {Path(pkg.__file__).parent}", flush=True)
    state = TrainState(make_model(torch.bfloat16, dropout_rate=0.1).cuda(), 1e-3, 1e-4,
                       grad_accum_steps=2)
    step = make_train_step(get_loss_fn("ce_tversky"), augment=True, nan_guard=True)
    dgen = torch.Generator(device="cuda").manual_seed(SEED)

    def batch(i):
        images = torch.rand(1, 1, size, size, size, generator=dgen, device="cuda")
        labels = torch.randint(0, 4, (1, size, size, size), generator=dgen, device="cuda",
                               dtype=torch.int32)
        return images, labels, torch.Generator().manual_seed(i)

    for i in range(4):  # warm-up: two updates, cuDNN's algorithm choice, allocator growth
        step(state, *batch(i))
    times = []
    for i in range(N_STEPS_TIMED):
        args = batch(100 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, *args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        fail_unless(math.isfinite(float(metrics["loss"])), f"timed step {i}: non-finite loss")
    fail_unless(state.mini_step == 0, f"mini_step {state.mini_step} after whole updates")
    print(f"[accum-step] step at {size}^3, batch 1, bf16, accumulation 2: median "
          f"{statistics.median(times):.3f} ms over {N_STEPS_TIMED} distinct inputs (host clock "
          f"around synchronize; all {[round(t, 3) for t in times]})", flush=True)
    _profile_steps(lambda *args: step(state, *args), [batch(300 + i) for i in range(4)])


def time_bodies(root: Path, tag: str, names: tuple, step_names: tuple) -> None:
    """One body's instances (``names``) as called and bare, per shape and
    summed over one pass (7-fp32 the fp32 eval forward, 6- and 12-fp32 the
    fp32 train step's conv1 shapes, the others the whole step), each checked
    against its plain version under its phase-3 tolerance, beside its bound
    and the FFMA bound; then ``step_names`` summed per fp32 train step, and
    the SASS digest of conv3_dw_f32.cu's kernels in the library. The port is
    imported from ``root``, so that another checkout (a parent commit) is
    timed by the same code in the same call."""
    sys.path.insert(0, str(root))
    import torch

    import multimodal_segmentation_project_tpu_torch as pkg
    from multimodal_segmentation_project_tpu_torch.ops import _build

    fail_unless(Path(pkg.__file__).resolve().is_relative_to(root),
                f"port package imported from {pkg.__file__}, not from {root}")
    print(f"[{tag}] port from {Path(pkg.__file__).parent}", flush=True)
    plan, _ = _kernel_plan()
    bare = bare_calls()
    sums = {}
    for name in names:
        kern, plain, _, make, shapes, tol, work, _ = plan[name]
        tot = dict.fromkeys(("ms", "bare_ms", "bound_ms", "ffma_ms"), 0.0)
        for shape, mult in _count(shapes):
            inputs = make(*shape)
            err, rel, ok, ratio = _errors(f"{name} {shape}", kern, plain, inputs, tol)
            fail_unless(ok, f"{name} {shape}: error {err} (scaled {rel}) over tolerance")
            ms, bare_ms = _time_ms(kern, inputs), _time_bare_ms(name, bare[name], inputs)
            bytes_ms, ops_ms, ffma_ms = _bounds_ms(name, work, shape)
            bound_ms, ffma_ms = max(bytes_ms, ops_ms), max(bytes_ms, ffma_ms)
            for key, val in (("ms", ms), ("bare_ms", bare_ms), ("bound_ms", bound_ms),
                             ("ffma_ms", ffma_ms)):
                tot[key] += mult * val
            print(f"[{tag}] {name} {shape} x{mult}: scaled err {rel:.4g}"
                  f"{'' if ratio is None else f', sums at {ratio:.4g} of their bound'}, as called "
                  f"{ms:.4f} ms, bare {bare_ms:.4f} ms; bound {bound_ms:.4f} ms, FFMA bound "
                  f"{ffma_ms:.4f} ms", flush=True)
            del inputs
            torch.cuda.empty_cache()
        sums[name] = tot
        print(f"[{tag}] {name} per pass: as called {tot['ms']:.4f} ms, bare "
              f"{tot['bare_ms']:.4f} ms; bound {tot['bound_ms']:.4f} ms, FFMA bound "
              f"{tot['ffma_ms']:.4f} ms", flush=True)
    step = {k: sum(sums[n][k] for n in step_names) for k in sums[step_names[0]]}
    print(f"[{tag}] per fp32 train step ({', '.join(step_names)}): as called "
          f"{step['ms']:.4f} ms, bare {step['bare_ms']:.4f} ms; bound {step['bound_ms']:.4f} "
          f"ms, FFMA bound {step['ffma_ms']:.4f} ms", flush=True)
    n, lines, sha = dw_f32_sass_digest(_build.library_path())
    print(f"[{tag}] SASS of conv3_dw_f32.cu in {_build.library_path().name}: {n} kernels, "
          f"{lines} lines, sha256 {sha}", flush=True)


def phase_checkpoints(size: int = 192) -> None:
    """Phase 9: the JAX package's .msgpack checkpoints and the resampling
    stage, at 192^3 and full width, bf16."""
    t0 = time.perf_counter()
    path, pth = _format_check()
    _serve_checks(path, pth, size)
    _resume_checks()
    _resample_checks(path)
    print(f"[phase9] checkpoints and preprocessing in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---- phase 11: the multi-device path ----------------------------------------------------

MESH_SIZE = 192
# (n_data, n_spatial) and the global batch: the shipped recipe (batch 1) on
# two cards, where the trainer raises the spatial axis, and data parallel
MESH_CASES = (((1, 2), 1), ((2, 1), 2))
MESH_WORKER_TIMEOUT = 900   # seconds for a world of phase 11
MESH_EVAL_LOGIT_TOL = 1e-4  # fp32 eval on the mesh vs unsharded, of max |logit|
MESH_EVAL_ARGMAX_F32 = 0.999
MESH_TIMED = 2              # steps timed after the counted one
# launches per rank: a train step on the per-conv chain (every conv on 1,
# its dx but the image conv's, its dW, or F.conv3d in the deep region;
# pools on 8 and 9; the bf16 upconvs on 10; the head on 11, 11-dx and
# 11-dw; none of 3-6 or 12), in fp32 the same on the fp32 instances; the
# distillation step adds the teacher's eval forward; the DANN step adds the
# target's forward and its backward through the encoder and the bottleneck
MESH_STEP = {"conv3x3x3_cf": 11, "conv3x3x3_cf_dx": 10, "conv3x3x3_cf_dw": 11,
             "max_pool2x_cf": 4, "max_pool2x_cf_bwd": 4, "upconv2x_cf": 3, "head1x1_cf": 1,
             "head1x1_cf_dx": 1, "head1x1_cf_dw": 1}
MESH_STEP_F32 = _f32_counts(MESH_STEP)
MESH_DISTILL_F32 = _add_counts(MESH_STEP_F32, PER_FP32_FORWARD)
MESH_DANN_F32 = _add_counts(MESH_STEP_F32, _f32_counts({
    "conv3x3x3_cf": 11, "max_pool2x_cf": 4, "head1x1_cf": 1, "conv3x3x3_cf_dx": 5,
    "conv3x3x3_cf_dw": 6, "max_pool2x_cf_bwd": 4}))
MESH_FORWARD = {"bf16": PER_FORWARD, "fp32": PER_FP32_FORWARD}
MESH_STEPS = {"bf16": MESH_STEP, "fp32": MESH_STEP_F32}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _per_conv_chain():
    """One process's model on the per-conv chain in every block, the chain
    the JAX package runs under a mesh (the fused block is single-device)."""
    from multimodal_segmentation_project_tpu_torch.models.unet3d import DoubleConv

    real = DoubleConv.fused
    DoubleConv.fused = lambda self: False
    try:
        yield
    finally:
        DoubleConv.fused = real


@contextlib.contextmanager
def _zeroed_halos():
    """Control: every halo plane received as zeros."""
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import halo

    real = halo._swap_planes
    halo._swap_planes = lambda mesh, to_prev, to_next: (torch.zeros_like(to_prev),
                                                        torch.zeros_like(to_next))
    try:
        yield
    finally:
        halo._swap_planes = real


def _on_rank(mesh, *tensors):
    """This rank's slices (the whole tensors without a mesh), on the card."""
    from multimodal_segmentation_project_tpu_torch.parallel.mesh import shard_batch_arrays

    if mesh is not None:
        tensors = shard_batch_arrays(mesh, *tensors)
        tensors = tensors if isinstance(tensors, tuple) else (tensors,)
    return [t.cuda() for t in tensors]


def _grads(*models) -> dict:
    return {f"{i}.{n}" if i else n: p.grad.detach().float().cpu()
            for i, m in enumerate(models) for n, p in m.named_parameters()}


def _run_counted(mesh, fn):
    """fn() under the mesh: (its result, the launches it made, the halo bytes
    this rank sent)."""
    import torch

    from multimodal_segmentation_project_tpu_torch import ops
    from multimodal_segmentation_project_tpu_torch.ops.halo import exchange_halo_d
    from multimodal_segmentation_project_tpu_torch.parallel.mesh import use_spatial_mesh

    with use_spatial_mesh(mesh):
        ops.reset_launch_counts()
        exchange_halo_d.bytes_sent = 0
        out = fn()
        torch.cuda.synchronize()
        return out, ops.launch_counts(), exchange_halo_d.bytes_sent


def _mesh_train(dtype, mesh, x, y, timed: int = 0):
    """One make_train_step of phase 6's loss on this rank's slice of (x, y)
    from make_model's weights: (loss, gradients, launches, halo bytes, ms of
    ``timed`` more steps)."""
    import torch

    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import make_train_step
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn
    from multimodal_segmentation_project_tpu_torch.parallel.mesh import use_spatial_mesh

    model = make_model(dtype).cuda()
    state = TrainState(model, 1e-3, 1e-4)
    step = make_train_step(get_loss_fn("ce_tversky"), nan_guard=True)
    xs, ys = _on_rank(mesh, x, y)
    metrics, counts, sent = _run_counted(mesh, lambda: step(state, xs, ys))
    fail_unless(float(metrics["nonfinite"]) == 0.0, "non-finite gradients on the mesh")
    loss, grads = float(metrics["loss"]), _grads(model)
    times = []
    with use_spatial_mesh(mesh):
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, xs, ys)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    del model, state
    torch.cuda.empty_cache()
    return loss, grads, counts, sent, times


def _mesh_eval(dtype, mesh, x):
    """The eval forward on this rank's slab against the unsharded forward's
    slab: (max error over max |logit|, argmax agreement, launches)."""
    import torch

    from multimodal_segmentation_project_tpu_torch.parallel.mesh import shard_batch_arrays

    model = make_model(dtype).cuda()
    with torch.no_grad():
        want = model(x.cuda())
        (xs,) = _on_rank(mesh, x)
        got, counts, _ = _run_counted(mesh, lambda: model(xs))
        want = shard_batch_arrays(mesh, want)
        err = float((got - want).abs().max() / want.abs().max())
        agree = float((got.argmax(1) == want.argmax(1)).float().mean())
    del model, want, got
    torch.cuda.empty_cache()
    return err, agree, counts


def _mesh_dann(mesh, x, y, tgt):
    """One fp32 DANN step (phase 8's lambda, the discriminator's dropout on)
    on this rank's slices: (losses, gradients of both models, launches)."""
    import torch

    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import make_dann_step
    from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn

    model = make_model(torch.float32).cuda()
    disc = DomainDiscriminator(256, generator=torch.Generator().manual_seed(SEED)).cuda()
    seg_state, disc_state = TrainState(model, 1e-3, 1e-4), TrainState(disc, 1e-3, 1e-4)
    step = make_dann_step(get_loss_fn("ce_tversky"), LAMBDA_DOMAIN, nan_guard=True)
    src, lbl, tgt = _on_rank(mesh, x, y, tgt)
    metrics, counts, _ = _run_counted(mesh, lambda: step(
        seg_state, disc_state, src, lbl, tgt, torch.Generator().manual_seed(SEED)))
    out = {k: float(metrics[k]) for k in ("task_loss", "domain_loss", "loss")}, _grads(model, disc)
    del model, disc, seg_state, disc_state
    torch.cuda.empty_cache()
    return (*out, counts)


def _mesh_distill(mesh, x, y):
    """One fp32 distillation step (phase 8's alpha and T; the teacher from
    another seed) on this rank's slices: (loss, gradients, launches)."""
    import torch

    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import make_distill_step
    from multimodal_segmentation_project_tpu_torch.ops.losses import distillation_loss

    model = make_model(torch.float32).cuda()
    teacher = make_model(torch.float32, seed=SEED + 1).cuda().requires_grad_(False)
    state = TrainState(model, 1e-3, 1e-4)
    step = make_distill_step(
        lambda s, t, lb: distillation_loss(s, t, lb, alpha=0.7, temperature=2.0), nan_guard=True)
    xs, ys = _on_rank(mesh, x, y)
    metrics, counts, _ = _run_counted(mesh, lambda: step(state, teacher, xs, ys))
    out = float(metrics["loss"]), _grads(model)
    del model, teacher, state
    torch.cuda.empty_cache()
    return (*out, counts)


def _held(loss, grads, ref_loss, ref_grads, loss_tol, bounds) -> dict:
    """The loss and every gradient but the BN-fed biases' against the one
    process's, under ``loss_tol`` scaled and ``bounds`` (name -> bound)."""
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    rel = grad_rel(grads, ref_grads)
    worst = max(rel, key=lambda n: rel[n] / bounds[n])
    over = sorted(n for n in rel if rel[n] > bounds[n])
    return {"loss": loss, "ref_loss": ref_loss, "loss_err": loss_err, "loss_tol": loss_tol,
            "worst": worst, "worst_rel": rel[worst], "worst_bound": bounds[worst],
            "over": over, "ok": loss_err <= loss_tol and not over}


def _digest(grads: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for name in sorted(grads):
        h.update(grads[name].numpy().tobytes())
    return h.hexdigest()


def mesh_worker(rank: int, world: int, port: int, backend: str, out_dir: Path) -> None:
    """One rank of phase 11 (or of ``--multi-gpu``): every case's step on its
    mesh, the eval forwards, the fp32 distillation and DANN steps at the
    first case's mesh; rank 0 also runs each one in one process on the
    per-conv chain and holds the mesh's results against it. Writes
    ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from multimodal_segmentation_project_tpu_torch.parallel.mesh import (
        GLOO_CUDA_COLLECTIVES,
        Mesh,
        init_distributed,
    )

    init_distributed(backend=backend, device="cuda", init_method=f"tcp://127.0.0.1:{port}",
                     rank=rank, world_size=world)
    torch.backends.cudnn.allow_tf32 = False  # as phase_device: fp32 plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        inp = torch.load(out_dir / "inputs.pt")
        x, y, tgt = inp["images"], inp["labels"], inp["target"]
        res = {"rank": rank, "backend": backend, "device": torch.cuda.current_device(),
               "train": {}, "launches": {}, "halo_bytes": {}, "step_ms": {}, "eval": {},
               "digests": {}}
        if backend == "gloo":  # the collectives the port hands gloo on CUDA tensors
            t = torch.full((4,), rank + 1.0, device="cuda")
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t)
            dist.all_reduce(t)
            dist.broadcast(t, 0)
            fail_unless(set(GLOO_CUDA_COLLECTIVES) == {"all_reduce", "broadcast", "all_gather"}
                        and bool((t == world * (world + 1) / 2).all())
                        and all(bool((p == i + 1).all()) for i, p in enumerate(parts)),
                        "gloo's collectives of CUDA tensors are wrong")
            res["gloo_cuda_direct"] = sorted(GLOO_CUDA_COLLECTIVES)
        f32, bf16 = torch.float32, torch.bfloat16
        cases = [(tuple(m), b) for m, b in inp["cases"]]
        refs: dict = {}
        for dname, dtype in (("fp32", f32), ("bf16", bf16)):
            for (nd, ns), batch in cases:
                tag = f"{dname} {nd}x{ns}"
                mesh = Mesh(nd, ns)
                xb, yb = x[:batch], y[:batch]
                loss, grads, counts, sent, ms = _mesh_train(dtype, mesh, xb, yb, MESH_TIMED)
                res["launches"][f"train {tag}"] = counts
                res["halo_bytes"][tag], res["step_ms"][tag] = sent, ms
                res["digests"][tag] = _digest(grads)
                zero = None
                if dname == "fp32" and ns > 1:  # control: the halos zeroed
                    with _zeroed_halos():
                        zero = _mesh_train(dtype, mesh, xb, yb)[:2]
                dist.barrier()
                if rank == 0:
                    with _per_conv_chain():
                        ref_loss, ref, _, _, ref_ms = _mesh_train(dtype, None, xb, yb,
                                                                  MESH_TIMED)
                        ulp = torch.where(torch.rand(xb.shape, generator=torch.Generator()
                                                     .manual_seed(SEED)) < 0.5, -2.0**-24, 2.0**-24)
                        noise_loss, noisy = _mesh_train(dtype, None, xb * (1 + ulp), yb)[:2]
                    floor = grad_rel(noisy, ref)
                    if dname == "fp32":
                        refs[(nd, ns)] = ref
                        bounds = dict.fromkeys(floor, F32_TRAIN_GRAD_TOL)
                        loss_tol = F32_TRAIN_LOSS_TOL
                    else:  # phase 7's: e is the one-process bf16 step's error against fp32
                        e = grad_rel(ref, refs[(nd, ns)])
                        bounds = {n: min(v + TRAIN_GRAD_FLOOR, TRAIN_GRAD_EMU_CAP)
                                  for n, v in e.items()}
                        loss_tol = TRAIN_LOSS_TOL
                    out = _held(loss, grads, ref_loss, ref, loss_tol, bounds)
                    floor_name = max(floor, key=floor.get)
                    out.update(noise_loss=abs(noise_loss - ref_loss) / abs(ref_loss),
                               floor_name=floor_name, floor=floor[floor_name], ref_ms=ref_ms)
                    undivided = {n: g * mesh.size for n, g in grads.items()}
                    out["undivided_refused"] = not _held(loss, undivided, ref_loss, ref,
                                                         loss_tol, bounds)["ok"]
                    if zero is not None:
                        held = _held(*zero, ref_loss, ref, loss_tol, bounds)
                        out["zero_halo"] = {k: held[k] for k in ("loss_err", "worst", "worst_rel",
                                                                 "worst_bound", "ok")}
                    res["train"][tag] = out
                dist.barrier()
            mesh = Mesh(1, world)  # the eval forward on the volume's D split
            err, agree, counts = _mesh_eval(dtype, mesh, x[:1])
            res["eval"][dname] = {"err": err, "agree": agree}
            res["launches"][f"eval {dname} 1x{world}"] = counts
        (nd, ns), _ = cases[0]
        mesh = Mesh(nd, ns)
        losses, grads, counts = _mesh_dann(mesh, x[:1], y[:1], tgt[:1])
        res["launches"][f"dann fp32 {nd}x{ns}"] = counts
        res["digests"]["dann"] = _digest(grads)
        kd_loss, kd_grads, counts = _mesh_distill(mesh, x[:1], y[:1])
        res["launches"][f"distill fp32 {nd}x{ns}"] = counts
        res["digests"]["distill"] = _digest(kd_grads)
        dist.barrier()
        if rank == 0:
            with _per_conv_chain():
                ref_losses, ref = _mesh_dann(None, x[:1], y[:1], tgt[:1])[:2]
                ref_kd, ref_kd_grads = _mesh_distill(None, x[:1], y[:1])[:2]
            bounds = dict.fromkeys(grad_rel(ref, ref), F32_TRAIN_GRAD_TOL)
            res["dann"] = _held(losses["loss"], grads, ref_losses["loss"], ref,
                                F32_TRAIN_LOSS_TOL, bounds)
            res["dann"]["loss_errs"] = {k: abs(losses[k] - ref_losses[k]) / abs(ref_losses[k])
                                        for k in losses}
            res["distill"] = _held(kd_loss, kd_grads, ref_kd, ref_kd_grads, F32_TRAIN_LOSS_TOL,
                                   dict.fromkeys(grad_rel(ref_kd_grads, ref_kd_grads),
                                                 F32_TRAIN_GRAD_TOL))
        dist.barrier()
        (out_dir / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def gloo_p2p_probe(rank: int, port: int) -> None:
    """One of two processes: a gloo point-to-point exchange of CUDA tensors,
    which ops/halo.py stages through host memory; prints whether gloo ran
    it. Exits without the group's teardown (a refused send breaks the
    pair's connection)."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    t = torch.full((1024,), rank + 1.0, device="cuda")
    got = torch.empty_like(t)
    try:
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, 1 - rank),
                                            dist.P2POp(dist.irecv, got, 1 - rank)]):
            work.wait()
        torch.cuda.synchronize()
        print(f"GLOO_P2P_CUDA ran, right: {bool((got == 2 - rank).all())}", flush=True)
    except RuntimeError as e:
        print(f"GLOO_P2P_CUDA refused: {str(e).splitlines()[0][:160]}", flush=True)
    os._exit(0)


def _check_gloo_p2p() -> None:
    """Whether gloo's point-to-point takes CUDA tensors, in a pair of
    processes of its own: it must not, or the halo's staging is needless."""
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--gloo-p2p-probe",
                               str(r), port], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    lines = []
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=120)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0] + "\nGLOO_P2P_CUDA refused: no answer in 120 s"
        lines += [f"rank {r}: {ln}" for ln in out.splitlines() if "GLOO_P2P_CUDA" in ln]
    refused = any("refused" in ln for ln in lines)
    print(f"[multi] gloo point-to-point of CUDA tensors, in a pair of its own: {lines}", flush=True)
    fail_unless(refused, "gloo ran point-to-point on CUDA tensors: the halo's staging is needless")


def _mesh_world(backend: str, world: int, cases, size: int) -> list:
    """Starts ``world`` worker processes of this script over ``backend`` (each
    a rank; under gloo all on card 0), waits for them, prints their output
    and returns their results."""
    import torch

    out_dir = SCRATCH / f"mesh_{backend}_{world}"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    n = max(batch for _, batch in cases)
    vols = [_parity_case(SEED + 400 + i, size) for i in range(max(n, 2))]
    images, labels = (torch.cat(v) for v in zip(*vols))
    torch.save({"images": images, "labels": labels, "target": images.roll(1, 0),
                "cases": [[list(m), b] for m, b in cases]}, out_dir / "inputs.pt")
    del vols, images, labels
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
                               str(r), str(world), port, backend, str(out_dir)], cwd=ROOT,
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        deadline = time.perf_counter() + MESH_WORKER_TIMEOUT
        for p in procs:
            p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        text = (out_dir / f"rank{r}.log").read_text()
        lines = [ln for ln in text.splitlines() if ln.strip()]
        for ln in lines[-40:] if p.returncode else [ln for ln in lines if ln.startswith("[")]:
            print(f"[multi] rank {r}: {ln}", flush=True)
        fail_unless(p.returncode == 0, f"{backend} rank {r} of {world} exited {p.returncode}")
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(world)]


def _report_mesh_world(results: list, backend: str) -> None:
    """Prints phase 11's (b)-(e) from the ranks' results and fails on any
    check."""
    world = len(results)
    main = results[0]
    where = (f"{world} processes on one card over gloo (their times are not multi-GPU "
             f"performance)" if backend == "gloo" else f"{world} cards over NCCL")
    print(f"[multi] {where}; cards {[r['device'] for r in results]}", flush=True)
    if backend == "gloo":
        print(f"[multi] gloo takes CUDA tensors directly in {main['gloo_cuda_direct']} (each "
              f"checked on the card); its point-to-point does not, so the halo's planes are "
              f"staged through host memory", flush=True)
    for tag, out in main["train"].items():
        dname = tag.split()[0]
        ms = [round(t, 3) for r in results for t in r["step_ms"][tag]]
        print(f"[multi] train {tag} at {MESH_SIZE}^3, full width, per-conv chain vs one process: "
              f"loss {out['loss']:.8f} vs {out['ref_loss']:.8f}, scaled error "
              f"{out['loss_err']:.4g} (<= {out['loss_tol']:g}) | worst gradient {out['worst']} "
              f"{out['worst_rel']:.4g} (<= {out['worst_bound']:.4g}); over a bound: "
              f"{out['over'] or 'none'} | noise floor (one process, one ulp on its input): loss "
              f"{out['noise_loss']:.4g}, worst gradient {out['floor_name']} {out['floor']:.4g} | "
              f"halo bytes sent per step per rank {[r['halo_bytes'][tag] for r in results]} | "
              f"step ms (host clock) {ms}; one process, the global batch on one card: "
              f"{[round(t, 3) for t in out['ref_ms']]} {'ok' if out['ok'] else 'FAIL'}",
              flush=True)
        fail_unless(out["ok"], f"the {tag} mesh step is over its bounds")
        print(f"[multi] control, {tag}: the gradient all-reduce without its division: "
              f"{'refused' if out['undivided_refused'] else 'ACCEPTED'}", flush=True)
        fail_unless(out["undivided_refused"], f"{tag}: an undivided all-reduce is accepted")
        if "zero_halo" in out:
            z = out["zero_halo"]
            print(f"[multi] control, {tag}: every halo zeroed: loss error {z['loss_err']:.4g}, "
                  f"worst gradient {z['worst']} {z['worst_rel']:.4g} (bound "
                  f"{z['worst_bound']:.4g}): {'ACCEPTED' if z['ok'] else 'refused'}", flush=True)
            fail_unless(not z["ok"], f"{tag}: zeroed halos are accepted")
        digests = {r["digests"][tag] for r in results}
        fail_unless(len(digests) == 1, f"{tag}: the ranks' gradients differ")
        del dname
    for dname, tol in (("fp32", MESH_EVAL_ARGMAX_F32), ("bf16", PARITY_ARGMAX_MIN)):
        err = max(r["eval"][dname]["err"] for r in results)
        agree = min(r["eval"][dname]["agree"] for r in results)
        ok = agree >= tol and (dname == "bf16" or err <= MESH_EVAL_LOGIT_TOL)
        print(f"[multi] eval {dname} at 1x{world}, {MESH_SIZE}^3 vs the unsharded forward: max "
              f"error {err:.4g} of max |logit|"
              + (f" (<= {MESH_EVAL_LOGIT_TOL:g})" if dname == "fp32" else "")
              + f", argmax agreement {agree:.6f} (>= {tol}) {'ok' if ok else 'FAIL'}", flush=True)
        fail_unless(ok, f"the {dname} eval forward on the mesh is over its bounds")
    for name, key in (("DANN", "dann"), ("distillation", "distill")):
        out = main[key]
        extra = ("" if key != "dann" else " (task, domain, total: "
                 + ", ".join(f"{v:.4g}" for v in out["loss_errs"].values()) + ")")
        print(f"[multi] {name} fp32 at {list(main['train'])[0].split()[1]} vs one process: loss "
              f"scaled error {out['loss_err']:.4g}{extra} (<= {out['loss_tol']:g}) | worst "
              f"gradient {out['worst']} {out['worst_rel']:.4g} (<= {out['worst_bound']:g}) "
              f"{'ok' if out['ok'] else 'FAIL'}", flush=True)
        fail_unless(out["ok"] and all(e <= F32_TRAIN_LOSS_TOL
                                      for e in out.get("loss_errs", {}).values()),
                    f"the {name} step on the mesh is over its bounds")
        fail_unless(len({r["digests"][key] for r in results}) == 1,
                    f"{name}: the ranks' gradients differ")
    for r in results:
        for label, counts in r["launches"].items():
            kind, dname = label.split()[:2]
            want = {"train": MESH_STEPS.get(dname), "eval": MESH_FORWARD.get(dname),
                    "dann": MESH_DANN_F32, "distill": MESH_DISTILL_F32}[kind]
            bad = {k: n for k, n in counts.items() if n != want.get(k, 0)}
            fail_unless(not bad, f"rank {r['rank']}, {label}: launches {bad}, want {want}")
    print(f"[multi] launches per rank exact on every rank: train step "
          f"{sum(MESH_STEP.values())} (bf16) / {sum(MESH_STEP_F32.values())} (fp32), eval "
          f"forward {sum(PER_FORWARD.values())} / {sum(PER_FP32_FORWARD.values())}, DANN "
          f"{sum(MESH_DANN_F32.values())}, distillation {sum(MESH_DISTILL_F32.values())}; none of "
          f"3-6 or 12", flush=True)


def _world_one(size: int) -> None:
    """(a): the train CLI under torchrun with one rank (NCCL) writes phase 6's
    files; in this process, a world-1 step gives the bits of the step with
    no process group (cuDNN deterministic)."""
    import torch
    import torch.distributed as dist

    from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
    from multimodal_segmentation_project_tpu_torch.engine.steps import make_train_step
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn
    from multimodal_segmentation_project_tpu_torch.parallel.mesh import Mesh, use_spatial_mesh

    data, exp = SCRATCH / "train_data", SCRATCH / "mesh_world1_exp"
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
         "-m", "multimodal_segmentation_project_tpu_torch.workloads.train_unet",
         "--data_root", str(data), "--experiment_dir", str(exp), "--batch_size", "1",
         "--epochs", "1", "--lr", "1e-3", "--weight_decay", "1e-4",
         "--gradient_accumulation_steps", "2", "--mixed_precision", "bf16", "--loss",
         "ce_tversky", "--early_stopping", "--patience", "10", "--seed", "42"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    fail_unless(proc.returncode == 0, f"the train CLI under torchrun exited {proc.returncode}:\n"
                                      + "\n".join(out.splitlines()[-30:]))
    fail_unless("[DIST] 1 rank(s) over nccl" in out, "torchrun's rank did not initialise NCCL")

    def files(run: Path) -> list:
        return sorted(str(p.relative_to(run)).replace(run.name, "<name>")
                      for p in run.rglob("*") if p.is_file())

    (run,) = exp.iterdir()
    got, want = files(run), files(SCRATCH / "train_exp" / "smoke_train")
    print(f"[multi] (a) the train CLI under torchrun --standalone --nproc_per_node 1 (NCCL, one "
          f"rank): exit 0 in {secs:.2f} s, files {got}", flush=True)
    fail_unless(got == want, f"torchrun's run wrote {got}, phase 6 wrote {want}")

    x, y = (t.cuda() for t in _parity_case(SEED + 450, size))

    def step():
        model = make_model(torch.bfloat16).cuda()
        state = TrainState(model, 1e-3, 1e-4)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
            metrics = make_train_step(get_loss_fn("ce_tversky"), nan_guard=True)(state, x, y)
        return metrics["loss"].cpu(), _grads(model)

    want_loss, want_grads = step()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        with use_spatial_mesh(Mesh(1, 1)):
            got_loss, got_grads = step()
    finally:
        dist.destroy_process_group()
    same = torch.equal(got_loss, want_loss) and all(
        torch.equal(got_grads[n], g) for n, g in want_grads.items())
    print(f"[multi] (a) a world-1 step (NCCL, one rank, its 1x1 mesh) against the step with no "
          f"process group, {size}^3 bf16, cuDNN deterministic: "
          f"{'the same bits' if same else 'DIFFERENT bits'}", flush=True)
    fail_unless(same, "a world of one does not give the single-device bits")


def phase_multi(size: int = MESH_SIZE) -> None:
    """Phase 11 on one card: (a) a world of one; (b)-(e) two processes on the
    card over gloo (the caller names it: NCCL refuses two ranks on one
    device)."""
    import torch

    t0 = time.perf_counter()
    _world_one(size)
    torch.cuda.empty_cache()
    _check_gloo_p2p()
    _report_mesh_world(_mesh_world("gloo", 2, MESH_CASES, size), "gloo")
    print(f"[multi] phase 11 in {time.perf_counter() - t0:.1f} s", flush=True)


def multi_gpu(size: int = MESH_SIZE) -> None:
    """``--multi-gpu``: (b)-(e) across the machine's N cards over NCCL, at
    1 x N, N x 1 and, for an even N >= 4, (N/2) x 2."""
    import torch

    n = torch.cuda.device_count()
    fail_unless(n > 1, f"--multi-gpu needs more than one card, found {n}")
    cases = [((1, n), 1), ((n, 1), n)] + ([((n // 2, 2), n // 2)] if n >= 4 and n % 2 == 0
                                           else [])
    t0 = time.perf_counter()
    _report_mesh_world(_mesh_world("nccl", n, cases, size), "nccl")
    print(f"[multi] --multi-gpu in {time.perf_counter() - t0:.1f} s", flush=True)


# ---- window attention (SwinUNETR's W-MSA, ops/window_attn.py) ----------------

# (volume side, channels, heads) of SwinUNETR's four stages at 192^3, batch 1
WINDOW_ATTN_STAGES = ((96, 48, 3), (48, 96, 6), (24, 192, 12), (12, 384, 24))
# further shapes: a clipped window, batch 2, a ragged volume padded on every axis
WINDOW_ATTN_EXTRA = (((1, 4, 4, 4), 48, 3), ((2, 12, 12, 12), 96, 6), ((1, 9, 12, 16), 48, 3))
WINDOW_ATTN_GRAD_REL = 1.5e-2  # norm-relative: the kernels round P and dS to bf16 for the products


def _window_attn_case(shape, c, heads, shift, seed):
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import window_attn as wa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(*shape, 3 * c, generator=gen, device="cuda").to(torch.bfloat16)
    bias = 0.5 * torch.randn(3 * c, generator=gen, device="cuda")
    table = 0.5 * torch.randn((2 * wa.MAX_WINDOW - 1) ** 3, heads, generator=gen, device="cuda")
    index = wa.relative_position_index().cuda()
    dout = torch.randn(*shape, c, generator=gen, device="cuda").to(torch.bfloat16)
    return qkv, bias, table, index, dout


def _window_attn_check(shape, c, heads, shift, seed) -> dict:
    """The kernels against the plain version on one case: the output within
    two bf16 ulps plus 2^-8 max |v| (the kernel rounds P to bf16 before P v),
    the gradients of qkv, the bias and the table norm-relative within
    WINDOW_ATTN_GRAD_REL."""
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import window_attn as wa

    qkv, bias, table, index, dout = _window_attn_case(shape, c, heads, shift, seed)
    win, sft = wa.window_and_shift(shape[1:4], wa.MAX_WINDOW, shift)
    leaves = [t.detach().clone().requires_grad_(True) for t in (qkv, bias, table)]
    got = wa.window_attention(leaves[0], leaves[1], leaves[2], index, heads, wa.MAX_WINDOW, shift)
    g_got = torch.autograd.grad(got, leaves, dout)
    got = got.detach()
    plain = [t.detach().clone().requires_grad_(True) for t in (qkv, bias, table)]
    want = wa.window_attention_reference(plain[0], plain[1], plain[2], index, heads, win, sft)
    g_want = torch.autograd.grad(want, plain, dout)
    torch.cuda.synchronize()
    vmax = qkv[..., 2 * c:].float().abs().max()
    allowed = 2 * _bf16_ulp(torch.maximum(got.float().abs(), want.float().abs())) + vmax / 256
    err = (got.float() - want.float()).abs()
    # a gradient the plain version gives as 0 (the bias where no token is
    # padded) is held absolutely: 0 / max(0, tiny)
    rel = [float((a.float() - b.float()).norm() / max(float(b.float().norm()), 1e-30))
           for a, b in zip(g_got, g_want)]
    ok = bool((err <= allowed).all()) and all(math.isfinite(r) and r <= WINDOW_ATTN_GRAD_REL
                                              for r in rel)
    print(f"[window_attn] {tuple(shape)} C={c} heads={heads} shift={shift}: out max err "
          f"{float(err.max()):.4g} (worst share of allowance {float((err / allowed).max()):.3f}); "
          f"grad rel qkv {rel[0]:.3g} bias {rel[1]:.3g} (norm {float(g_want[1].norm()):.4g}, "
          f"kernel's {float(g_got[1].norm()):.4g}) table {rel[2]:.3g} (limit "
          f"{WINDOW_ATTN_GRAD_REL}) {'ok' if ok else 'FAIL'}", flush=True)
    fail_unless(ok, f"window_attn {tuple(shape)} shift {shift} misses its bound")
    return {"out_err": float(err.max()), "grad_rel": rel}


def _window_attn_bound_ms(shape, c) -> tuple:
    """(forward, backward) least ms: the larger of the FLOPs at 989 TFLOP/s
    and the bytes at 3.35 TB/s. Queries over the real tokens, keys and
    values over the whole 343-token window: forward 4 N 343 C FLOPs,
    backward 10 N 343 C; bytes q, k, v and o (forward), and q, k, v, o, dO,
    dq, dk, dv (backward), bf16, on the real tokens."""
    n_tok = math.prod(shape[:4])
    win = min(7, min(shape[1:4])) ** 3
    fwd = max(4 * n_tok * win * c / 989e12, 4 * n_tok * c * 2 / 3.35e12) * 1e3
    bwd = max(10 * n_tok * win * c / 989e12, 8 * n_tok * c * 2 / 3.35e12) * 1e3
    return fwd, bwd


def _time_window_attn(shape, c, heads, shift, seed) -> None:
    """Kernel forward and forward + backward, the plain version's, and SDPA
    on the same windows with the bias and mask as a float mask (the
    library's yardstick; the port never calls it), CUDA events, median of
    five; beside the bound."""
    import torch
    import torch.nn.functional as F

    from multimodal_segmentation_project_tpu_torch.ops import window_attn as wa

    cases = [_window_attn_case(shape, c, heads, shift, seed + i) for i in range(5)]
    win, sft = wa.window_and_shift(shape[1:4], wa.MAX_WINDOW, shift)

    def kern(qkv, bias, table, index, dout):
        return wa.window_attention(qkv, bias, table, index, heads, wa.MAX_WINDOW, shift)

    def kern_bwd(qkv, bias, table, index, dout):
        leaves = [t.detach().requires_grad_(True) for t in (qkv, bias, table)]
        out = wa.window_attention(leaves[0], leaves[1], leaves[2], index, heads, wa.MAX_WINDOW,
                                  shift)
        torch.autograd.grad(out, leaves, dout)

    def plain(qkv, bias, table, index, dout):
        return wa.window_attention_reference(qkv, bias, table, index, heads, win, sft)

    qkv0, bias0, table0, index0, _ = cases[0]
    pad = wa.padded(shape[1:4], win)
    full = bias0.to(qkv0.dtype).expand(shape[0], *pad, 3 * c).clone()
    full[:, :shape[1], :shape[2], :shape[3]] = qkv0
    windows = wa._partition(full, win)
    n = windows.shape[1]
    q, k, v = windows.view(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    mask = wa.dense_bias(table0, index0, n)[None].to(torch.bfloat16).expand(q.shape[0], -1, -1, -1)

    def sdpa(*_):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    ms = {name: _time_ms(fn, cases) for name, fn in (("kernel", kern), ("kernel fwd+bwd", kern_bwd),
                                                      ("plain", plain), ("sdpa", sdpa))}
    fwd_b, bwd_b = _window_attn_bound_ms(shape, c)
    print(f"[window_attn] time {tuple(shape)} C={c} shift={shift}: kernel {ms['kernel']:.3f} ms "
          f"(bound {fwd_b:.3f}, {100 * fwd_b / ms['kernel']:.1f} %), fwd+bwd "
          f"{ms['kernel fwd+bwd']:.3f} ms (bound {fwd_b + bwd_b:.3f}, "
          f"{100 * (fwd_b + bwd_b) / ms['kernel fwd+bwd']:.1f} %), plain {ms['plain']:.3f} ms, "
          f"sdpa (bias only, no mask) {ms['sdpa']:.3f} ms", flush=True)


def _swin_step(counters, size: int = 192) -> tuple:
    """SwinUNETR's bf16 train step at ``size``^3 on the one-card step's CUDA
    graph: six steps (two eager, the capture, three more replays), then one
    replayed step under the profiler. (Each of ``counters``' launches from
    the host over the six steps, the names of the profiled step's device
    ops.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodal_segmentation_project_tpu_torch.engine import steps
    from multimodal_segmentation_project_tpu_torch.engine.state import create_train_state
    from multimodal_segmentation_project_tpu_torch.models.swin_unetr import SwinUNETR
    from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = SwinUNETR(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED)).cuda()
    state = create_train_state(model, 1e-3, 1e-4, 8)
    step = steps.make_train_step(get_loss_fn("ce_tversky"), augment=True, nan_guard=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand((1, 1, size, size, size), generator=gen, device="cuda")
    y = torch.randint(0, 4, (1, size, size, size), generator=gen, device="cuda")
    times = []
    for c in counters:
        c.launches = 0
    replayed = steps._Replay.replayed
    for i in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(state, x, y, torch.Generator().manual_seed(i))
        float(m["loss"])
        times.append(time.perf_counter() - t)
    replayed = steps._Replay.replayed - replayed
    launches = [c.launches for c in counters]
    fail_unless(replayed == 4, f"{replayed} of the six SwinUNETR steps replayed, not 4")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        float(step(state, x, y, torch.Generator().manual_seed(99))["loss"])
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "cuda" in str(getattr(e, "device_type", "")).lower()]
    print(f"[swin step] SwinUNETR {size}^3 bf16 step: seconds {[round(t, 4) for t in times]}; "
          f"{len(names)} device ops a replayed step; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB", flush=True)
    del model, state, step
    torch.cuda.empty_cache()
    return launches, names


def _window_attn_step(size: int = 192) -> None:
    """The forward kernel's launches from the host over six SwinUNETR steps
    (the two eager steps and the capture run the forward from the host, 8
    blocks each; the replays launch none) and the window-attention kernels
    a replayed step runs, counted on the device (8 blocks: 8 forwards and
    16 backward launches)."""
    from multimodal_segmentation_project_tpu_torch.ops.window_attn import window_attention

    (launches,), names = _swin_step([window_attention], size)
    n_attn = sum(name.startswith("window_attn") for name in names)
    print(f"[window_attn] a replayed step runs {n_attn} window_attn kernels; forward launches "
          f"from the host over the six steps {launches} (two eager steps and the capture, 8 "
          f"blocks each)", flush=True)
    fail_unless(n_attn == 24, f"a replayed step ran {n_attn} window_attn kernels, not 24")
    fail_unless(launches == 8 * 3, f"the host launched the forward kernel {launches} times over "
                                   f"two eager steps and the capture, not 24")


def phase_window_attn() -> None:
    """12. window attention: the kernels against the plain version at the
    four stages' 192^3 shapes, shifted and unshifted, and at a clipped
    window, batch 2 and a ragged volume; timed beside their bound, the
    plain version and SDPA; then SwinUNETR's replayed train step."""
    t0 = time.perf_counter()
    for i, (side, c, heads) in enumerate(WINDOW_ATTN_STAGES):
        for shift in (0, 3):
            _window_attn_check((1, side, side, side), c, heads, shift, 100 + 10 * i + shift)
    for i, (shape, c, heads) in enumerate(WINDOW_ATTN_EXTRA):
        for shift in (0, 3):
            _window_attn_check(shape, c, heads, shift, 200 + 10 * i + shift)
    for side, c, heads in WINDOW_ATTN_STAGES:
        _time_window_attn((1, side, side, side), c, heads, 3, 300)
    _window_attn_step()
    print(f"[window_attn] phase in {time.perf_counter() - t0:.1f} s", flush=True)


# ---- InstanceNorm with the residual block's tail (ops/instance_norm.py) --------

# (volume side, channels, tail, norms of that tail in a 192^3 SwinUNETR step):
# each residual block runs act(IN(conv1)) and act(IN(conv2) + r), and r is
# IN(conv1x1) (no tail) where the block widens, but for encoder1's closed form
IN_SLOPE = 0.01
IN_TAILS = {"none": (False, None), "act": (False, IN_SLOPE), "res+act": (True, IN_SLOPE)}
IN_SHAPES = (
    (192, 48, "act", 2), (192, 48, "res+act", 2), (192, 48, "none", 1),  # encoder1, decoder1
    (96, 48, "act", 2), (96, 48, "res+act", 2), (96, 48, "none", 1),  # encoder2, decoder2
    (48, 96, "act", 2), (48, 96, "res+act", 2), (48, 96, "none", 1),  # encoder3, decoder3
    (24, 192, "act", 2), (24, 192, "res+act", 2), (24, 192, "none", 1),  # encoder4, decoder4
    (12, 384, "act", 1), (12, 384, "res+act", 1), (12, 384, "none", 1),  # decoder5
    (6, 768, "act", 1), (6, 768, "res+act", 1),  # encoder10
)
IN_KERNELS_A_NORM = 6  # three forward kernels, three backward


def _in_case(side, c, tail, seed):
    import torch

    shape = (1, c, side, side, side)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (3 + 2 * torch.randn(shape, generator=gen, device="cuda")).to(torch.bfloat16)
    res = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
           if IN_TAILS[tail][0] else None)
    dy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    return x, res, dy


def _in_kernel(x, res, dy, slope, backward=True):
    import torch

    from multimodal_segmentation_project_tpu_torch.ops.instance_norm import instance_norm_act

    if not backward:
        return (instance_norm_act(x, res, slope),)
    leaves = [t.detach().requires_grad_(True) for t in (x, res) if t is not None]
    y = instance_norm_act(leaves[0], leaves[1] if res is not None else None, slope)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy))


def _in_plain(x, res, dy, slope, out=None):
    """The plain version's output, and with ``out`` (whose sign gates the
    backward) dx and dresidual."""
    from multimodal_segmentation_project_tpu_torch.ops import instance_norm as inorm

    stats = inorm.plain_stats(x)
    y = inorm.plain_forward(x, res, slope, stats)
    if out is None:
        return (y,)
    dx, g = inorm.plain_backward(x, out, dy, stats, slope)
    return (y, dx, *(() if res is None else (g.to(dy.dtype),)))


def _in_library(x, res, dy, slope, backward=True):
    """What the port ran before the kernels: group_norm, the add, LeakyReLU."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_(backward) for t in (x, res) if t is not None]
    y = torch.group_norm(leaves[0], x.shape[1], None, None, 1e-5, True)
    if res is not None:
        y = y + leaves[1]
    if slope is not None:
        y = F.leaky_relu(y, slope)
    return torch.autograd.grad(y, leaves, dy) if backward else (y,)


def _in_check(side, c, tail, seed) -> None:
    """The kernels against the plain version: the output, dx and dresidual
    within two bf16 ulps plus 1e-5 of the largest magnitude (both take
    their sums in fp32 and round once; the plain backward gates on the
    kernel's output)."""
    import torch

    x, res, dy = _in_case(side, c, tail, seed)
    slope = IN_TAILS[tail][1]
    got = _in_kernel(x, res, dy, slope)
    want = _in_plain(x, res, dy, slope, got[0])
    torch.cuda.synchronize()
    worst = []
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        allowed = 2 * _bf16_ulp(torch.maximum(a.abs(), b.abs())) + 1e-5 * b.abs().max()
        worst.append(float(((a - b).abs() / allowed).max()))
    ok = len(got) == len(want) and all(w <= 1 for w in worst)
    print(f"[instance_norm] {side}^3 x {c} {tail}: worst share of allowance (out, dx, dres) "
          f"{[round(w, 3) for w in worst]} {'ok' if ok else 'FAIL'}", flush=True)
    fail_unless(ok, f"instance_norm {side}^3 x {c} {tail} misses its bound")


def _in_bytes(side, c, tail) -> tuple:
    """(forward, backward) bytes, each input read once and each output written
    once, bf16: forward x (and r) in, out; backward x, dy (and out for the
    gate) in, dx (and dr) out."""
    has_res, slope = IN_TAILS[tail]
    vol = 2 * c * side ** 3
    return vol * (2 + has_res), vol * (3 + (slope is not None) + has_res)


def _in_device_ms(cases, slope) -> tuple:
    """(forward, backward) device ms a call of the instance_norm kernels,
    from the profiler over one fwd+bwd call of each case."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x, res, dy in cases:
            _in_kernel(x, res, dy, slope)
        torch.cuda.synchronize()
    fwd = bwd = 0.0
    for e in prof.events():
        if "cuda" in str(getattr(e, "device_type", "")).lower() and "instance_norm" in e.name:
            ms = (e.time_range.end - e.time_range.start) * 1e-3
            if "bwd" in e.name:
                bwd += ms
            else:
                fwd += ms
    return fwd / len(cases), bwd / len(cases)


def _time_in(side, c, tail, seed) -> dict:
    """As called (CUDA events, median of five distinct inputs): the kernels'
    forward and forward + backward, the plain version's, the library's;
    the kernels' device time; the bound."""
    cases = [_in_case(side, c, tail, seed + i) for i in range(N_TIMED)]
    slope = IN_TAILS[tail][1]
    ms = {
        "fwd": _time_ms(lambda x, r, dy: _in_kernel(x, r, dy, slope, False), cases),
        "fwd+bwd": _time_ms(lambda x, r, dy: _in_kernel(x, r, dy, slope), cases),
        "plain fwd": _time_ms(lambda x, r, dy: _in_plain(x, r, dy, slope), cases),
        "plain fwd+bwd": _time_ms(lambda x, r, dy: _in_plain(
            x, r, dy, slope, _in_plain(x, r, dy, slope)[0]), cases),
        "library fwd": _time_ms(lambda x, r, dy: _in_library(x, r, dy, slope, False), cases),
        "library fwd+bwd": _time_ms(lambda x, r, dy: _in_library(x, r, dy, slope), cases),
    }
    ms["device fwd"], ms["device bwd"] = _in_device_ms(cases, slope)
    fwd_b, bwd_b = (b / HBM_BYTES_PER_S * 1e3 for b in _in_bytes(side, c, tail))
    ms["bound fwd"], ms["bound fwd+bwd"] = fwd_b, fwd_b + bwd_b
    dev = ms["device fwd"] + ms["device bwd"]
    print(f"[instance_norm] time {side}^3 x {c} {tail}: fwd {ms['fwd']:.3f} ms, fwd+bwd "
          f"{ms['fwd+bwd']:.3f} ms as called; device {ms['device fwd']:.3f} + "
          f"{ms['device bwd']:.3f} ms (bound {fwd_b:.3f} + {bwd_b:.3f}, "
          f"{100 * (fwd_b + bwd_b) / dev:.1f} %); plain {ms['plain fwd']:.3f}, "
          f"{ms['plain fwd+bwd']:.3f}; library (group_norm) {ms['library fwd']:.3f}, "
          f"{ms['library fwd+bwd']:.3f}", flush=True)
    return ms


def phase_instance_norm() -> None:
    """13. InstanceNorm with the residual block's tail: the kernels against
    the plain version at every shape and tail of a 192^3 SwinUNETR step;
    each timed beside its bound, the plain version and the library's
    composition, summed over the step; then the replayed step's kernels."""
    from multimodal_segmentation_project_tpu_torch.ops.instance_norm import instance_norm_act

    t0 = time.perf_counter()
    for i, (side, c, tail, _) in enumerate(IN_SHAPES):
        _in_check(side, c, tail, 500 + i)
    total = {}
    for i, (side, c, tail, n) in enumerate(IN_SHAPES):
        for k, v in _time_in(side, c, tail, 600 + 10 * i).items():
            total[k] = total.get(k, 0.0) + n * v
    norms = sum(n for *_, n in IN_SHAPES)
    print(f"[instance_norm] a 192^3 step's {norms} norms, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in total.items()), flush=True)
    (launches,), names = _swin_step([instance_norm_act])
    n_in = sum("instance_norm" in name for name in names)
    print(f"[instance_norm] a replayed step runs {n_in} instance_norm kernels; launches from "
          f"the host over the six steps {launches} (the two eager steps; a capture counts "
          f"none)", flush=True)
    a_step = IN_KERNELS_A_NORM * norms
    fail_unless(n_in == a_step, f"a replayed step ran {n_in} instance_norm kernels, not {a_step}")
    fail_unless(launches == 2 * a_step, f"the host launched {launches} instance_norm kernels over "
                                        f"two eager steps, not {2 * a_step}")
    print(f"[instance_norm] phase in {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    t_start = time.perf_counter()
    if sys.argv[1:2] == ["--mesh-rank"]:  # one rank of phase 11, started by _mesh_world
        rank, world, port, backend, out_dir = sys.argv[2:7]
        mesh_worker(int(rank), int(world), int(port), backend, Path(out_dir))
        return 0
    if sys.argv[1:2] == ["--gloo-p2p-probe"]:  # started by _check_gloo_p2p
        gloo_p2p_probe(int(sys.argv[2]), int(sys.argv[3]))
    if "--multi-gpu" in sys.argv[1:]:
        try:
            phase_device()
            phase_build()
            SCRATCH.mkdir(parents=True, exist_ok=True)
            multi_gpu()
        except Exception as e:
            import traceback

            traceback.print_exc()
            print(f"[FAIL] {type(e).__name__}: {e}", flush=True)
            return 1
        return 0
    timers = {  # flag [ROOT]: the port imported from ROOT (default: this checkout)
        "--time-accum-step": time_accum_step,
        "--time-dw-f32": lambda root: time_bodies(root, "dw-f32", F32_TRAIN_DW, F32_TRAIN_DW),
        "--time-conv-f32": lambda root: time_bodies(root, "conv-f32", F32_CONV_BODY,
                                                    F32_TRAIN_BODY)}
    for flag, timer in timers.items():
        if flag in sys.argv[1:]:
            rest = sys.argv[sys.argv.index(flag) + 1:]
            try:
                phase_device()
                timer(Path(rest[0]).resolve() if rest else ROOT)
            except Exception as e:
                print(f"[FAIL] {type(e).__name__}: {e}", flush=True)
                return 1
            return 0
    for flag, phase in (("--window-attn", phase_window_attn),
                        ("--instance-norm", phase_instance_norm)):
        if flag not in sys.argv[1:]:
            continue
        try:
            phase_device()
            phase()
        except Exception as e:
            import traceback

            traceback.print_exc()
            print(f"[FAIL] {type(e).__name__}: {e}", flush=True)
            return 1
        return 0
    if "--time-scipy-resample" in sys.argv[1:]:
        try:
            phase_device()
            SCRATCH.mkdir(parents=True, exist_ok=True)
            time_scipy_resample()
        except Exception as e:
            print(f"[FAIL] {type(e).__name__}: {e}", flush=True)
            return 1
        return 0
    try:
        name, _ = phase_device()
        phase_build()
        shutil.rmtree(SCRATCH, ignore_errors=True)
        SCRATCH.mkdir(parents=True)
        kernels = phase_kernels()
        phase_slice()
        phase_parity()
        f32_launches = phase_fp32_eval()
        launches = phase_train()
        f32_train_launches = phase_fp32_train()
        phase_workloads()
        phase_fp32_workloads()
        phase_entry_points()
        phase_train_parity()
        phase_fp32_train_parity()
        phase_checkpoints()
        phase_multi()
        phase_window_attn()
        phase_instance_norm()
    except Exception as e:  # every phase's failure fails the run
        import traceback

        traceback.print_exc()
        print(f"[FAIL] {type(e).__name__}: {e}", flush=True)
        return 1
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    import torch

    # launches: the count of each kernel from the host over the train CLI's
    # run (its eager steps, the first two: the others replay as CUDA graphs,
    # whose kernels phase 6's step alone counts on the device; and its
    # validation forwards); of the fp32 eval instances,
    # over the fp32 eval CLI's run; of the fp32 training instances, over the
    # fp32 train CLI's run, this slice's main path
    launches = {**launches, **{k: f32_launches[k] for k in F32_KERNELS},
                **{k: f32_train_launches[k] for k in F32_TRAIN_KERNELS}}
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
