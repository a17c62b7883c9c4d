"""1x1x1 segmentation head: channel-first features -> fp32 logits, with its
backward.

Port of ``multimodal_segmentation_project_tpu/ops/head.py``'s
``head1x1_cf``, a differentiable op. Its backward follows
``_head_bwd_rule``: dx is the head's own kernel on the logits' fp32
cotangent with the transposed weights and a zero bias, written in the
features' dtype (:func:`head1x1_cf_dx`); dkernel and dbias are reductions
over batch and volume (:func:`head1x1_cf_dw`), plain XLA in the JAX
package and a kernel of the port's own here.

On CUDA tensors the forward launches ``csrc/head1x1.cu:mmseg_head1x1``
(bf16 features in, fp32 logits out) or, for fp32 features,
``mmseg_head1x1_f32`` (counted on :func:`head1x1_cf_f32`), dx ``mmseg_head1x1_dx`` (fp32
cotangent in, bf16 out, no bias) and the weight gradient
``mmseg_head1x1_dw`` (bf16 features and fp32 cotangent in, fp32 dkernel
and dbias out); on CPU tensors they run :func:`head1x1_cf_reference`,
:func:`head1x1_cf_dx_reference` and :func:`head1x1_cf_dw_reference`.
:func:`head_call`, :func:`head_f32_call`, :func:`dx_call` and
:func:`dw_call` build each launch with its operands and outputs ready, for
the wrappers and for a bare timing. The backward's kernels take bf16
features, so off the CPU an fp32 head that needs a gradient is refused:
their fp32 instances are not ported yet.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.ops import _build
from multimodal_segmentation_project_tpu_torch.ops._build import Launch, run

MAX_CLASSES = 8  # the forward kernel's register budget for logits per voxel
MAX_DX_CHANNELS = 64  # the dx and weight-gradient kernels: feature channels
HEAD_THREADS = 256  # csrc/head1x1.cu THREADS: 8-voxel groups per block
HEAD_DW_BLOCKS_PER_SM = 1  # csrc/head1x1.cu DW_BLOCKS_PER_SM: the weight gradient's grid
SMEM_LIMIT = 48 * 1024  # the forward's (Cin, Co rounded up to 4) fp32 weight table


def head1x1_cf_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 einsum over channels plus bias."""
    y = torch.einsum("bidhw,io->bodhw", x.float(), kernel.float())
    return y + bias.float().reshape(1, -1, 1, 1, 1)


def head1x1_cf_dx_reference(ct: torch.Tensor, kernel: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
    """Plain version of dx: fp32 einsum of the cotangent with the weights, one cast."""
    return torch.einsum("bodhw,io->bidhw", ct.float(), kernel.float()).to(dtype)


def route(dtype: torch.dtype) -> str:
    """The C entry point of a forward head on features of ``dtype`` on the card."""
    return "mmseg_head1x1_f32" if dtype == torch.float32 else "mmseg_head1x1"


def _head_operands(name: str, x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                   dtype: torch.dtype):
    """Checks for a forward kernel on features x of ``dtype``; the weights
    as (Co, Cin) fp32, the fp32 bias and the fp32 logits."""
    _build.require(name, x, dtype, 5)
    b, cin, d, h, w = x.shape
    if kernel.dim() != 2 or kernel.shape[0] != cin:
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does not match Cin={cin}")
    co = kernel.shape[1]
    if not 1 <= co <= MAX_CLASSES:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_CLASSES} classes, got {co}")
    if tuple(bias.shape) != (co,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not match {co} classes")
    if cin * -(-co // 4) * 4 * 4 > SMEM_LIMIT:
        raise ValueError(f"{name}: Cin={cin} needs a weight table over the kernel's "
                         f"{SMEM_LIMIT} bytes of shared memory")
    wk = kernel.t().to(x.device, torch.float32).contiguous()
    bk = bias.to(x.device, torch.float32).contiguous()
    out = torch.empty((b, co, d, h, w), dtype=torch.float32, device=x.device)
    return wk, bk, out


def head_call(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> Launch:
    """Kernel 11's call on CUDA tensors: fp32 logits (B, Co, D, H, W) from
    bf16 features x (B, Cin, D, H, W), kernel (Cin, Co) and bias (Co,).
    The kernel reads the weights as (Co, Cin) fp32: kernel.t(), a view of
    the model's (classes, Cin) parameter, so no copy where it already is one."""
    wk, bk, out = _head_operands("head1x1_cf", x, kernel, bias, torch.bfloat16)
    b, cin, d, h, w = x.shape
    return Launch("mmseg_head1x1", (x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                                    b, cin, out.shape[1], d * h * w), out, (x, wk, bk, out))


def f32_launch_dims(shape: tuple, co: int) -> tuple:
    """(blocks, threads, dynamic shared memory in bytes) of the forward
    kernel on features of ``shape`` (B, Cin, D, H, W): a thread per 8
    voxels of one batch element, the [Cin][Co rounded up to 4] fp32 weight
    table."""
    b, cin, d, h, w = shape
    groups = b * -(-(d * h * w) // 8)
    return -(-groups // HEAD_THREADS), HEAD_THREADS, cin * -(-co // 4) * 4 * 4


def head_f32_call(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> Launch:
    """Kernel 11's fp32 call on CUDA tensors: fp32 logits from fp32
    features x (B, Cin, D, H, W), kernel (Cin, Co) and bias (Co,)."""
    wk, bk, out = _head_operands("head1x1_cf_f32", x, kernel, bias, torch.float32)
    b, cin, d, h, w = x.shape
    args = (x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(), b, cin, out.shape[1],
            d * h * w, *f32_launch_dims(tuple(x.shape), out.shape[1]))
    return Launch("mmseg_head1x1_f32", args, out, (x, wk, bk, out))


def dx_call(ct: torch.Tensor, kernel: torch.Tensor) -> Launch:
    """Kernel 11-dx's call on CUDA tensors: bf16 dx (B, Cf, D, H, W) from
    the fp32 cotangent ct (B, Co, D, H, W) and kernel (Cf, Co). The kernel
    reads the weights as (Co, Cf) fp32, kernel.t(): in the model a view of
    the (classes, Cf) parameter, so neither a copy nor a bias is made."""
    name = "head1x1_cf_dx"
    _build.require(name, ct, torch.float32, 5)
    b, co, d, h, w = ct.shape
    if kernel.dim() != 2 or kernel.shape[1] != co:
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does not match Co={co}")
    if not 1 <= co <= MAX_CLASSES:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_CLASSES} classes, got {co}")
    cf = kernel.shape[0]
    if not 1 <= cf <= MAX_DX_CHANNELS:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_DX_CHANNELS} channels, got {cf}")
    wk = kernel.t().to(ct.device, torch.float32).contiguous()
    dx = torch.empty((b, cf, d, h, w), dtype=torch.bfloat16, device=ct.device)
    return Launch("mmseg_head1x1_dx", (ct.data_ptr(), wk.data_ptr(), dx.data_ptr(), b, co, cf,
                                       d * h * w), dx, (ct, wk, dx))


def dw_blocks(device: torch.device, groups: int) -> int:
    """Blocks of the weight-gradient kernel's first pass: HEAD_DW_BLOCKS_PER_SM
    a SM, at most one per HEAD_THREADS groups of 8 voxels. The split depends
    on the SM count and the volume only, so the sum order and the result do
    not change from run to run on one card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(HEAD_DW_BLOCKS_PER_SM * sms, -(-groups // HEAD_THREADS)))


def dw_call(x: torch.Tensor, ct: torch.Tensor) -> Launch:
    """Kernel 11-dw's call on CUDA tensors: fp32 dkernel (Cf, Co) and dbias
    (Co,) from the bf16 features x (B, Cf, D, H, W) and the fp32 cotangent
    ct (B, Co, D, H, W), through an fp32 scratch of one row of Cf * Co + Co
    partials per block."""
    name = "head1x1_cf_dw"
    _build.require(name, x, torch.bfloat16, 5)
    _build.require(name, ct, torch.float32, 5)
    b, cf, d, h, w = x.shape
    co = ct.shape[1]
    if ct.shape[0] != b or ct.shape[2:] != x.shape[2:]:
        raise ValueError(f"{name}: cotangent {tuple(ct.shape)} does not match x {tuple(x.shape)}")
    if not 1 <= co <= MAX_CLASSES:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_CLASSES} classes, got {co}")
    if not 1 <= cf <= MAX_DX_CHANNELS:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_DX_CHANNELS} channels, got {cf}")
    v = d * h * w
    nblk = dw_blocks(x.device, b * -(-v // 8))
    part = torch.empty(nblk * (cf * co + co), dtype=torch.float32, device=x.device)
    dk = torch.empty((cf, co), dtype=torch.float32, device=x.device)
    db = torch.empty((co,), dtype=torch.float32, device=x.device)
    return Launch("mmseg_head1x1_dw", (x.data_ptr(), ct.data_ptr(), part.data_ptr(), dk.data_ptr(),
                                       db.data_ptr(), b, cf, co, v, nblk), (dk, db),
                  (x, ct, part, dk, db))


def _head_fwd(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward without autograd; its bf16 launches count on head1x1_cf,
    its fp32 ones on head1x1_cf_f32."""
    if x.device.type == "cpu":
        return head1x1_cf_reference(x, kernel, bias)
    if x.dtype == torch.float32:
        return head1x1_cf_f32(x, kernel, bias)
    out = run("head1x1_cf", head_call(x, kernel, bias), x)
    head1x1_cf.launches += 1
    return out


def head1x1_cf_f32(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel 11's fp32 instance, forward only: fp32 logits from fp32
    features; the plain version on the CPU."""
    if x.device.type == "cpu":
        return head1x1_cf_reference(x, kernel, bias)
    out = run("head1x1_cf_f32", head_f32_call(x, kernel, bias), x)
    head1x1_cf_f32.launches += 1
    return out


def head1x1_cf_dx(ct: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dx (B, Cin, D, H, W) in ``dtype`` from the logits' cotangent ct (B,
    Co, D, H, W) and kernel (Cin, Co); fp32 ct and bf16 dx only on CUDA."""
    if ct.device.type == "cpu":
        return head1x1_cf_dx_reference(ct, kernel, dtype)
    if dtype != torch.bfloat16:
        raise TypeError(f"head1x1_cf_dx: the CUDA kernel writes bfloat16, asked for {dtype}")
    out = run("head1x1_cf_dx", dx_call(ct, kernel), ct)
    head1x1_cf_dx.launches += 1
    return out


def head1x1_cf_dw_reference(x: torch.Tensor,
                            ct: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the weight gradient: an fp32 einsum and a sum."""
    dk = torch.einsum("bidhw,bodhw->io", x.float(), ct.float())
    return dk, ct.float().sum(dim=(0, 2, 3, 4))


def head1x1_cf_dw(x: torch.Tensor, ct: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dkernel (Cin, Co) and dbias (Co,) in fp32 from the features x (B,
    Cin, D, H, W) and the logits' cotangent ct (B, Co, D, H, W): reductions
    over batch and volume; bf16 x and fp32 ct only on CUDA."""
    if x.device.type == "cpu":
        return head1x1_cf_dw_reference(x, ct)
    out = run("head1x1_cf_dw", dw_call(x, ct), x)
    head1x1_cf_dw.launches += 1
    return out


class _Head(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        return _head_fwd(x, kernel, bias)

    @staticmethod
    def backward(ctx, ct):
        x, kernel = ctx.saved_tensors
        ct = ct.contiguous()
        dx = head1x1_cf_dx(ct, kernel, x.dtype) if ctx.needs_input_grad[0] else None
        dk, db = head1x1_cf_dw(x, ct)
        return dx, dk.to(kernel.dtype), db


def head1x1_cf(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, D, H, W), kernel (Cin, Co), bias (Co,) -> fp32 (B, Co, D, H, W),
    differentiable; on CUDA bf16 features, or fp32 ones without a gradient."""
    if (x.device.type != "cpu" and x.dtype == torch.float32 and torch.is_grad_enabled()
            and any(t.requires_grad for t in (x, kernel, bias))):
        raise TypeError("head1x1_cf: an fp32 head that needs a gradient needs the fp32 "
                        "instances of the head's dx and weight-gradient kernels, which are not "
                        "ported yet")
    return _Head.apply(x, kernel, bias)


head1x1_cf.launches = 0  # forward kernel launches
head1x1_cf_f32.launches = 0
head1x1_cf_dx.launches = 0
head1x1_cf_dw.launches = 0
