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
(bf16 features in, fp32 logits out), dx ``mmseg_head1x1_dx`` (fp32
cotangent in, bf16 out, no bias) and the weight gradient
``mmseg_head1x1_dw`` (bf16 features and fp32 cotangent in, fp32 dkernel
and dbias out); for fp32 features their fp32 instances
``mmseg_head1x1_f32``, ``mmseg_head1x1_dx_f32`` (fp32 out) and
``mmseg_head1x1_dw_f32``, counted on :func:`head1x1_cf_f32`,
:func:`head1x1_cf_dx_f32` and :func:`head1x1_cf_dw_f32`. On CPU tensors
they run :func:`head1x1_cf_reference`, :func:`head1x1_cf_dx_reference` and
:func:`head1x1_cf_dw_reference`. The ``*_call`` functions build each
launch with its operands and outputs ready, for the wrappers and for a
bare timing.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.ops import _build
from multimodal_segmentation_project_tpu_torch.ops._build import Launch, count, run

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


def _dx_operands(name: str, ct: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype):
    """Checks for a dx kernel on the fp32 cotangent ct and kernel (Cf, Co);
    the weights as (Co, Cf) fp32 and dx (B, Cf, D, H, W) in ``dtype``."""
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
    return wk, torch.empty((b, cf, d, h, w), dtype=dtype, device=ct.device)


def dx_call(ct: torch.Tensor, kernel: torch.Tensor) -> Launch:
    """Kernel 11-dx's call on CUDA tensors: bf16 dx (B, Cf, D, H, W) from
    the fp32 cotangent ct (B, Co, D, H, W) and kernel (Cf, Co). The kernel
    reads the weights as (Co, Cf) fp32, kernel.t(): in the model a view of
    the (classes, Cf) parameter, so neither a copy nor a bias is made."""
    wk, dx = _dx_operands("head1x1_cf_dx", ct, kernel, torch.bfloat16)
    b, co, d, h, w = ct.shape
    return Launch("mmseg_head1x1_dx", (ct.data_ptr(), wk.data_ptr(), dx.data_ptr(), b, co,
                                       dx.shape[1], d * h * w), dx, (ct, wk, dx))


def dx_f32_launch_dims(shape: tuple) -> tuple:
    """(blocks, threads) of the dx kernel on a cotangent of ``shape`` (B,
    Co, D, H, W): a thread per 8 voxels of one batch element."""
    b, _, d, h, w = shape
    return -(-(b * -(-(d * h * w) // 8)) // HEAD_THREADS), HEAD_THREADS


def dx_f32_call(ct: torch.Tensor, kernel: torch.Tensor) -> Launch:
    """Kernel 11-dx's fp32 call on CUDA tensors: fp32 dx (B, Cf, D, H, W)
    (fp32 features) from the fp32 cotangent ct and kernel (Cf, Co)."""
    wk, dx = _dx_operands("head1x1_cf_dx_f32", ct, kernel, torch.float32)
    b, co, d, h, w = ct.shape
    return Launch("mmseg_head1x1_dx_f32",
                  (ct.data_ptr(), wk.data_ptr(), dx.data_ptr(), b, co, dx.shape[1], d * h * w,
                   *dx_f32_launch_dims(tuple(ct.shape))), dx, (ct, wk, dx))


def dw_blocks(device: torch.device, groups: int) -> int:
    """Blocks of the weight-gradient kernel's first pass: HEAD_DW_BLOCKS_PER_SM
    a SM, at most one per HEAD_THREADS groups of 8 voxels. The split depends
    on the SM count and the volume only, so the sum order and the result do
    not change from run to run on one card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(HEAD_DW_BLOCKS_PER_SM * sms, -(-groups // HEAD_THREADS)))


def dw_slice(co: int, dtype: torch.dtype) -> int:
    """Feature channels per block row of the weight gradient on features of
    ``dtype`` (csrc/head1x1.cu dw_slice): its grid's y is ceil(Cf /
    dw_slice(Co, dtype))."""
    return (16 if co <= 4 else 8 if co <= 6 else 4) // (2 if dtype == torch.float32 else 1)


def _dw_operands(name: str, x: torch.Tensor, ct: torch.Tensor, dtype: torch.dtype):
    """Checks for a weight-gradient kernel on features x of ``dtype`` and
    the fp32 cotangent ct; its C arguments before the stream (less the
    fp32 entry's descriptor), and its outputs and tensors."""
    _build.require(name, x, dtype, 5)
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
    args = (x.data_ptr(), ct.data_ptr(), part.data_ptr(), dk.data_ptr(), db.data_ptr(), b, cf, co,
            v, nblk)
    return args, (dk, db), (x, ct, part, dk, db)


def dw_call(x: torch.Tensor, ct: torch.Tensor) -> Launch:
    """Kernel 11-dw's call on CUDA tensors: fp32 dkernel (Cf, Co) and dbias
    (Co,) from the bf16 features x (B, Cf, D, H, W) and the fp32 cotangent
    ct (B, Co, D, H, W), through an fp32 scratch of one row of Cf * Co + Co
    partials per block."""
    return Launch("mmseg_head1x1_dw", *_dw_operands("head1x1_cf_dw", x, ct, torch.bfloat16))


def dw_f32_call(x: torch.Tensor, ct: torch.Tensor) -> Launch:
    """Kernel 11-dw's fp32 call on CUDA tensors: the same from fp32
    features, with the descriptor's slices of feature channels (the grid's
    y) and threads."""
    args, out, tensors = _dw_operands("head1x1_cf_dw_f32", x, ct, torch.float32)
    cf, co = x.shape[1], ct.shape[1]
    slices = -(-cf // dw_slice(co, torch.float32))
    return Launch("mmseg_head1x1_dw_f32", (*args, slices, HEAD_THREADS), out, tensors)


def _head_fwd(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward without autograd; its bf16 launches count on head1x1_cf,
    its fp32 ones on head1x1_cf_f32."""
    if x.device.type == "cpu":
        return head1x1_cf_reference(x, kernel, bias)
    if x.dtype == torch.float32:
        return head1x1_cf_f32(x, kernel, bias)
    out = run("head1x1_cf", head_call(x, kernel, bias), x)
    count(head1x1_cf)
    return out


def head1x1_cf_f32(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Kernel 11's fp32 instance, forward only: fp32 logits from fp32
    features; the plain version on the CPU."""
    if x.device.type == "cpu":
        return head1x1_cf_reference(x, kernel, bias)
    out = run("head1x1_cf_f32", head_f32_call(x, kernel, bias), x)
    count(head1x1_cf_f32)
    return out


def head1x1_cf_dx(ct: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dx (B, Cin, D, H, W) in ``dtype`` from the logits' cotangent ct (B,
    Co, D, H, W) and kernel (Cin, Co); on CUDA an fp32 ct, and a bf16 dx
    here, an fp32 one through :func:`head1x1_cf_dx_f32`."""
    if ct.device.type == "cpu":
        return head1x1_cf_dx_reference(ct, kernel, dtype)
    if dtype == torch.float32:
        return head1x1_cf_dx_f32(ct, kernel)
    if dtype != torch.bfloat16:
        raise TypeError(f"head1x1_cf_dx: the CUDA kernels write bfloat16 or float32, asked for "
                        f"{dtype}")
    out = run("head1x1_cf_dx", dx_call(ct, kernel), ct)
    count(head1x1_cf_dx)
    return out


def head1x1_cf_dx_f32(ct: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Kernel 11-dx's fp32 instance: fp32 dx from the fp32 cotangent; the
    plain version on the CPU."""
    if ct.device.type == "cpu":
        return head1x1_cf_dx_reference(ct, kernel, torch.float32)
    out = run("head1x1_cf_dx_f32", dx_f32_call(ct, kernel), ct)
    count(head1x1_cf_dx_f32)
    return out


def head1x1_cf_dw_reference(x: torch.Tensor,
                            ct: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the weight gradient: an fp32 einsum and a sum."""
    dk = torch.einsum("bidhw,bodhw->io", x.float(), ct.float())
    return dk, ct.float().sum(dim=(0, 2, 3, 4))


def head1x1_cf_dw(x: torch.Tensor, ct: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dkernel (Cin, Co) and dbias (Co,) in fp32 from the features x (B,
    Cin, D, H, W) and the logits' cotangent ct (B, Co, D, H, W): reductions
    over batch and volume; on CUDA an fp32 ct, and bf16 x here, fp32 x
    through :func:`head1x1_cf_dw_f32`."""
    if x.device.type == "cpu":
        return head1x1_cf_dw_reference(x, ct)
    if x.dtype == torch.float32:
        return head1x1_cf_dw_f32(x, ct)
    out = run("head1x1_cf_dw", dw_call(x, ct), x)
    count(head1x1_cf_dw)
    return out


def head1x1_cf_dw_f32(x: torch.Tensor, ct: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 11-dw's fp32 instance: dkernel and dbias from fp32 features;
    the plain version on the CPU."""
    if x.device.type == "cpu":
        return head1x1_cf_dw_reference(x, ct)
    out = run("head1x1_cf_dw_f32", dw_f32_call(x, ct), x)
    count(head1x1_cf_dw_f32)
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
    differentiable; on CUDA bf16 or fp32 features."""
    return _Head.apply(x, kernel, bias)


head1x1_cf.launches = 0  # forward kernel launches
head1x1_cf_f32.launches = 0
head1x1_cf_dx.launches = 0
head1x1_cf_dx_f32.launches = 0
head1x1_cf_dw.launches = 0
head1x1_cf_dw_f32.launches = 0
