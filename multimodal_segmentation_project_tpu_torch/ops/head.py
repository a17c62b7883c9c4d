"""1x1x1 segmentation head: channel-first features -> fp32 logits, with its
backward.

Port of ``multimodal_segmentation_project_tpu/ops/head.py``'s
``head1x1_cf``, a differentiable op. Its backward follows
``_head_bwd_rule``: dx is the head's own kernel on the logits' fp32
cotangent with the transposed weights and a zero bias, written in the
features' dtype (:func:`head1x1_cf_dx`); dkernel and dbias are plain
reductions over the volume, as they are plain XLA in the JAX package.

On CUDA tensors the forward launches ``csrc/head1x1.cu:mmseg_head1x1``
(bf16 features in, fp32 logits out) and dx ``mmseg_head1x1_dx`` (fp32
cotangent in, bf16 out, no bias); on CPU tensors they run
:func:`head1x1_cf_reference` and :func:`head1x1_cf_dx_reference`.
:func:`head_call` and :func:`dx_call` build each launch with its operands
and output ready, for the wrappers and for a bare timing.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.ops import _build
from multimodal_segmentation_project_tpu_torch.ops._build import Launch, run

MAX_CLASSES = 8  # the forward kernel's register budget for logits per voxel
MAX_DX_CHANNELS = 64  # the dx kernel's weight table: feature channels


def head1x1_cf_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 einsum over channels plus bias."""
    y = torch.einsum("bidhw,io->bodhw", x.float(), kernel.float())
    return y + bias.float().reshape(1, -1, 1, 1, 1)


def head1x1_cf_dx_reference(ct: torch.Tensor, kernel: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
    """Plain version of dx: fp32 einsum of the cotangent with the weights, one cast."""
    return torch.einsum("bodhw,io->bidhw", ct.float(), kernel.float()).to(dtype)


def head_call(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> Launch:
    """Kernel 11's call on CUDA tensors: fp32 logits (B, Co, D, H, W) from
    bf16 features x (B, Cin, D, H, W), kernel (Cin, Co) and bias (Co,).
    The kernel reads the weights as (Co, Cin) fp32: kernel.t(), a view of
    the model's (classes, Cin) parameter, so no copy where it already is one."""
    name = "head1x1_cf"
    _build.require(name, x, torch.bfloat16, 5)
    b, cin, d, h, w = x.shape
    if kernel.dim() != 2 or kernel.shape[0] != cin:
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does not match Cin={cin}")
    co = kernel.shape[1]
    if not 1 <= co <= MAX_CLASSES:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_CLASSES} classes, got {co}")
    if tuple(bias.shape) != (co,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not match {co} classes")
    wk = kernel.t().to(x.device, torch.float32).contiguous()
    bk = bias.to(x.device, torch.float32).contiguous()
    out = torch.empty((b, co, d, h, w), dtype=torch.float32, device=x.device)
    return Launch("mmseg_head1x1", (x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                                    b, cin, co, d * h * w), out, (x, wk, bk, out))


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


def _head_fwd(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward without autograd; its launches count on head1x1_cf."""
    if x.device.type == "cpu":
        return head1x1_cf_reference(x, kernel, bias)
    out = run("head1x1_cf", head_call(x, kernel, bias), x)
    head1x1_cf.launches += 1
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


def weight_grads(x: torch.Tensor, ct: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """dkernel (Cin, Co) and dbias (Co,) in fp32 from the features x and
    the logits' cotangent ct: plain reductions over batch and volume."""
    dk = torch.einsum("bidhw,bodhw->io", x.float(), ct.float())
    return dk, ct.float().sum(dim=(0, 2, 3, 4))


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
        dk, db = weight_grads(x, ct)
        return dx, dk.to(kernel.dtype), db


def head1x1_cf(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, D, H, W), kernel (Cin, Co), bias (Co,) -> fp32 (B, Co, D, H, W),
    differentiable; bf16 features only on CUDA."""
    return _Head.apply(x, kernel, bias)


head1x1_cf.launches = 0  # forward kernel launches
head1x1_cf_dx.launches = 0
