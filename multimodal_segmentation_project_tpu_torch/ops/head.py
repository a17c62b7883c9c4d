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
cotangent in, bf16 out); on CPU tensors they run
:func:`head1x1_cf_reference` and :func:`head1x1_cf_dx_reference`.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.ops import _build

MAX_CLASSES = 8  # the forward kernel's register budget for logits per voxel
MAX_DX_CHANNELS = 64  # the dx kernel's: feature channels per voxel


def head1x1_cf_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 einsum over channels plus bias."""
    y = torch.einsum("bidhw,io->bodhw", x.float(), kernel.float())
    return y + bias.float().reshape(1, -1, 1, 1, 1)


def head1x1_cf_dx_reference(ct: torch.Tensor, kernel: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
    """Plain version of dx: fp32 einsum of the cotangent with the weights, one cast."""
    return torch.einsum("bodhw,io->bidhw", ct.float(), kernel.float()).to(dtype)


def _launch(name: str, entry: str, x: torch.Tensor, w_oc: torch.Tensor, out_dtype: torch.dtype,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """out (B, Co, D, H, W) = w_oc (Co, Cin) . x (B, Cin, D, H, W) + bias."""
    b, cin, d, h, w = x.shape
    co = w_oc.shape[0]
    wk = w_oc.to(x.device, torch.float32).contiguous()
    bk = (torch.zeros(co, device=x.device) if bias is None
          else bias.to(x.device, torch.float32).contiguous())
    out = torch.empty((b, co, d, h, w), dtype=out_dtype, device=x.device)
    _build.launch(name, entry, x, x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                  b, cin, co, d * h * w)
    return out


def _head_fwd(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward without autograd; its launches count on head1x1_cf."""
    if x.device.type == "cpu":
        return head1x1_cf_reference(x, kernel, bias)
    name = "head1x1_cf"
    _build.require(name, x, torch.bfloat16, 5)
    cin = x.shape[1]
    if kernel.dim() != 2 or kernel.shape[0] != cin:
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does not match Cin={cin}")
    co = kernel.shape[1]
    if not 1 <= co <= MAX_CLASSES:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_CLASSES} classes, got {co}")
    if tuple(bias.shape) != (co,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not match {co} classes")
    out = _launch(name, "mmseg_head1x1", x, kernel.t(), torch.float32, bias)
    head1x1_cf.launches += 1
    return out


def head1x1_cf_dx(ct: torch.Tensor, kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dx (B, Cin, D, H, W) in ``dtype`` from the logits' cotangent ct (B,
    Co, D, H, W) and kernel (Cin, Co); fp32 ct and bf16 dx only on CUDA."""
    if ct.device.type == "cpu":
        return head1x1_cf_dx_reference(ct, kernel, dtype)
    name = "head1x1_cf_dx"
    _build.require(name, ct, torch.float32, 5)
    if dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel writes bfloat16, asked for {dtype}")
    if kernel.dim() != 2 or kernel.shape[1] != ct.shape[1]:
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does not match Co={ct.shape[1]}")
    if not 1 <= kernel.shape[0] <= MAX_DX_CHANNELS:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_DX_CHANNELS} channels, "
                         f"got {kernel.shape[0]}")
    out = _launch(name, "mmseg_head1x1_dx", ct, kernel, torch.bfloat16)
    head1x1_cf_dx.launches += 1
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
        dk = torch.einsum("bidhw,bodhw->io", x.float(), ct.float()).to(kernel.dtype)
        db = ct.float().sum(dim=(0, 2, 3, 4))
        return dx, dk, db


def head1x1_cf(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, D, H, W), kernel (Cin, Co), bias (Co,) -> fp32 (B, Co, D, H, W),
    differentiable; bf16 features only on CUDA."""
    return _Head.apply(x, kernel, bias)


head1x1_cf.launches = 0  # forward kernel launches
head1x1_cf_dx.launches = 0
