"""1x1x1 segmentation head: channel-first features -> fp32 logits.

Port of ``multimodal_segmentation_project_tpu/ops/head.py``'s
``head1x1_cf``. On a CUDA tensor it launches ``csrc/head1x1.cu`` (bf16
features in, fp32 logits out); on a CPU tensor it runs
:func:`head1x1_cf_reference`.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.ops import _build

MAX_CLASSES = 8  # the kernel's register budget for logits per voxel


def head1x1_cf_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 einsum over channels plus bias."""
    y = torch.einsum("bidhw,io->bodhw", x.float(), kernel.float())
    return y + bias.float().reshape(1, -1, 1, 1, 1)


def head1x1_cf(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, D, H, W), kernel (Cin, Co), bias (Co,) -> fp32 (B, Co, D, H, W);
    bf16 features only on CUDA."""
    if x.device.type == "cpu":
        return head1x1_cf_reference(x, kernel, bias)
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
    w_oc = kernel.to(x.device, torch.float32).t().contiguous()  # (Co, Cin)
    bk = bias.to(x.device, torch.float32).contiguous()
    out = torch.empty((b, co, d, h, w), dtype=torch.float32, device=x.device)
    _build.launch(name, "mmseg_head1x1", x, x.data_ptr(), w_oc.data_ptr(), bk.data_ptr(),
                  out.data_ptr(), b, cin, co, d * h * w)
    head1x1_cf.launches += 1
    return out


head1x1_cf.launches = 0
