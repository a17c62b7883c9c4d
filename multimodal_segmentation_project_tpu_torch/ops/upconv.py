"""2x2x2 stride-2 transpose conv (UpConv) on channel-first volumes (forward).

Port of ``multimodal_segmentation_project_tpu/ops/upconv.py``'s
``upconv2x_cf``. With kernel == stride every output voxel receives exactly
one kernel tap, so the op is a per-voxel (8*Cout x Cin) product plus bias
followed by depth-to-space. On a CUDA tensor it launches
``csrc/upconv_d2s.cu``; on a CPU tensor it runs
:func:`upconv2x_cf_reference`. Rounding: the kernel weights are cast to
the working dtype, products and sums are fp32, the fp32 bias is added, one
cast back.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.ops import _build

MAX_OUT_CHANNELS = 64  # wider upconvs (the deep region) use the plain torch op


def supported(cout: int) -> bool:
    return cout <= MAX_OUT_CHANNELS


def upconv2x_cf_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: the per-voxel einsum, then depth-to-space by reshape."""
    b, _, d, h, w = x.shape
    cout = kernel.shape[4]
    t = torch.einsum("bidhw,apqio->bodahpwq", x.float(), kernel.to(x.dtype).float())
    out = t.reshape(b, cout, 2 * d, 2 * h, 2 * w) + bias.float().reshape(1, -1, 1, 1, 1)
    return out.to(x.dtype)


def upconv2x_cf(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, D, H, W), kernel (2, 2, 2, Cin, Cout), bias (Cout,) ->
    (B, Cout, 2D, 2H, 2W) in x's dtype; bf16 only on CUDA."""
    if x.device.type == "cpu":
        return upconv2x_cf_reference(x, kernel, bias)
    name = "upconv2x_cf"
    _build.require(name, x, torch.bfloat16, 5)
    b, cin, d, h, w = x.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (2, 2, 2, cin):
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does not match Cin={cin}")
    cout = kernel.shape[4]
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not match Cout={cout}")
    kk = kernel.to(x.device, torch.bfloat16).contiguous()
    bk = bias.to(x.device, torch.float32).contiguous()
    out = torch.empty((b, cout, 2 * d, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    _build.launch(name, "mmseg_upconv_d2s", x, x.data_ptr(), kk.data_ptr(), bk.data_ptr(),
                  out.data_ptr(), b, cin, cout, d, h, w)
    upconv2x_cf.launches += 1
    return out


upconv2x_cf.launches = 0
