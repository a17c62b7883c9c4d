"""2x2x2 stride-2 transpose conv (UpConv) on channel-first volumes.

Port of ``multimodal_segmentation_project_tpu/ops/upconv.py``'s
``upconv2x_cf``, a differentiable op. With kernel == stride every output
voxel receives exactly one kernel tap, so the op is a per-voxel (8*Cout x
Cin) product plus bias followed by depth-to-space. On a CUDA tensor the
forward launches ``csrc/upconv_d2s.cu``; on a CPU tensor it runs
:func:`upconv2x_cf_reference`. Rounding: the kernel weights are cast to
the working dtype, products and sums are fp32, the fp32 bias is added, one
cast back.

The backward is ``_upconv_bwd_rule``'s contractions over the 8
depth-to-space phases, which are plain XLA in the JAX package; here they
are torch matmuls in fp32 (no kernel of the port): dx in x's dtype, dk and
db in fp32.
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


def _upconv_fwd(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward without autograd; its launches count on upconv2x_cf."""
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


def _phases(ct: torch.Tensor) -> torch.Tensor:
    """ct (B, Cout, 2D, 2H, 2W) -> (B, 8*Cout, D*H*W): the 8 depth-to-space
    phases stacked along the channel axis in (a, p, q, o) order."""
    b, cout, d2, h2, w2 = ct.shape
    t = ct.reshape(b, cout, d2 // 2, 2, h2 // 2, 2, w2 // 2, 2)
    return t.permute(0, 3, 5, 7, 1, 2, 4, 6).reshape(b, 8 * cout, -1)


class _UpConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(x, kernel)
        return _upconv_fwd(x, kernel, bias)

    @staticmethod
    def backward(ctx, ct):
        x, kernel = ctx.saved_tensors
        b, cin = x.shape[:2]
        cout = kernel.shape[4]
        ct8 = _phases(ct).float()  # (b, 8*cout, V)
        # (8*cout, cin) in (a, p, q, o) row order, cast as the forward casts
        k2 = kernel.permute(0, 1, 2, 4, 3).reshape(8 * cout, cin).to(ct.dtype).float()
        dx = torch.matmul(k2.t(), ct8).reshape(x.shape).to(x.dtype)
        dk = torch.einsum("biv,bkv->ik", x.reshape(b, cin, -1).float(), ct8)
        dk = dk.reshape(cin, 2, 2, 2, cout).permute(1, 2, 3, 0, 4).to(kernel.dtype)
        db = ct.float().sum(dim=(0, 2, 3, 4)).to(kernel.dtype)
        return dx, dk, db


def upconv2x_cf(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, Cin, D, H, W), kernel (2, 2, 2, Cin, Cout), bias (Cout,) ->
    (B, Cout, 2D, 2H, 2W) in x's dtype, differentiable; bf16 only on CUDA."""
    return _UpConv.apply(x, kernel, bias)


upconv2x_cf.launches = 0  # forward kernel launches
