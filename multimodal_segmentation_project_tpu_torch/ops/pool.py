"""2x2x2 stride-2 max pool on channel-first volumes, with its backward.

Port of ``multimodal_segmentation_project_tpu/ops/pool.py``'s
``max_pool2x_cf``: a differentiable op whose backward gives equal shares
to tied maxima (JAX's convention; torch's own max-pool autograd gives the
whole gradient to the first match):

    dx[v] = g[v/2] * [x[v] == y[v/2]] / count(v/2)

computed in fp32 with one cast, as the TPU kernel computes it. Odd extents
use floor semantics; the dropped tail gets a zero gradient.

On CUDA tensors the forward launches ``csrc/pool2x.cu:pool2x_kernel`` and
the backward ``pool2x_bwd_kernel``, at every channel count and shape; on
CPU tensors they run :func:`max_pool2x_cf_reference` and
:func:`max_pool2x_cf_bwd_reference`.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.ops import _build


def _windows(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, C, D/2, 2, H/2, 2, W/2, 2), the floor windows."""
    b, c, d, h, w = x.shape
    x = x[:, :, : d // 2 * 2, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, c, d // 2, 2, h // 2, 2, w // 2, 2)


def max_pool2x_cf_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a reshape into 2x2x2 windows and a max over them."""
    return _windows(x).amax(dim=(3, 5, 7))


def max_pool2x_cf_bwd_reference(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward: equal shares to tied maxima, in fp32."""
    b, c, d, h, w = x.shape
    up = (slice(None), slice(None), slice(None), None, slice(None), None, slice(None), None)
    m = (_windows(x).float() == y.float()[up]).float()
    scale = g.float()[up] / m.sum(dim=(3, 5, 7), keepdim=True)
    dx = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    dx[:, :, : d // 2 * 2, : h // 2 * 2, : w // 2 * 2] = (m * scale).to(x.dtype).reshape(
        b, c, d // 2 * 2, h // 2 * 2, w // 2 * 2)
    return dx


def _pool_fwd(x: torch.Tensor) -> torch.Tensor:
    """The forward without autograd; its launches count on max_pool2x_cf."""
    if x.device.type == "cpu":
        return max_pool2x_cf_reference(x)
    name = "max_pool2x_cf"
    _build.require(name, x, torch.bfloat16, 5)
    b, c, d, h, w = x.shape
    out = torch.empty((b, c, d // 2, h // 2, w // 2), dtype=x.dtype, device=x.device)
    _build.launch(name, "mmseg_pool2x", x, x.data_ptr(), out.data_ptr(), b, c, d, h, w)
    max_pool2x_cf.launches += 1
    return out


def max_pool2x_cf_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx (B, C, D, H, W) in x's dtype from the input x, the pooled y and
    its cotangent g; bf16 only on CUDA."""
    if x.device.type == "cpu":
        return max_pool2x_cf_bwd_reference(x, y, g)
    name = "max_pool2x_cf_bwd"
    for t in (x, y, g):
        _build.require(name, t, torch.bfloat16, 5)
    b, c, d, h, w = x.shape
    pooled = (b, c, d // 2, h // 2, w // 2)
    if tuple(y.shape) != pooled or tuple(g.shape) != pooled:
        raise ValueError(f"{name}: y {tuple(y.shape)} and g {tuple(g.shape)} must be {pooled}")
    odd = d % 2 or h % 2 or w % 2
    dx = (torch.zeros if odd else torch.empty)(x.shape, dtype=x.dtype, device=x.device)
    _build.launch(name, "mmseg_pool2x_bwd", x, x.data_ptr(), y.data_ptr(), g.data_ptr(),
                  dx.data_ptr(), b, c, d, h, w)
    max_pool2x_cf_bwd.launches += 1
    return dx


class _MaxPool2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _pool_fwd(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return max_pool2x_cf_bwd(x, y, g.contiguous())


def max_pool2x_cf(x: torch.Tensor) -> torch.Tensor:
    """Differentiable 2x2x2 stride-2 max pool, (B, C, D, H, W) -> (B, C,
    D//2, H//2, W//2); bf16 only on CUDA."""
    return _MaxPool2x.apply(x)


max_pool2x_cf.launches = 0  # forward kernel launches
max_pool2x_cf_bwd.launches = 0
