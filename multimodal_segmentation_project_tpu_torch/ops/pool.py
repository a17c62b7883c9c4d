"""2x2x2 stride-2 max pool on channel-first volumes, with its backward.

Port of ``multimodal_segmentation_project_tpu/ops/pool.py``'s
``max_pool2x_cf``: a differentiable op whose backward gives equal shares
to tied maxima (JAX's convention; torch's own max-pool autograd gives the
whole gradient to the first match):

    dx[v] = g[v/2] * [x[v] == y[v/2]] / count(v/2)

computed in fp32 with one cast, as the TPU kernel computes it. Odd extents
use floor semantics; the dropped tail gets a zero gradient.

On CUDA tensors the forward launches ``csrc/pool2x.cu:pool2x_kernel``, in
bf16 or, for an fp32 x, its fp32 instance (counted on
:func:`max_pool2x_cf_f32`), and the backward ``pool2x_bwd_kernel``, in bf16
or fp32 (counted on :func:`max_pool2x_cf_bwd_f32`), at every channel count
and shape; on CPU tensors they run :func:`max_pool2x_cf_reference` and
:func:`max_pool2x_cf_bwd_reference`.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.ops import _build
from multimodal_segmentation_project_tpu_torch.ops._build import Launch, count, run

POOL_THREADS = 256  # csrc/pool2x.cu THREADS: pooled voxels per block


def route(dtype: torch.dtype) -> str:
    """The C entry point of a forward pool of ``dtype`` on the card."""
    return "mmseg_pool2x_f32" if dtype == torch.float32 else "mmseg_pool2x"


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


def pool_call(x: torch.Tensor) -> Launch:
    """Kernel 8's call on CUDA tensors: bf16 x (B, C, D, H, W) -> (B, C,
    D//2, H//2, W//2)."""
    _build.require("max_pool2x_cf", x, torch.bfloat16, 5)
    b, c, d, h, w = x.shape
    out = torch.empty((b, c, d // 2, h // 2, w // 2), dtype=x.dtype, device=x.device)
    return Launch("mmseg_pool2x", (x.data_ptr(), out.data_ptr(), b, c, d, h, w), out, (x, out))


def f32_launch_dims(shape: tuple) -> tuple:
    """(blocks, threads) of the fp32 forward on x of ``shape``: one thread
    per pooled voxel."""
    b, c, d, h, w = shape
    return -(-(b * c * (d // 2) * (h // 2) * (w // 2)) // POOL_THREADS), POOL_THREADS


def pool_f32_call(x: torch.Tensor) -> Launch:
    """Kernel 8's fp32 call on CUDA tensors: fp32 x (B, C, D, H, W) -> (B,
    C, D//2, H//2, W//2)."""
    _build.require("max_pool2x_cf_f32", x, torch.float32, 5)
    b, c, d, h, w = x.shape
    out = torch.empty((b, c, d // 2, h // 2, w // 2), dtype=x.dtype, device=x.device)
    return Launch("mmseg_pool2x_f32", (x.data_ptr(), out.data_ptr(), b, c, d, h, w,
                                       *f32_launch_dims(tuple(x.shape))), out, (x, out))


def _bwd_operands(name: str, x: torch.Tensor, y: torch.Tensor, g: torch.Tensor,
                  dtype: torch.dtype):
    """Checks for a backward kernel on x, y and g, all of ``dtype``; dx,
    zero-filled where an extent is odd (the dropped tail gets no gradient),
    and the C arguments before the descriptor."""
    for t in (x, y, g):
        _build.require(name, t, dtype, 5)
    b, c, d, h, w = x.shape
    pooled = (b, c, d // 2, h // 2, w // 2)
    if tuple(y.shape) != pooled or tuple(g.shape) != pooled:
        raise ValueError(f"{name}: y {tuple(y.shape)} and g {tuple(g.shape)} must be {pooled}")
    odd = d % 2 or h % 2 or w % 2
    dx = (torch.zeros if odd else torch.empty)(x.shape, dtype=x.dtype, device=x.device)
    return dx, (x.data_ptr(), y.data_ptr(), g.data_ptr(), dx.data_ptr(), b, c, d, h, w)


def bwd_call(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> Launch:
    """Kernel 9's call on CUDA tensors: dx (B, C, D, H, W) from the input
    x, the pooled y and its cotangent g, all bf16."""
    dx, args = _bwd_operands("max_pool2x_cf_bwd", x, y, g, torch.bfloat16)
    return Launch("mmseg_pool2x_bwd", args, dx, (x, y, g, dx))


def bwd_f32_call(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> Launch:
    """Kernel 9's fp32 call on CUDA tensors: dx from x, y and g, all fp32;
    one thread per pooled voxel (f32_launch_dims)."""
    dx, args = _bwd_operands("max_pool2x_cf_bwd_f32", x, y, g, torch.float32)
    return Launch("mmseg_pool2x_bwd_f32", (*args, *f32_launch_dims(tuple(x.shape))), dx,
                  (x, y, g, dx))


def _pool_fwd(x: torch.Tensor) -> torch.Tensor:
    """The forward without autograd; its bf16 launches count on
    max_pool2x_cf, its fp32 ones on max_pool2x_cf_f32."""
    if x.device.type == "cpu":
        return max_pool2x_cf_reference(x)
    if x.dtype == torch.float32:
        return max_pool2x_cf_f32(x)
    out = run("max_pool2x_cf", pool_call(x), x)
    count(max_pool2x_cf)
    return out


def max_pool2x_cf_f32(x: torch.Tensor) -> torch.Tensor:
    """Kernel 8's fp32 instance, forward only: the 2x2x2 max pool of an
    fp32 x; the plain version on the CPU."""
    if x.device.type == "cpu":
        return max_pool2x_cf_reference(x)
    out = run("max_pool2x_cf_f32", pool_f32_call(x), x)
    count(max_pool2x_cf_f32)
    return out


def max_pool2x_cf_bwd(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx (B, C, D, H, W) in x's dtype from the input x, the pooled y and
    its cotangent g; on CUDA bf16 here, fp32 through
    :func:`max_pool2x_cf_bwd_f32`."""
    if x.device.type == "cpu":
        return max_pool2x_cf_bwd_reference(x, y, g)
    if x.dtype == torch.float32:
        return max_pool2x_cf_bwd_f32(x, y, g)
    dx = run("max_pool2x_cf_bwd", bwd_call(x, y, g), x)
    count(max_pool2x_cf_bwd)
    return dx


def max_pool2x_cf_bwd_f32(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel 9's fp32 instance: dx of an fp32 pool, equal shares to ties;
    the plain version on the CPU."""
    if x.device.type == "cpu":
        return max_pool2x_cf_bwd_reference(x, y, g)
    dx = run("max_pool2x_cf_bwd_f32", bwd_f32_call(x, y, g), x)
    count(max_pool2x_cf_bwd_f32)
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
    D//2, H//2, W//2); on CUDA in bf16 or fp32."""
    return _MaxPool2x.apply(x)


max_pool2x_cf.launches = 0  # forward kernel launches
max_pool2x_cf_f32.launches = 0
max_pool2x_cf_bwd.launches = 0
max_pool2x_cf_bwd_f32.launches = 0
