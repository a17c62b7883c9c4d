"""InstanceNorm with the residual block's tail: ``act(IN(x) + residual)``,
SwinUNETR's decoder and encoder norms (``models/swin_unetr.py``), with its
backward.

IN has no affine and is taken per sample and channel, with the biased
variance and eps 1e-5, on the instance's statistics in train and eval;
``act`` is LeakyReLU(``slope``) or the identity. The statistics and every
sum are fp32 (fp64 for an fp64 input on the CPU); the output is rounded
once, to x's dtype.

The kernels replace no TPU kernel: the JAX package has no InstanceNorm. What
bounds them is bytes. aten's ``group_norm`` reduces each (sample, channel)
row in one block, 48 blocks for a 48-channel 192^3 volume on the card's 132
SMs, each reading 7.08 M elements alone (about 0.1 TB/s); the LeakyReLU and
the residual add are further full-volume passes. Here every reduction is
split: a row is cut into chunks of ``chunking(S)[0]`` elements (a power of
two from MIN_CHUNK up to MAX_CHUNK, so ~41 k programs for 48 rows of 192^3
and one program a row where S <= MAX_CHUNK), each program loads its chunk
once and writes fp32 partials, and a one-program-a-row kernel merges them.

Forward (``csrc/instance_norm_triton.py``): ``instance_norm_moments``
writes each chunk's mean and centred M2, taken exactly from registers (no
raw sum of squares); ``instance_norm_stats`` merges a row's partials by
Chan's formula into (mean, rstd); ``instance_norm_apply`` writes
``act((x - mean) rstd + residual)``. Backward: the gate ``g = dy`` (times
``slope`` where the saved output is not positive: LeakyReLU keeps the sign,
so the sign of the output is the sign of its input), xhat recomputed in
fp32 from x and the saved statistics; ``instance_norm_bwd_sums`` writes
each chunk's sums of g and g xhat, ``instance_norm_bwd_stats`` adds a row's,
and ``instance_norm_bwd_apply`` writes ``dx = rstd (g - mean(g) - xhat
mean(g xhat))`` and ``dresidual = g``. The saved output is the next conv's
input, which that conv keeps for its weight gradient anyway. The scratch
comes from ``torch.empty``, the launches go on the current stream and none
reads back to the host, so a CUDA graph captures the op.

:func:`instance_norm_act` takes contiguous (B, C, D, H, W) input and raises
on anything else. On a CPU tensor it runs the plain version: the same two
passes in PyTorch (per-chunk partials merged by Chan's formula, the same
closed-form backward) inside the same ``torch.autograd.Function``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch.ops import _build

EPS = 1e-5
MIN_CHUNK = 256  # a row's smallest chunk: one program a row at 6^3 (216 elements)
MAX_CHUNK = 8192  # 32 elements a thread at 8 warps
STATS_BLOCK = 1024  # partials a merging program reads at a time
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def chunking(s: int) -> tuple[int, int]:
    """(elements a chunk, chunks a row) for rows of ``s`` elements."""
    chunk = min(max(1 << (s - 1).bit_length(), MIN_CHUNK), MAX_CHUNK)
    return chunk, -(-s // chunk)


# ---- the plain version ----------------------------------------------------------


def _rows(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, C, ...) -> (B * C, S) in ``dtype``."""
    return t.reshape(t.shape[0] * t.shape[1], -1).to(dtype)


def _chunks(v: torch.Tensor, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, S) -> (rows, n_chunks, chunk), the ragged last chunk padded
    with zeros, and each chunk's element count."""
    s = v.shape[1]
    n = -(-s // chunk)
    counts = (s - chunk * torch.arange(n, device=v.device)).clamp(max=chunk)
    return F.pad(v, (0, n * chunk - s)).view(v.shape[0], n, chunk), counts.to(v.dtype)


def plain_stats(x: torch.Tensor) -> torch.Tensor:
    """(rows, 2): each row's mean and rstd, from per-chunk means and centred
    M2 merged by Chan's formula."""
    v = _rows(x, torch.promote_types(x.dtype, torch.float32))
    s = v.shape[1]
    chunk, _ = chunking(s)
    blocks, counts = _chunks(v, chunk)
    means = blocks.sum(-1) / counts
    real = torch.arange(chunk, device=v.device) < counts[:, None]
    m2 = ((blocks - means[..., None]) * real).square().sum(-1)
    mean = (counts * means).sum(-1) / s
    var = (m2 + counts * (means - mean[:, None]).square()).sum(-1) / s
    return torch.stack([mean, torch.rsqrt(var + EPS)], 1)


def plain_forward(x, residual, slope, stats) -> torch.Tensor:
    v = _rows(x, stats.dtype)
    z = (v - stats[:, :1]) * stats[:, 1:]
    if residual is not None:
        z = z + _rows(residual, stats.dtype)
    if slope is not None:
        z = torch.where(z > 0, z, z * slope)
    return z.to(x.dtype).view(x.shape)


def plain_backward(x, out, dy, stats, slope) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, g in the working dtype): per-chunk sums of g and
    g xhat, added per row."""
    g = _rows(dy, stats.dtype)
    if slope is not None:
        g = torch.where(_rows(out, out.dtype) > 0, g, g * slope)
    rstd = stats[:, 1:]
    xhat = (_rows(x, stats.dtype) - stats[:, :1]) * rstd
    chunk, _ = chunking(g.shape[1])
    mean_g, mean_gx = (_chunks(t, chunk)[0].sum(-1).sum(-1, keepdim=True) / g.shape[1]
                       for t in (g, g * xhat))
    dx = rstd * (g - mean_g - xhat * mean_gx)
    return dx.to(x.dtype).view(x.shape), g.view(x.shape)


# ---- the kernels ----------------------------------------------------------------

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "instance_norm_triton.py"
_kernels_module = None


def _kernels():
    """``csrc/instance_norm_triton.py``, loaded once, at the first call on
    the card (it imports triton)."""
    global _kernels_module
    if _kernels_module is None:
        spec = importlib.util.spec_from_file_location("mmseg_instance_norm_triton", KERNEL_SOURCE)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
        _kernels_module = module
    return _kernels_module


def _grid(x: torch.Tensor) -> tuple[int, int, int, int, int]:
    """(rows, S, chunk, n_chunks, warps): 32 elements a thread, 1 to 8 warps."""
    rows, s = x.shape[0] * x.shape[1], x[0, 0].numel()
    chunk, n = chunking(s)
    return rows, s, chunk, n, max(1, min(8, chunk // 1024))


def _launch(kernel, grid, *args, **kw) -> None:
    kernel[grid](*args, **kw)
    _build.count(instance_norm_act)


def kernel_forward(x, residual, slope) -> tuple[torch.Tensor, torch.Tensor]:
    ks = _kernels()
    rows, s, chunk, n, warps = _grid(x)
    part = torch.empty(2 * rows * n, dtype=torch.float32, device=x.device)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    _launch(ks.instance_norm_moments, (rows * n,), x, part, s, n, rows * n, CHUNK=chunk,
            num_warps=warps)
    _launch(ks.instance_norm_stats, (rows,), part, stats, s, n, rows * n, EPS, CHUNK=chunk,
            BLOCK=STATS_BLOCK, num_warps=4)
    _launch(ks.instance_norm_apply, (rows * n,), x, x if residual is None else residual, out,
            stats, s, n, 0.0 if slope is None else slope, CHUNK=chunk,
            HAS_RES=residual is not None, ACT=slope is not None, num_warps=warps)
    return out, stats


def kernel_backward(x, out, dy, stats, slope, need_res) -> tuple[torch.Tensor, torch.Tensor]:
    ks = _kernels()
    rows, s, chunk, n, warps = _grid(x)
    part = torch.empty(2 * rows * n, dtype=torch.float32, device=x.device)
    gstats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if need_res else None
    act = slope is not None
    slope = 0.0 if slope is None else slope
    out = x if out is None else out
    _launch(ks.instance_norm_bwd_sums, (rows * n,), x, out, dy, stats, part, s, n, rows * n,
            slope, CHUNK=chunk, ACT=act, num_warps=warps)
    _launch(ks.instance_norm_bwd_stats, (rows,), part, gstats, s, n, rows * n,
            BLOCK=STATS_BLOCK, num_warps=4)
    _launch(ks.instance_norm_bwd_apply, (rows * n,), x, out, dy, stats, gstats, dx,
            dx if dres is None else dres, s, n, slope, CHUNK=chunk, ACT=act,
            HAS_RES=need_res, num_warps=warps)
    return dx, dres


class _InstanceNormAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, residual, slope):
        if x.is_cuda:
            out, stats = kernel_forward(x, residual, slope)
        else:
            stats = plain_stats(x)
            out = plain_forward(x, residual, slope, stats)
        ctx.slope = slope
        ctx.save_for_backward(x, out if slope is not None else None, stats)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, out, stats = ctx.saved_tensors
        dy = dy.contiguous()
        need_res = ctx.needs_input_grad[1]
        if x.is_cuda:
            dx, dres = kernel_backward(x, out, dy, stats, ctx.slope, need_res)
        else:
            dx, g = plain_backward(x, out, dy, stats, ctx.slope)
            dres = g.to(dy.dtype) if need_res else None
        return dx, dres, None


def check(x: torch.Tensor, residual: torch.Tensor | None) -> None:
    """Raise unless x is a contiguous (B, C, D, H, W) tensor, of a dtype the
    kernels take on CUDA, and the residual matches it."""
    name = "instance_norm_act"
    if x.dim() != 5:
        raise ValueError(f"{name}: takes (B, C, D, H, W), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: takes a contiguous channels-first x")
    if x.is_cuda and x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the CUDA kernels take {KERNEL_DTYPES}, got {x.dtype}")
    if residual is not None:
        if (residual.shape, residual.dtype, residual.device) != (x.shape, x.dtype, x.device):
            raise ValueError(f"{name}: the residual {tuple(residual.shape)} {residual.dtype} on "
                             f"{residual.device} does not match x {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
        if not residual.is_contiguous():
            raise ValueError(f"{name}: takes a contiguous residual")


def instance_norm_act(x: torch.Tensor, residual: torch.Tensor | None = None,
                      slope: float | None = None) -> torch.Tensor:
    """``act(IN(x) + residual)`` for x (B, C, D, H, W): IN with no affine,
    per sample and channel, biased variance, eps 1e-5; ``act`` LeakyReLU
    (``slope``) or, with ``slope`` None, the identity. In x's dtype,
    differentiable in x and ``residual``."""
    check(x, residual)
    return _InstanceNormAct.apply(x, residual, slope)


instance_norm_act.launches = 0  # kernel launches from the host, forward and backward
