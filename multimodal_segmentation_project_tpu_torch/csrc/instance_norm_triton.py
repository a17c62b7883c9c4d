"""Triton kernels of the InstanceNorm with the residual block's tail
(``ops/instance_norm.py``).

This file is kernel source, as the ``.cu`` files beside it are: it imports
``triton`` at its top, so it is not a module of the package, and
``ops/instance_norm.py`` loads it at its first call on the card. Every
function's name starts with ``instance_norm``, so that a device trace finds
the kernels. ``ops/instance_norm.py``'s docstring gives the design.

Each (sample, channel) row holds S contiguous elements and is cut into
chunks of CHUNK elements, the last one ragged; program ``pid`` of a
row-and-chunk grid takes chunk ``pid % n_chunks`` of row ``pid //
n_chunks``, so neighbouring programs read neighbouring memory, and its
partials sit at ``pid`` of each (rows * n_chunks) half of the scratch.
"""

from __future__ import annotations

import triton
import triton.language as tl


@triton.jit
def instance_norm_chunk(pid, S, n_chunks, CHUNK: tl.constexpr):
    """This program's row, the offsets of its chunk's elements in the
    volume, their mask and the chunk's element count."""
    row = pid // n_chunks
    start = (pid - row * n_chunks) * CHUNK
    cols = start + tl.arange(0, CHUNK)
    mask = cols < S
    return row, row.to(tl.int64) * S + cols, mask, tl.minimum(S - start, CHUNK)


@triton.jit
def instance_norm_gate(dy, out, at, mask, slope, ACT: tl.constexpr):
    """g = dy, through the LeakyReLU's gate where ACT: the sign of the
    saved output is the sign of its input. 0 off the mask."""
    g = tl.load(dy + at, mask=mask, other=0.0).to(tl.float32)
    if ACT:
        g = tl.where(tl.load(out + at, mask=mask, other=0.0) > 0, g, g * slope)
    return g


@triton.jit(do_not_specialize=["n_chunks"])
def instance_norm_moments(x, part, S, n_chunks, n_parts, CHUNK: tl.constexpr):
    """Forward pass 1: each chunk's mean and centred M2, from registers."""
    pid = tl.program_id(0)
    row, at, mask, n = instance_norm_chunk(pid, S, n_chunks, CHUNK)
    v = tl.load(x + at, mask=mask, other=0.0).to(tl.float32)
    mean = tl.sum(v, axis=0) / n.to(tl.float32)
    d = tl.where(mask, v - mean, 0.0)
    tl.store(part + pid, mean)
    tl.store(part + n_parts + pid, tl.sum(d * d, axis=0))


@triton.jit(do_not_specialize=["S", "n_chunks", "n_parts"])
def instance_norm_stats(part, stats, S, n_chunks, n_parts, eps, CHUNK: tl.constexpr,
                        BLOCK: tl.constexpr):
    """A row's partials merged by Chan's formula: mean = sum n_i m_i / S,
    M2 = sum M2_i + n_i (m_i - mean)^2; stores (mean, rstd)."""
    row = tl.program_id(0)
    base = part + row * n_chunks
    acc = tl.zeros((BLOCK,), tl.float32)
    for first in range(0, n_chunks, BLOCK):
        i = first + tl.arange(0, BLOCK)
        m = i < n_chunks
        cnt = tl.where(m, tl.minimum(S - i * CHUNK, CHUNK), 0).to(tl.float32)
        acc += cnt * tl.load(base + i, mask=m, other=0.0)
    mean = tl.sum(acc, axis=0) / S
    acc = tl.zeros((BLOCK,), tl.float32)
    for first in range(0, n_chunks, BLOCK):
        i = first + tl.arange(0, BLOCK)
        m = i < n_chunks
        cnt = tl.where(m, tl.minimum(S - i * CHUNK, CHUNK), 0).to(tl.float32)
        d = tl.load(base + i, mask=m, other=0.0) - mean
        acc += tl.load(base + n_parts + i, mask=m, other=0.0) + cnt * d * d
    var = tl.sum(acc, axis=0) / S
    tl.store(stats + 2 * row, mean)
    tl.store(stats + 2 * row + 1, 1.0 / tl.sqrt(var + eps))


@triton.jit(do_not_specialize=["n_chunks"])
def instance_norm_apply(x, res, out, stats, S, n_chunks, slope, CHUNK: tl.constexpr,
                        HAS_RES: tl.constexpr, ACT: tl.constexpr):
    """Forward pass 2: out = act((x - mean) * rstd + res), one rounding."""
    row, at, mask, _ = instance_norm_chunk(tl.program_id(0), S, n_chunks, CHUNK)
    mean = tl.load(stats + 2 * row)
    rstd = tl.load(stats + 2 * row + 1)
    z = (tl.load(x + at, mask=mask, other=0.0).to(tl.float32) - mean) * rstd
    if HAS_RES:
        z += tl.load(res + at, mask=mask, other=0.0).to(tl.float32)
    if ACT:
        z = tl.where(z > 0, z, z * slope)
    tl.store(out + at, z.to(out.dtype.element_ty), mask=mask)


@triton.jit(do_not_specialize=["n_chunks"])
def instance_norm_bwd_sums(x, out, dy, stats, part, S, n_chunks, n_parts, slope,
                           CHUNK: tl.constexpr, ACT: tl.constexpr):
    """Backward pass 1: each chunk's sums of g and of g * xhat, xhat
    recomputed in fp32 from x and the saved statistics."""
    pid = tl.program_id(0)
    row, at, mask, _ = instance_norm_chunk(pid, S, n_chunks, CHUNK)
    g = instance_norm_gate(dy, out, at, mask, slope, ACT)
    xhat = (tl.load(x + at, mask=mask, other=0.0).to(tl.float32)
            - tl.load(stats + 2 * row)) * tl.load(stats + 2 * row + 1)
    tl.store(part + pid, tl.sum(g, axis=0))
    tl.store(part + n_parts + pid, tl.sum(g * xhat, axis=0))


@triton.jit(do_not_specialize=["S", "n_chunks", "n_parts"])
def instance_norm_bwd_stats(part, gstats, S, n_chunks, n_parts, BLOCK: tl.constexpr):
    """A row's partial sums added: (mean of g, mean of g * xhat)."""
    row = tl.program_id(0)
    base = part + row * n_chunks
    sg = tl.zeros((BLOCK,), tl.float32)
    sgx = tl.zeros((BLOCK,), tl.float32)
    for first in range(0, n_chunks, BLOCK):
        i = first + tl.arange(0, BLOCK)
        m = i < n_chunks
        sg += tl.load(base + i, mask=m, other=0.0)
        sgx += tl.load(base + n_parts + i, mask=m, other=0.0)
    tl.store(gstats + 2 * row, tl.sum(sg, axis=0) / S)
    tl.store(gstats + 2 * row + 1, tl.sum(sgx, axis=0) / S)


@triton.jit(do_not_specialize=["n_chunks"])
def instance_norm_bwd_apply(x, out, dy, stats, gstats, dx, dres, S, n_chunks, slope,
                            CHUNK: tl.constexpr, ACT: tl.constexpr, HAS_RES: tl.constexpr):
    """Backward pass 2: dx = rstd (g - mean(g) - xhat mean(g xhat)), and
    dres = g where the residual takes a gradient."""
    row, at, mask, _ = instance_norm_chunk(tl.program_id(0), S, n_chunks, CHUNK)
    rstd = tl.load(stats + 2 * row + 1)
    g = instance_norm_gate(dy, out, at, mask, slope, ACT)
    xhat = (tl.load(x + at, mask=mask, other=0.0).to(tl.float32) - tl.load(stats + 2 * row)) * rstd
    d = rstd * (g - tl.load(gstats + 2 * row) - xhat * tl.load(gstats + 2 * row + 1))
    tl.store(dx + at, d.to(dx.dtype.element_ty), mask=mask)
    if HAS_RES:
        tl.store(dres + at, g.to(dres.dtype.element_ty), mask=mask)
