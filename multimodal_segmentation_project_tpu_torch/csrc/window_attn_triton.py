"""Triton kernels of the shifted-window attention (``ops/window_attn.py``).

This file is kernel source, as the ``.cu`` files beside it are: it imports
``triton`` at its top, so it is not a module of the package, and
``ops/window_attn.py`` loads it at its first call on the card. Every
function's name starts with ``window_attn``, so that a device trace finds
the kernels. ``ops/window_attn.py``'s docstring gives the design.
"""

from __future__ import annotations

import triton
import triton.language as tl

# the shape arguments, which change from call to call: not specialised on
_DIMS = ("n", "D", "H", "W", "Pd", "Ph", "Pw", "nWh", "nWw", "per_b", "wd", "wh", "ww",
         "sd", "sh", "sw", "C", "heads")


@triton.jit
def window_attn_tokens(wid, t, n, D, H, W, Pd, Ph, Pw, nWh, nWw, per_b, wd, wh, ww, sd, sh, sw):
    """For window ``wid`` and in-window tokens ``t``: whether each is a real
    token, its row in the token layout, and its shift region."""
    bb = wid // per_b
    r = wid % per_b
    pd = (r // (nWh * nWw)) * wd + t // (wh * ww)
    ph = ((r // nWw) % nWh) * wh + (t // ww) % wh
    pw = (r % nWw) * ww + t % ww
    od = (pd + sd) % Pd
    oh = (ph + sh) % Ph
    ow = (pw + sw) % Pw
    real = (t < n) & (od < D) & (oh < H) & (ow < W)
    row = ((bb * D + od) * H + oh).to(tl.int64) * W + ow
    rd = tl.where(sd > 0, (pd >= Pd - wd).to(tl.int32) + (pd >= Pd - sd).to(tl.int32), 0)
    rh = tl.where(sh > 0, (ph >= Ph - wh).to(tl.int32) + (ph >= Ph - sh).to(tl.int32), 0)
    rw = tl.where(sw > 0, (pw >= Pw - ww).to(tl.int32) + (pw >= Pw - sw).to(tl.int32), 0)
    return real, row, rd * 9 + rh * 3 + rw


@triton.jit
def window_attn_scores(q, k, relb, rows, cols, reg_q, reg_k, n, scale, SHIFTED: tl.constexpr):
    """fp32 scores of a (64, 64) tile: q k^T * scale + B + M, -inf on keys
    past the window."""
    s = tl.dot(q, tl.trans(k)) * scale
    s += tl.load(relb + rows[:, None] * n + cols[None, :],
                 mask=(rows < n)[:, None] & (cols < n)[None, :], other=0.0)
    if SHIFTED:
        s += tl.where(reg_q[:, None] != reg_k[None, :], -100.0, 0.0)
    return tl.where((cols < n)[None, :], s, float("-inf"))


@triton.jit(do_not_specialize=_DIMS)
def window_attn_fwd(qkv, bias, relb, out, lse, n, D, H, W, Pd, Ph, Pw, nWh, nWw, per_b,
                    wd, wh, ww, sd, sh, sw, C, heads, scale,
                    HD: tl.constexpr, BLOCK: tl.constexpr, NB: tl.constexpr,
                    SHIFTED: tl.constexpr):
    wid = tl.program_id(0)
    h = tl.program_id(1)
    rows = tl.program_id(2) * BLOCK + tl.arange(0, BLOCK)
    e = tl.arange(0, HD)
    real_q, row_q, reg_q = window_attn_tokens(wid, rows, n, D, H, W, Pd, Ph, Pw, nWh, nWw, per_b,
                                              wd, wh, ww, sd, sh, sw)
    hoff = h * HD + e
    q = tl.load(qkv + row_q[:, None] * (3 * C) + hoff[None, :], mask=real_q[:, None], other=0.0)
    q = tl.where(real_q[:, None], q, tl.load(bias + hoff)[None, :])
    bk = tl.load(bias + C + hoff)
    bv = tl.load(bias + 2 * C + hoff)
    relb_h = relb + h * n * n
    m_i = tl.full((BLOCK,), float("-inf"), tl.float32)
    l_i = tl.zeros((BLOCK,), tl.float32)
    acc = tl.zeros((BLOCK, HD), tl.float32)
    for kb in range(NB):
        cols = kb * BLOCK + tl.arange(0, BLOCK)
        real_k, row_k, reg_k = window_attn_tokens(wid, cols, n, D, H, W, Pd, Ph, Pw, nWh, nWw,
                                                  per_b, wd, wh, ww, sd, sh, sw)
        kv = qkv + row_k[:, None] * (3 * C) + hoff[None, :]
        k = tl.where(real_k[:, None], tl.load(kv + C, mask=real_k[:, None], other=0.0),
                     bk[None, :])
        v = tl.where(real_k[:, None], tl.load(kv + 2 * C, mask=real_k[:, None], other=0.0),
                     bv[None, :])
        s = window_attn_scores(q, k, relb_h, rows, cols, reg_q, reg_k, n, scale, SHIFTED)
        m_new = tl.maximum(m_i, tl.max(s, 1))
        p = tl.exp(s - m_new[:, None])
        alpha = tl.exp(m_i - m_new)
        l_i = l_i * alpha + tl.sum(p, 1)
        acc = acc * alpha[:, None] + tl.dot(p.to(tl.bfloat16), v)
        m_i = m_new
    o = acc / l_i[:, None]
    tl.store(out + row_q[:, None] * C + hoff[None, :], o.to(tl.bfloat16), mask=real_q[:, None])
    tl.store(lse + (wid * heads + h) * (NB * BLOCK) + rows, m_i + tl.log(l_i))


@triton.jit
def window_attn_load_rows(qkv, bias, dout, lse, delta, wid, rows, real_q, row_q, C, heads, h,
                          hoff, HD: tl.constexpr, BLOCK: tl.constexpr, NB: tl.constexpr):
    """A query block's q, dO, log-sum-exp and rowsum(dO * O); a padded
    query's dO and rowsum are 0, so its row of dS is 0."""
    q = tl.load(qkv + row_q[:, None] * (3 * C) + hoff[None, :], mask=real_q[:, None], other=0.0)
    q = tl.where(real_q[:, None], q, tl.load(bias + hoff)[None, :])
    do = tl.load(dout + row_q[:, None] * C + hoff[None, :], mask=real_q[:, None], other=0.0)
    m = tl.load(lse + (wid * heads + h) * (NB * BLOCK) + rows)
    dl = tl.load(delta + row_q * heads + h, mask=real_q, other=0.0)
    return q, do, m, dl


@triton.jit
def window_attn_load_keys(qkv, bias, row_k, real_k, C, hoff):
    kv = qkv + row_k[:, None] * (3 * C) + hoff[None, :]
    k = tl.where(real_k[:, None], tl.load(kv + C, mask=real_k[:, None], other=0.0),
                 tl.load(bias + C + hoff)[None, :])
    v = tl.where(real_k[:, None], tl.load(kv + 2 * C, mask=real_k[:, None], other=0.0),
                 tl.load(bias + 2 * C + hoff)[None, :])
    return k, v


@triton.jit(do_not_specialize=_DIMS)
def window_attn_bwd_dkv(qkv, bias, relb, dout, lse, delta, dqkv, dpad, n, D, H, W, Pd, Ph, Pw,
                        nWh, nWw, per_b, wd, wh, ww, sd, sh, sw, C, heads, scale,
                        HD: tl.constexpr, BLOCK: tl.constexpr, NB: tl.constexpr,
                        SHIFTED: tl.constexpr):
    wid = tl.program_id(0)
    h = tl.program_id(1)
    kb = tl.program_id(2)
    e = tl.arange(0, HD)
    hoff = h * HD + e
    cols = kb * BLOCK + tl.arange(0, BLOCK)
    real_k, row_k, reg_k = window_attn_tokens(wid, cols, n, D, H, W, Pd, Ph, Pw, nWh, nWw, per_b,
                                              wd, wh, ww, sd, sh, sw)
    k, v = window_attn_load_keys(qkv, bias, row_k, real_k, C, hoff)
    relb_h = relb + h * n * n
    dk = tl.zeros((BLOCK, HD), tl.float32)
    dv = tl.zeros((BLOCK, HD), tl.float32)
    for qb in range(NB):
        rows = qb * BLOCK + tl.arange(0, BLOCK)
        real_q, row_q, reg_q = window_attn_tokens(wid, rows, n, D, H, W, Pd, Ph, Pw, nWh, nWw,
                                                  per_b, wd, wh, ww, sd, sh, sw)
        q, do, m, dl = window_attn_load_rows(qkv, bias, dout, lse, delta, wid, rows, real_q, row_q,
                                             C, heads, h, hoff, HD, BLOCK, NB)
        s = window_attn_scores(q, k, relb_h, rows, cols, reg_q, reg_k, n, scale, SHIFTED)
        p = tl.exp(s - m[:, None])
        dv += tl.dot(tl.trans(p.to(tl.bfloat16)), do)
        ds = p * (tl.dot(do, tl.trans(v)) - dl[:, None])
        dk += tl.dot(tl.trans(ds.to(tl.bfloat16)), q)
    dk = dk * scale
    out = dqkv + row_k[:, None] * (3 * C) + hoff[None, :]
    tl.store(out + C, dk.to(tl.bfloat16), mask=real_k[:, None])
    tl.store(out + 2 * C, dv.to(tl.bfloat16), mask=real_k[:, None])
    pad = ((cols < n) & ~real_k)[:, None]
    base = dpad + ((wid * heads + h) * NB + kb) * 2 * HD + e
    tl.store(base, tl.sum(tl.where(pad, dk, 0.0), 0))
    tl.store(base + HD, tl.sum(tl.where(pad, dv, 0.0), 0))


@triton.jit(do_not_specialize=_DIMS + ("n_windows", "group"))
def window_attn_bwd_dq(qkv, bias, relb, dout, lse, delta, dqkv, dq32, dtab, n_windows, group,
                       n, D, H, W, Pd, Ph, Pw, nWh, nWw, per_b, wd, wh, ww, sd, sh, sw, C, heads,
                       scale, HD: tl.constexpr, BLOCK: tl.constexpr, NB: tl.constexpr,
                       SHIFTED: tl.constexpr):
    g = tl.program_id(0)
    h = tl.program_id(1)
    qb = tl.program_id(2)
    e = tl.arange(0, HD)
    hoff = h * HD + e
    rows = qb * BLOCK + tl.arange(0, BLOCK)
    relb_h = relb + h * n * n
    first = g * group
    count = tl.minimum(group, n_windows - first)
    for kb in range(NB):
        cols = kb * BLOCK + tl.arange(0, BLOCK)
        dsum = tl.zeros((BLOCK, BLOCK), tl.float32)
        for i in range(0, count):
            wid = first + i
            real_q, row_q, reg_q = window_attn_tokens(wid, rows, n, D, H, W, Pd, Ph, Pw, nWh,
                                                      nWw, per_b, wd, wh, ww, sd, sh, sw)
            real_k, row_k, reg_k = window_attn_tokens(wid, cols, n, D, H, W, Pd, Ph, Pw, nWh,
                                                      nWw, per_b, wd, wh, ww, sd, sh, sw)
            q, do, m, dl = window_attn_load_rows(qkv, bias, dout, lse, delta, wid, rows, real_q,
                                                 row_q, C, heads, h, hoff, HD, BLOCK, NB)
            k, v = window_attn_load_keys(qkv, bias, row_k, real_k, C, hoff)
            s = window_attn_scores(q, k, relb_h, rows, cols, reg_q, reg_k, n, scale, SHIFTED)
            p = tl.exp(s - m[:, None])
            ds = p * (tl.dot(do, tl.trans(v)) - dl[:, None])
            dsum += ds
            dq = tl.dot(ds.to(tl.bfloat16), k) * scale
            scratch = dq32 + row_q[:, None] * C + hoff[None, :]
            if kb > 0:
                dq += tl.load(scratch, mask=real_q[:, None], other=0.0)
            if kb == NB - 1:
                tl.store(dqkv + row_q[:, None] * (3 * C) + hoff[None, :], dq.to(tl.bfloat16),
                         mask=real_q[:, None])
            else:
                tl.store(scratch, dq, mask=real_q[:, None])
        tile = dtab + ((g * heads + h) * (NB * BLOCK) + rows[:, None]) * (NB * BLOCK) + cols[None, :]
        tl.store(tile, dsum)
