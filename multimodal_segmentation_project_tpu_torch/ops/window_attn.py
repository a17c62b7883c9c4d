"""Shifted-window multi-head attention of a Swin block, on the qkv Linear's
output in token layout, with its backward.

SwinUNETR's W-MSA (``models/swin_unetr.py``; MONAI's ``WindowAttention``
inside ``SwinTransformerBlock.forward_part1``) pads the LayerNorm's output
with zeros up to a multiple of the window, rolls it by -shift, cuts it into
windows of n = wd * wh * ww tokens, and in each window and head computes

    softmax(q k^T * hd^-0.5 + B[h, idx(i, j)] + M) v

where B is the (13^3, heads) relative-position table, indexed as MONAI's
``relative_position_index`` (built on the 7^3 window and cut to [:n, :n]),
and M is -100 between tokens of different shift regions (regions per axis
[0, P - w), [P - w, P - s), [P - s, P) of the padded size P, on the shifted
axes only) and 0 elsewhere or in an unshifted block. The output is put back,
rolled by +shift and cropped. Padded tokens are zeros after the LayerNorm,
so their keys and values are the qkv Linear's bias, and they take part in
the attention; their queries' outputs are cropped.

:func:`window_attention` takes qkv (B, D, H, W, 3C), the Linear's output on
the real tokens alone, channels ordered (q|k|v, head, hd), and returns
(B, D, H, W, C), channels (head, hd), ready for the output projection. On a
CPU tensor it runs :func:`window_attention_reference`, the plain
composition (pad, roll, partition, scores, mask, softmax, reverse), which
autograd differentiates. On a CUDA tensor it runs three Triton kernels of
``csrc/window_attn_triton.py``, loaded and compiled at first use (``triton``
is imported there, never when this module is): ``window_attn_fwd``, and for
the backward ``window_attn_bwd_dq`` and ``window_attn_bwd_dkv``. It takes
bf16 and head dim 16 only, and a window of at most 7^3 tokens; anything else
on CUDA raises.

The kernels replace no TPU kernel: the JAX package has no attention. What
bounds them is bytes. Composed, the scores (343^2 a window and head) are
written and read about 8 times a forward (the bias, the mask, the softmax,
its saved output); at stage 1 of a 192^3 volume that is 0.97 G scores a
block. The kernels read q, k and v once from the Linear's output, with the
pad, the roll and the partition folded into their index arithmetic (a
window's token t maps to a padded, shifted position and back to a real
token, or to the bias), add B from a dense (heads, n, n) table gathered once
a call and M from region ids, take the softmax in fp32 online over 64-key
blocks (flash attention), and write the output in token layout; the
forward keeps each query row's log-sum-exp for the backward. The backward
recomputes the probabilities: ``window_attn_bwd_dkv`` (a window, a head, a
64-key block) sums dK and dV over the query blocks, writes the real tokens'
rows and sums the padded tokens' into the bias's gradient;
``window_attn_bwd_dq`` (a group of windows, a head, a 64-query block) sums
dQ over the key blocks in an fp32 scratch the program alone owns, and adds
dS over its group's windows into one (64, 64) tile per key block: the
table's gradient is those partial sums, one per group, reduced once by
torch and scattered onto the table. No atomic is taken.
"""

from __future__ import annotations

import importlib.util
import math
import sys
from pathlib import Path

import torch

HEAD_DIM = 16  # the kernels' head dim (SwinUNETR at feature size 48: 48/3 = 96/6 = ... = 16)
MAX_WINDOW = 7  # the kernels' largest window side (343 tokens, six 64-token blocks)
BLOCK = 64  # query and key rows a block
MASK_VALUE = -100.0  # MONAI's compute_mask
PARTIAL_TILES = 768  # the table gradient's partial sums: groups x heads at most
NUM_WARPS = 4  # each kernel's warps a program

# ---- shapes, MONAI's window rules -----------------------------------------------


def window_and_shift(size, window: int, shift: int) -> tuple[tuple, tuple]:
    """MONAI's ``get_window_size``: per axis the window, clipped to the
    volume where the volume is no larger, and the shift, 0 there."""
    win = tuple(s if s <= window else window for s in size)
    sft = tuple(0 if s <= window else shift for s in size)
    return win, sft


def padded(size, window) -> tuple:
    return tuple(-(-s // w) * w for s, w in zip(size, window))


def relative_position_index(window: int = MAX_WINDOW) -> torch.Tensor:
    """MONAI's ``relative_position_index`` (window^3, window^3), int64."""
    c = torch.stack(torch.meshgrid(*[torch.arange(window)] * 3, indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (window - 1)
    side = 2 * window - 1
    return (rel[:, :, 0] * side + rel[:, :, 1]) * side + rel[:, :, 2]


def dense_bias(table: torch.Tensor, index: torch.Tensor, n: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """B[h, i, j] = table[index[i, j], h] for i, j < n: (heads, n, n)."""
    return table.to(dtype)[index[:n, :n].reshape(-1)].view(n, n, -1).permute(2, 0, 1)


def region_ids(pad, window, shift, device) -> torch.Tensor:
    """Each padded, shifted position's shift region, (Pd, Ph, Pw) int64:
    per shifted axis [0, P - w), [P - w, P - s), [P - s, P) as 0, 1, 2;
    an unshifted axis is one region."""
    ids = []
    for p, w, s in zip(pad, window, shift):
        r = torch.arange(p, device=device)
        ids.append(((r >= p - w).long() + (r >= p - s).long()) if s > 0 else torch.zeros_like(r))
    return (ids[0][:, None, None] * 9 + ids[1][None, :, None] * 3 + ids[2][None, None, :])


def _partition(x: torch.Tensor, window) -> torch.Tensor:
    """(B, Pd, Ph, Pw, C) -> (B * nW, n, C), MONAI's ``window_partition``."""
    b, d, h, w, c = x.shape
    wd, wh, ww = window
    x = x.view(b, d // wd, wd, h // wh, wh, w // ww, ww, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww, c)


def _reverse(windows: torch.Tensor, window, dims) -> torch.Tensor:
    """The inverse of :func:`_partition`: -> (B, Pd, Ph, Pw, C)."""
    b, d, h, w = dims
    wd, wh, ww = window
    x = windows.view(b, d // wd, h // wh, w // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


# ---- the plain version ----------------------------------------------------------


def window_attention_reference(qkv: torch.Tensor, qkv_bias: torch.Tensor, table: torch.Tensor,
                               index: torch.Tensor, heads: int, window, shift) -> torch.Tensor:
    """Plain version: the padded volume holds the bias where there is no
    token, then roll, partition, scores in fp32 (fp64 for an fp64 qkv),
    bias, mask, softmax, reverse, roll back, crop; one cast to qkv's dtype."""
    b, d, h, w, c3 = qkv.shape
    c = c3 // 3
    pad = padded((d, h, w), window)
    full = qkv_bias.to(qkv.dtype).expand(b, *pad, c3).clone()
    full[:, :d, :h, :w] = qkv
    shifted = any(s > 0 for s in shift)
    if shifted:
        full = torch.roll(full, tuple(-s for s in shift), (1, 2, 3))
    dtype = torch.promote_types(qkv.dtype, torch.float32)
    win = _partition(full, window).to(dtype)
    n = win.shape[1]
    q, k, v = win.view(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1) + dense_bias(table, index, n, dtype)
    if shifted:
        ids = _partition(region_ids(pad, window, shift, qkv.device)[None, ..., None], window)[..., 0]
        mask = torch.where(ids[:, :, None] != ids[:, None, :], MASK_VALUE, 0.0)  # (nW, n, n)
        attn = (attn.view(b, -1, heads, n, n) + mask[None, :, None]).view(-1, heads, n, n)
    out = (attn.softmax(-1) @ v).transpose(1, 2).reshape(-1, n, c)
    out = _reverse(out, window, (b, *pad))
    if shifted:
        out = torch.roll(out, tuple(shift), (1, 2, 3))
    return out[:, :d, :h, :w].to(qkv.dtype)


# ---- the kernels ----------------------------------------------------------------

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "window_attn_triton.py"
_kernels_module = None


def _kernels():
    """``csrc/window_attn_triton.py``, loaded once, at the first call on the
    card (it imports triton)."""
    global _kernels_module
    if _kernels_module is None:
        spec = importlib.util.spec_from_file_location("mmseg_window_attn_triton", KERNEL_SOURCE)
        module = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = module
        spec.loader.exec_module(module)
        _kernels_module = module
    return _kernels_module


class Geometry:
    """One call's windows: the volume, the (clipped) window and shift, the
    padded size and the windows' grid."""

    def __init__(self, qkv_shape, heads: int, window: int, shift: int):
        b, d, h, w, c3 = qkv_shape
        self.size, self.c, self.heads = (d, h, w), c3 // 3, heads
        self.window, self.shift = window_and_shift(self.size, window, shift)
        self.pad = padded(self.size, self.window)
        self.grid = tuple(p // s for p, s in zip(self.pad, self.window))
        self.n = math.prod(self.window)
        self.per_b = math.prod(self.grid)
        self.n_windows = b * self.per_b
        self.nb = -(-self.n // BLOCK)
        self.shifted = any(s > 0 for s in self.shift)

    def args(self) -> tuple:
        """The kernels' shape arguments, n through C and heads."""
        return (self.n, *self.size, *self.pad, self.grid[1], self.grid[2], self.per_b,
                *self.window, *self.shift, self.c, self.heads)

    def groups(self) -> tuple[int, int]:
        """(groups, windows a group) of the dq kernel: at most PARTIAL_TILES
        (group, head) tiles of the table's partial sums."""
        n_groups = max(1, min(self.n_windows, PARTIAL_TILES // self.heads))
        size = -(-self.n_windows // n_groups)
        return -(-self.n_windows // size), size


def check(qkv: torch.Tensor, heads: int, window: int) -> None:
    """Raise unless the kernels take qkv: bf16, contiguous, head dim 16, a
    window of at most MAX_WINDOW a side."""
    name = "window_attention"
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {qkv.dtype}")
    if qkv.dim() != 5 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"{name}: qkv {tuple(qkv.shape)} is not (B, D, H, W, 3 * heads * hd)")
    hd = qkv.shape[-1] // (3 * heads)
    if hd != HEAD_DIM:
        raise ValueError(f"{name}: the CUDA kernel takes head dim {HEAD_DIM}, got {hd}")
    if window > MAX_WINDOW:
        raise ValueError(f"{name}: the CUDA kernel takes a window of at most {MAX_WINDOW}^3, "
                         f"got {window}^3")
    if not qkv.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous qkv")


def _fwd(geo: Geometry, qkv, bias, relb):
    k = _kernels().window_attn_fwd
    out = torch.empty(qkv.shape[:4] + (geo.c,), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((geo.n_windows, geo.heads, geo.nb * BLOCK), dtype=torch.float32,
                      device=qkv.device)
    k[(geo.n_windows, geo.heads, geo.nb)](
        qkv, bias, relb, out, lse, *geo.args(), HEAD_DIM ** -0.5,
        HD=HEAD_DIM, BLOCK=BLOCK, NB=geo.nb, SHIFTED=geo.shifted, num_warps=NUM_WARPS)
    window_attention.launches += 1
    return out, lse


def _bwd(geo: Geometry, qkv, bias, relb, out, lse, dout):
    ks = _kernels()
    dout = dout.contiguous()
    delta = (dout.float() * out.float()).view(-1, geo.heads, HEAD_DIM).sum(-1).contiguous()
    dqkv = torch.empty_like(qkv)
    dpad = torch.empty((geo.n_windows, geo.heads, geo.nb, 2, HEAD_DIM), dtype=torch.float32,
                       device=qkv.device)
    scale = HEAD_DIM ** -0.5
    ks.window_attn_bwd_dkv[(geo.n_windows, geo.heads, geo.nb)](
        qkv, bias, relb, dout, lse, delta, dqkv, dpad, *geo.args(), scale,
        HD=HEAD_DIM, BLOCK=BLOCK, NB=geo.nb, SHIFTED=geo.shifted, num_warps=NUM_WARPS)
    n_groups, size = geo.groups()
    side = geo.nb * BLOCK
    dq32 = torch.empty(qkv.shape[:4] + (geo.c,), dtype=torch.float32, device=qkv.device)
    dtab = torch.empty((n_groups, geo.heads, side, side), dtype=torch.float32, device=qkv.device)
    ks.window_attn_bwd_dq[(n_groups, geo.heads, geo.nb)](
        qkv, bias, relb, dout, lse, delta, dqkv, dq32, dtab, geo.n_windows, size, *geo.args(),
        scale, HD=HEAD_DIM, BLOCK=BLOCK, NB=geo.nb, SHIFTED=geo.shifted, num_warps=NUM_WARPS)
    drelb = dtab.sum(0)[:, :geo.n, :geo.n]
    dkv = dpad.sum((0, 2)).permute(1, 0, 2).reshape(2, geo.c)  # (k|v, heads * hd)
    dbias = torch.cat([torch.zeros(geo.c, device=qkv.device), dkv.reshape(-1)])
    return dqkv, dbias, drelb


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, qkv_bias, table, index, heads, window, shift):
        geo = Geometry(qkv.shape, heads, window, shift)
        bias = qkv_bias.to(torch.bfloat16).contiguous()
        relb = dense_bias(table, index, geo.n).contiguous()
        out, lse = _fwd(geo, qkv, bias, relb)
        ctx.geo = geo
        ctx.save_for_backward(qkv, bias, relb, out, lse, index)
        ctx.dtypes = (qkv_bias.dtype, table.dtype, table.shape)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, relb, out, lse, index = ctx.saved_tensors
        geo = ctx.geo
        dqkv, dbias, drelb = _bwd(geo, qkv, bias, relb, out, lse, dout)
        bias_dtype, table_dtype, table_shape = ctx.dtypes
        dtable = torch.zeros(table_shape, dtype=torch.float32, device=qkv.device)
        dtable.index_add_(0, index[:geo.n, :geo.n].reshape(-1),
                          drelb.permute(1, 2, 0).reshape(geo.n * geo.n, -1))
        return dqkv, dbias.to(bias_dtype), dtable.to(table_dtype), None, None, None, None


def window_attention(qkv: torch.Tensor, qkv_bias: torch.Tensor, table: torch.Tensor,
                     index: torch.Tensor, heads: int, window: int, shift: int) -> torch.Tensor:
    """W-MSA (shift 0) or SW-MSA of a Swin block: qkv (B, D, H, W, 3C) from
    the qkv Linear on the real tokens, qkv_bias (3C,) that Linear's bias (the
    padded tokens' qkv), table (13^3, heads), index MONAI's relative position
    index -> (B, D, H, W, C) in qkv's dtype, differentiable. ``window`` and
    ``shift`` are the block's; each axis no larger than the window is
    clipped and unshifted, as MONAI does."""
    if qkv.device.type == "cpu":
        win, sft = window_and_shift(qkv.shape[1:4], window, shift)
        return window_attention_reference(qkv, qkv_bias, table, index, heads, win, sft)
    check(qkv, heads, window)
    return _WindowAttention.apply(qkv, qkv_bias, table, index, heads, window, shift)


window_attention.launches = 0  # forward kernel launches
