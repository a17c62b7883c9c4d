"""The fused training DoubleConv's convs: conv + BatchNorm statistics, and
the boundary conv whose input prologue applies the preceding BatchNorm,
ReLU and Dropout3d as one per-(batch, channel) affine.

Port of ``multimodal_segmentation_project_tpu/ops/pallas_conv.py``:

* :func:`conv3x3x3_cf_stats` -- ``conv3x3x3_cf_stats`` (conv0 of the fused
  DoubleConv): ``(y, s1, s2)`` with y = the conv plus the fp32 bias, cast
  once to the working dtype, and s1, s2 the per-channel fp32 sums of y and
  y**2 over batch and volume, of that rounded y. Backward: the statistics'
  cotangents fold into ``g_eff = g + gs1 + 2 y gs2`` (one elementwise torch
  pass, cast to g's dtype), then the training conv's dx and dW kernels
  (``ops.conv3``) and ``db = sum g_eff`` in fp32.
* :func:`conv3x3x3_cf_boundary_stats` -- ``conv3x3x3_cf_boundary_stats``
  (conv1): the same of ``z = relu(x a + t)``, a, t fp32 (B, Cin), z cast
  to x's dtype and the SAME halo kept 0 (relu(t) is not 0 where t > 0).
  Backward: the same ``g_eff``; dx, da, dt from the dx-epilogue kernel
  (:func:`conv3x3x3_cf_dx_epilogue`), dW from the prologue dW kernel
  (:func:`conv3x3x3_cf_dw_prologue`), ``db = sum g_eff``.
* :func:`conv3x3x3_cf_boundary` -- ``conv3x3x3_cf_boundary``: the conv of
  z, cast, then the bias added in the working dtype; no statistics.
  Backward: the same two kernels on g itself, ``db = sum g``.

On CUDA tensors each forward and backward launches its hand-written kernel:
in bf16 ``csrc/conv3.cu`` (the implicit-GEMM body with the prologue and the
stats and dx-mask epilogues) and ``csrc/conv3_dw.cu`` (dW with the
prologue); in fp32 the same instances of the fp32 bodies,
``csrc/conv3_f32.cu`` and ``csrc/conv3_dw_f32.cu``; any other dtype raises.
On CPU tensors each runs its ``*_reference``, the plain version of the same
arithmetic, rounded at the same points. One call builder per kernel picks
the body, the entry and the launch descriptor from the tensor's dtype. Each
counts its launches: in bf16 the three forwards on themselves, the backward
kernels on :func:`conv3x3x3_cf_dx_epilogue` and
:func:`conv3x3x3_cf_dw_prologue` (and, for :func:`conv3x3x3_cf_stats`, on
``ops.conv3``'s dx and dW); in fp32 on the counters of the same names with
``_f32`` (``conv3x3x3_cf_stats_f32``, ..., ``conv3x3x3_cf_dw_prologue_f32``;
``ops.conv3``'s fp32 dx and dW).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from multimodal_segmentation_project_tpu_torch.ops import _build, conv3

TD, TH, TW = 4, 8, 16  # the bf16 conv body's output tile (csrc/conv3_fwd_tile.cuh)


def _bc(v: torch.Tensor) -> torch.Tensor:
    """(B, C) or (C,) -> broadcast over (B, C, D, H, W)."""
    return v.reshape(*v.shape, 1, 1, 1) if v.dim() == 2 else v.reshape(1, -1, 1, 1, 1)


# ---- plain versions ---------------------------------------------------


def prologue_reference(x: torch.Tensor, a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """relu(x a + t) in fp32, cast to x's dtype: the boundary conv's input."""
    return torch.relu(x.float() * _bc(a.float()) + _bc(t.float())).to(x.dtype)


def conv3x3x3_cf_stats_reference(x, w, b):
    """Plain version of kernel 3: y = (conv + fp32 bias) cast once to x's
    dtype; s1, s2 the fp32 per-channel sums of y and y**2."""
    y = (conv3.conv_fp32(x, w) + _bc(b.float())).to(x.dtype)
    yf = y.float()
    return y, yf.sum(dim=(0, 2, 3, 4)), yf.square().sum(dim=(0, 2, 3, 4))


def conv3x3x3_cf_boundary_stats_reference(x, w, b, a, t):
    """Plain version of kernel 4: kernel 3 on relu(x a + t)."""
    return conv3x3x3_cf_stats_reference(prologue_reference(x, a, t), w, b)


def conv3x3x3_cf_boundary_reference(x, w, b, a, t):
    """Plain version of kernel 12: the training conv (cast, then the bias in
    x's dtype) of relu(x a + t)."""
    return conv3.conv3x3x3_cf_reference(prologue_reference(x, a, t), w, b)


def conv3x3x3_cf_dx_epilogue_reference(g, w, x, a, t):
    """Plain version of kernel 5: dr = the fp32 dx conv of g (B, Cout, ...)
    with w (3, 3, 3, Cin, Cout); du = dr where x a + t > 0, else 0 ->
    dy = du a in x's dtype, da = sum du x, dt = sum du, each (B, Cin) fp32."""
    dr = conv3.conv_fp32(g, conv3.flip_transpose(w))
    xf = x.float()
    du = torch.where(xf * _bc(a.float()) + _bc(t.float()) > 0, dr, 0.0)
    dy = (du * _bc(a.float())).to(x.dtype)
    return dy, (du * xf).sum(dim=(2, 3, 4)), du.sum(dim=(2, 3, 4))


def conv3x3x3_cf_dw_prologue_reference(x, g, a, t):
    """Plain version of kernel 6: the fp32 dW of the conv of relu(x a + t)."""
    return conv3.conv3x3x3_cf_dw_reference(prologue_reference(x, a, t), g)


# ---- kernels ----------------------------------------------------------


def conv_blocks(d: int, h: int, w: int, f32_cout: int | None = None) -> int:
    """Output tiles of a conv body per batch element, one partial of each
    channel sum each: the bf16 body's (a block each) or, given its Cout, the
    fp32 body's (conv3.f32_tile, walked by persistent blocks)."""
    td, th, tw = (TD, TH, TW) if f32_cout is None else conv3.f32_tile(f32_cout)
    return -(-d // td) * -(-h // th) * -(-w // tw)


def _affine(name: str, x: torch.Tensor, a: torch.Tensor, t: torch.Tensor, c: int):
    """a, t as the kernels take them: contiguous fp32 (B, C) on x's device."""
    out = []
    for label, v in (("a", a), ("t", t)):
        if tuple(v.shape) != (x.shape[0], c):
            raise ValueError(f"{name}: {label} {tuple(v.shape)} is not (B, C) = "
                             f"({x.shape[0]}, {c})")
        out.append(v.to(x.device, torch.float32).contiguous())
    return out


def _f32(t: torch.Tensor) -> bool:
    """Whether t goes to the fp32 bodies; any other dtype goes to the bf16
    ones, which refuse all but bf16."""
    return t.dtype == torch.float32


def _stats_call(name: str, x, w, b, a=None, t=None) -> conv3.Launch:
    """Kernel 3's (no a, t) or 4's call on CUDA tensors, on the body of x's
    dtype (the fp32 one with its launch descriptor); its result is
    (y, s1, s2)."""
    f32 = _f32(x)
    wk, bk, y = conv3.conv_operands(name, x, w, b, torch.float32 if f32 else torch.bfloat16)
    bsz, cin, d, h, wd = x.shape
    cout = y.shape[1]
    partial = torch.empty(2 * cout * bsz * conv_blocks(d, h, wd, cout if f32 else None),
                          dtype=torch.float32, device=x.device)
    stats = torch.empty((2, cout), dtype=torch.float32, device=x.device)
    dims = conv3.f32_launch_dims(x.device, tuple(x.shape), cout) if f32 else ()
    body = "mmseg_conv3_f32" if f32 else "mmseg_conv3"
    head = (x.data_ptr(), wk.data_ptr(), bk.data_ptr())
    tail = (y.data_ptr(), partial.data_ptr(), stats.data_ptr(), bsz, cin, cout, d, h, wd, *dims)
    tensors = (x, wk, bk, y, partial, stats)
    if a is None:
        return conv3.Launch(f"{body}_stats", head + tail, (y, stats[0], stats[1]), tensors)
    ak, tk = _affine(name, x, a, t, cin)
    return conv3.Launch(f"{body}_prologue_stats", head + (ak.data_ptr(), tk.data_ptr()) + tail,
                        (y, stats[0], stats[1]), tensors + (ak, tk))


def stats_call(x, w, b) -> conv3.Launch:
    """Kernel 3's call (conv3x3x3_cf_stats's forward)."""
    return _stats_call("conv3x3x3_cf_stats", x, w, b)


def boundary_stats_call(x, w, b, a, t) -> conv3.Launch:
    """Kernel 4's call (conv3x3x3_cf_boundary_stats's forward)."""
    return _stats_call("conv3x3x3_cf_boundary_stats", x, w, b, a, t)


def boundary_call(x, w, b, a, t) -> conv3.Launch:
    """Kernel 12's call (conv3x3x3_cf_boundary's forward) on CUDA tensors,
    on the body of x's dtype."""
    name, f32 = "conv3x3x3_cf_boundary", _f32(x)
    wk, bk, y = conv3.conv_operands(name, x, w, b, torch.float32 if f32 else torch.bfloat16)
    bsz, cin, d, h, wd = x.shape
    ak, tk = _affine(name, x, a, t, cin)
    dims = conv3.f32_launch_dims(x.device, tuple(x.shape), y.shape[1]) if f32 else ()
    args = (x.data_ptr(), wk.data_ptr(), bk.data_ptr(), ak.data_ptr(), tk.data_ptr(),
            y.data_ptr(), bsz, cin, y.shape[1], d, h, wd, *dims)
    return conv3.Launch("mmseg_conv3_f32_prologue" if f32 else "mmseg_conv3_prologue", args, y,
                        (x, wk, bk, ak, tk, y))


def dx_epilogue_call(g, w, x, a, t) -> conv3.Launch:
    """Kernel 5's call (conv3x3x3_cf_dx_epilogue) on CUDA tensors, on the
    body of g's dtype; its result is (dy, da, dt)."""
    name, f32 = "conv3x3x3_cf_dx_epilogue", _f32(g)
    dtype = torch.float32 if f32 else torch.bfloat16
    wt = conv3.flip_transpose(w)
    cx = conv3._check_conv(name, g, wt, dtype)
    _build.require(name, x, dtype, 5)
    bsz, cg, d, h, wd = g.shape
    if tuple(x.shape) != (bsz, cx, d, h, wd):
        raise ValueError(f"{name}: input {tuple(x.shape)} does not match the cotangent "
                         f"{tuple(g.shape)} and weights {tuple(w.shape)}")
    ak, tk = _affine(name, x, a, t, cx)
    wk = (conv3.pack_weights_f32 if f32 else conv3.pack_weights)(wt.to(g.device))
    dy = torch.empty_like(x)
    partial = torch.empty(2 * bsz * cx * conv_blocks(d, h, wd, cx if f32 else None),
                          dtype=torch.float32, device=g.device)
    dadt = torch.empty((2, bsz, cx), dtype=torch.float32, device=g.device)
    dims = conv3.f32_launch_dims(g.device, tuple(g.shape), cx) if f32 else ()
    args = (g.data_ptr(), wk.data_ptr(), x.data_ptr(), ak.data_ptr(), tk.data_ptr(),
            dy.data_ptr(), partial.data_ptr(), dadt.data_ptr(), bsz, cg, cx, d, h, wd, *dims)
    return conv3.Launch("mmseg_conv3_f32_dx_epilogue" if f32 else "mmseg_conv3_dx_epilogue",
                        args, (dy, dadt[0], dadt[1]), (g, wk, x, ak, tk, dy, partial, dadt))


def dw_prologue_call(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                     t: torch.Tensor) -> conv3.Launch:
    """Kernel 6's call (the boundary convs' dW) on CUDA tensors, on the dW
    body of x's dtype."""
    name, f32 = "conv3x3x3_cf_dw_prologue", _f32(x)
    partial, dw, args = (conv3.dw_f32_operands if f32 else conv3.dw_operands)(name, x, g)
    ak, tk = _affine(name, x, a, t, x.shape[1])
    args = (x.data_ptr(), g.data_ptr(), ak.data_ptr(), tk.data_ptr(), partial.data_ptr(),
            dw.data_ptr(), *args)
    return conv3.Launch("mmseg_conv3_dw_f32_prologue" if f32 else "mmseg_conv3_dw_prologue",
                        args, dw, (x, g, ak, tk, partial, dw))


# the launches of the fp32 instances, counted apart from bf16's (ops.KERNEL_OPS)
conv3x3x3_cf_stats_f32 = SimpleNamespace(launches=0)
conv3x3x3_cf_boundary_stats_f32 = SimpleNamespace(launches=0)
conv3x3x3_cf_boundary_f32 = SimpleNamespace(launches=0)
conv3x3x3_cf_dx_epilogue_f32 = SimpleNamespace(launches=0)
conv3x3x3_cf_dw_prologue_f32 = SimpleNamespace(launches=0)


def _run(name: str, call: conv3.Launch, t: torch.Tensor, op, op_f32):
    """Launch ``call`` on t's device; count it on op_f32 for an fp32 t,
    else on op."""
    out = conv3.run(name, call, t)
    (op_f32 if _f32(t) else op).launches += 1
    return out


def _conv_stats(x, w, b):
    """Kernel 3 without autograd; its launches count on conv3x3x3_cf_stats
    (fp32: conv3x3x3_cf_stats_f32)."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_stats_reference(x, w, b)
    return _run("conv3x3x3_cf_stats", stats_call(x, w, b), x, conv3x3x3_cf_stats,
                conv3x3x3_cf_stats_f32)


def _boundary_stats(x, w, b, a, t):
    """Kernel 4 without autograd; its launches count on
    conv3x3x3_cf_boundary_stats (fp32: conv3x3x3_cf_boundary_stats_f32)."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_boundary_stats_reference(x, w, b, a, t)
    return _run("conv3x3x3_cf_boundary_stats", boundary_stats_call(x, w, b, a, t), x,
                conv3x3x3_cf_boundary_stats, conv3x3x3_cf_boundary_stats_f32)


def _boundary(x, w, b, a, t):
    """Kernel 12 without autograd; its launches count on
    conv3x3x3_cf_boundary (fp32: conv3x3x3_cf_boundary_f32)."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_boundary_reference(x, w, b, a, t)
    return _run("conv3x3x3_cf_boundary", boundary_call(x, w, b, a, t), x, conv3x3x3_cf_boundary,
                conv3x3x3_cf_boundary_f32)


def conv3x3x3_cf_dx_epilogue(g: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                             a: torch.Tensor, t: torch.Tensor):
    """(dy, da, dt) of a boundary conv from its output cotangent g (B, Cout,
    D, H, W), weights w (3, 3, 3, Cin, Cout), raw input x (B, Cin, D, H, W)
    and affine a, t (B, Cin): dy in x's dtype, da and dt fp32 (B, Cin); on
    CUDA bf16 or fp32 g and x (fp32 launches count on
    conv3x3x3_cf_dx_epilogue_f32)."""
    if g.device.type == "cpu":
        return conv3x3x3_cf_dx_epilogue_reference(g, w, x, a, t)
    return _run("conv3x3x3_cf_dx_epilogue", dx_epilogue_call(g, w, x, a, t), g,
                conv3x3x3_cf_dx_epilogue, conv3x3x3_cf_dx_epilogue_f32)


def conv3x3x3_cf_dw_prologue(x: torch.Tensor, g: torch.Tensor, a: torch.Tensor,
                             t: torch.Tensor) -> torch.Tensor:
    """fp32 dW (3, 3, 3, Cin, Cout) of a boundary conv from its raw input x
    (B, Cin, D, H, W), affine a, t (B, Cin) and cotangent g (B, Cout, D, H,
    W); on CUDA bf16 or fp32 x and g (fp32 launches count on
    conv3x3x3_cf_dw_prologue_f32)."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_dw_prologue_reference(x, g, a, t)
    return _run("conv3x3x3_cf_dw_prologue", dw_prologue_call(x, g, a, t), x,
                conv3x3x3_cf_dw_prologue, conv3x3x3_cf_dw_prologue_f32)


conv3x3x3_cf_dx_epilogue.launches = 0
conv3x3x3_cf_dw_prologue.launches = 0


def _g_eff(g, y, gs1, gs2):
    """The output cotangent with the statistics' folded in: g + gs1 + 2 y gs2
    in fp32, cast to g's dtype (as the JAX backward computes it)."""
    return (g.float() + _bc(gs1) + 2.0 * y.float() * _bc(gs2)).to(g.dtype)


def _sum_g(g, dtype):
    return g.float().sum(dim=(0, 2, 3, 4)).to(dtype)


class _ConvStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        y, s1, s2 = _conv_stats(x, w, b)
        ctx.save_for_backward(x, w, y)
        ctx.b_dtype = b.dtype
        return y, s1, s2

    @staticmethod
    def backward(ctx, g, gs1, gs2):
        x, w, y = ctx.saved_tensors
        ge = _g_eff(g, y, gs1, gs2).contiguous()
        dx = conv3.conv3x3x3_cf_dx(ge, w) if ctx.needs_input_grad[0] else None
        dw = conv3.conv3x3x3_cf_dw(x, ge).to(w.dtype) if ctx.needs_input_grad[1] else None
        db = _sum_g(ge, ctx.b_dtype) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def _boundary_backward(ctx, ge):
    """(dx, dw, db, da, dt) of a boundary conv from its effective cotangent."""
    x, w, a, t = ctx.saved_tensors[:4]
    dx = da = dt = dw = db = None
    if any(ctx.needs_input_grad[i] for i in (0, 3, 4)):
        dx, da, dt = conv3x3x3_cf_dx_epilogue(ge, w, x, a, t)
        da, dt = da.to(a.dtype), dt.to(t.dtype)
    if ctx.needs_input_grad[1]:
        dw = conv3x3x3_cf_dw_prologue(x, ge, a, t).to(w.dtype)
    if ctx.needs_input_grad[2]:
        db = _sum_g(ge, ctx.b_dtype)
    return dx, dw, db, da, dt


class _BoundaryStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, a, t):
        y, s1, s2 = _boundary_stats(x, w, b, a, t)
        ctx.save_for_backward(x, w, a, t, y)
        ctx.b_dtype = b.dtype
        return y, s1, s2

    @staticmethod
    def backward(ctx, g, gs1, gs2):
        y = ctx.saved_tensors[4]
        return _boundary_backward(ctx, _g_eff(g, y, gs1, gs2).contiguous())


class _Boundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, a, t):
        ctx.save_for_backward(x, w, a, t)
        ctx.b_dtype = b.dtype
        return _boundary(x, w, b, a, t)

    @staticmethod
    def backward(ctx, g):
        return _boundary_backward(ctx, g.contiguous())


def conv3x3x3_cf_stats(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """(y, s1, s2), differentiable in all three: x (B, Cin, D, H, W) in the
    working dtype, w (3, 3, 3, Cin, Cout) and b (Cout,) fp32 -> y in x's
    dtype, s1, s2 (Cout,) fp32."""
    return _ConvStats.apply(x, w, b)


def conv3x3x3_cf_boundary_stats(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                                a: torch.Tensor, t: torch.Tensor):
    """conv3x3x3_cf_stats of relu(x a + t), a, t (B, Cin) fp32,
    differentiable in x, w, b, a and t."""
    return _BoundaryStats.apply(x, w, b, a, t)


def conv3x3x3_cf_boundary(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                          a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The training conv (cast, then the bias in x's dtype) of relu(x a + t),
    a, t (B, Cin) fp32, differentiable in x, w, b, a and t."""
    return _Boundary.apply(x, w, b, a, t)


conv3x3x3_cf_stats.launches = 0  # forward kernel launches (kernel 3)
conv3x3x3_cf_boundary_stats.launches = 0  # kernel 4
conv3x3x3_cf_boundary.launches = 0  # kernel 12
