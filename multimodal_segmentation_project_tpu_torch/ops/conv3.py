"""SAME 3x3x3 convolutions on channel-first volumes: the eval conv with bias
and ReLU, and the training conv with its backward.

Port of ``multimodal_segmentation_project_tpu/ops/pallas_conv.py``:

* :func:`conv3x3x3_cf_relu` -- ``conv3x3x3_cf_relu``, the eval forward's
  conv (BatchNorm already folded into ``w``/``b`` by the caller). Rounding:
  the weights are cast to the working dtype, products and sums are fp32,
  the fp32 bias is added, ReLU, one cast back. In bf16 or in fp32, as the
  JAX package runs it under either policy.
* :func:`conv3x3x3_cf` -- ``conv3x3x3_cf``, the training conv, as an
  autograd Function. Forward: the conv's one cast to the working dtype,
  then the bias added in the working dtype. Backward, as
  ``_conv_bwd_rule``: dx is the same conv on the cotangent with the weights
  flipped spatially and Cin/Cout swapped (:func:`conv3x3x3_cf_dx`, skipped
  when x needs no gradient: the image at the first conv), dW the fp32
  weight gradient (:func:`conv3x3x3_cf_dw`), db a plain fp32 sum (XLA in
  the JAX package). In bf16 or in fp32.

On CUDA tensors each launches its hand-written kernel: ``csrc/conv3.cu``
(one implicit-GEMM body on bf16; the eval conv's bias+ReLU epilogue and the
training conv's cast-then-bias epilogue, also used for dx),
``csrc/conv3_f32.cu`` (the fp32 body: the eval conv, the training conv and
its dx on an fp32 x, counted on :func:`conv3x3x3_cf_relu_f32`,
:func:`conv3x3x3_cf_f32` and :func:`conv3x3x3_cf_dx_f32`),
``csrc/conv3_dw.cu`` (the bf16 dW) and ``csrc/conv3_dw_f32.cu`` (the fp32
dW, counted on :func:`conv3x3x3_cf_dw_f32`). The fused DoubleConv's convs,
on the same bodies, are in ``ops.conv3_fused``. On CPU tensors each runs
its ``*_reference``, the plain version of the same arithmetic. Each
wrapper counts its launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch.ops import _build
from multimodal_segmentation_project_tpu_torch.ops._build import Launch, count, run

MAX_CHANNELS = 64  # the kernels' channel cap (supported_conv in the JAX package)


def supported(cin: int, cout: int) -> bool:
    """Convs the model routes to the kernels; wider ones are the deep region."""
    return cin <= MAX_CHANNELS and cout <= MAX_CHANNELS


def eval_route(dtype: torch.dtype, cin: int, cout: int) -> str | None:
    """The C entry point an eval conv of (dtype, Cin, Cout) launches on the
    card, or None where the model calls the library (the deep region)."""
    if not supported(cin, cout):
        return None
    return "mmseg_conv3_f32_bias_relu" if dtype == torch.float32 else "mmseg_conv3_bias_relu"


# ---- plain versions ---------------------------------------------------


def conv_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 SAME conv of x with w (3, 3, 3, Cin, Cout) cast to x's dtype."""
    wt = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)  # (Cout, Cin, kd, kh, kw)
    return F.conv3d(x.float(), wt, padding=1)


def conv3x3x3_cf_relu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, Cin, D, H, W), w (3, 3, 3, Cin, Cout), b (Cout,)."""
    y = conv_fp32(x, w) + b.float().reshape(1, -1, 1, 1, 1)
    return torch.relu(y).to(x.dtype)


def conv3x3x3_cf_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the training forward: one cast, then the bias in x's dtype."""
    return conv_fp32(x, w).to(x.dtype) + b.to(x.dtype).reshape(1, -1, 1, 1, 1)


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Cin, Cout) -> (3, 3, 3, Cout, Cin), flipped spatially: the
    weights of the dx conv."""
    return w.flip(0, 1, 2).transpose(3, 4)


def conv3x3x3_cf_dx_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of dx: g (B, Cout, D, H, W) -> (B, Cin, D, H, W) in g's dtype."""
    return conv_fp32(g, flip_transpose(w)).to(g.dtype)


def conv3x3x3_cf_dw_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of dW: fp32 sums over batch and voxels of the shifted
    input times the cotangent, one tap at a time -> (3, 3, 3, Cin, Cout)."""
    d, h, wd = x.shape[2:]
    xp = F.pad(x.float(), (1, 1, 1, 1, 1, 1))
    gf = g.float()
    taps = [
        torch.einsum("bidhw,bodhw->io", xp[:, :, kd:kd + d, kh:kh + h, kw:kw + wd], gf)
        for kd in range(3) for kh in range(3) for kw in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, 3, x.shape[1], g.shape[1])


# ---- kernels ----------------------------------------------------------


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Cin, Cout) -> bf16 (ceil(Cin/16), 27, Cout16, 16), zero-padded:
    one [tap][cout][cin] slab per chunk of 16 input channels, the kernel's
    shared-memory image before its row swizzle (Cout16 is Cout rounded up
    to 16). One cast-and-permute copy; a pad first only where Cin or Cout
    is not a multiple of 16."""
    cin, cout = w.shape[3], w.shape[4]
    cin_p, cout_p = -(-cin // 16) * 16, -(-cout // 16) * 16
    w27 = w.reshape(27, cin, cout)
    if (cin_p, cout_p) != (cin, cout):
        w27 = F.pad(w27, (0, cout_p - cout, 0, cin_p - cin))
    out = torch.empty((cin_p // 16, 27, cout_p, 16), dtype=torch.bfloat16, device=w.device)
    return out.copy_(w27.reshape(27, cin_p // 16, 16, cout_p).permute(1, 0, 3, 2))


def _check_conv(name: str, x: torch.Tensor, w: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """Raise unless the kernel takes (x, w), x of ``dtype``; return Cout."""
    _build.require(name, x, dtype, 5)
    cin = x.shape[1]
    if w.dim() != 5 or tuple(w.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"{name}: weights {tuple(w.shape)} do not match Cin={cin}")
    cout = w.shape[4]
    if not supported(cin, cout):
        raise ValueError(f"{name}: the kernel takes Cin, Cout <= {MAX_CHANNELS}, got {cin}, {cout}")
    return cout


def conv_operands(name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                  dtype: torch.dtype = torch.bfloat16):
    """Checks for a conv kernel on (x, w, b), x of ``dtype``; the packed
    weights (for the bf16 body or the fp32 one), the fp32 bias (None without
    one) and the output (B, Cout, D, H, W) in ``dtype``."""
    cout = _check_conv(name, x, w, dtype)
    bk = None
    if b is not None:
        if tuple(b.shape) != (cout,):
            raise ValueError(f"{name}: bias {tuple(b.shape)} does not match Cout={cout}")
        bk = b.to(x.device, torch.float32).contiguous()
    pack = pack_weights_f32 if dtype == torch.float32 else pack_weights
    wk = pack(w.to(x.device))
    out = torch.empty((x.shape[0], cout) + tuple(x.shape[2:]), dtype=dtype, device=x.device)
    return wk, bk, out


def _conv_call(name: str, entry: str, x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None) -> Launch:
    wk, bk, out = conv_operands(name, x, w, b)
    bsz, cin, d, h, wd = x.shape
    args = (x.data_ptr(), wk.data_ptr(), None if bk is None else bk.data_ptr(), out.data_ptr(),
            bsz, cin, out.shape[1], d, h, wd)
    return Launch(entry, args, out, (x, wk, bk, out))


def relu_call(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> Launch:
    """Kernel 7's call on CUDA tensors (conv3x3x3_cf_relu)."""
    return _conv_call("conv3x3x3_cf_relu", "mmseg_conv3_bias_relu", x, w, b)


def conv_call(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> Launch:
    """Kernel 1's call on CUDA tensors (the training forward)."""
    return _conv_call("conv3x3x3_cf", "mmseg_conv3", x, w, b)


def dx_call(g: torch.Tensor, w: torch.Tensor) -> Launch:
    """Kernel 1's call as the dx of the conv with weights w."""
    return _conv_call("conv3x3x3_cf_dx", "mmseg_conv3", g, flip_transpose(w), None)


def conv3x3x3_cf_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(conv3d(x, w) + b) in x's dtype; on CUDA bf16 here, fp32 through
    :func:`conv3x3x3_cf_relu_f32`."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_relu_reference(x, w, b)
    if x.dtype == torch.float32:
        return conv3x3x3_cf_relu_f32(x, w, b)
    out = run("conv3x3x3_cf_relu", relu_call(x, w, b), x)
    count(conv3x3x3_cf_relu)
    return out


# ---- the fp32 body (csrc/conv3_f32.cu) ------------------------------------

F32_TILE_HW = (8, 14)  # TILE_H, TILE_W of an output tile; TILE_D is the warpgroups'
F32_XCH = 1000         # staged floats per channel: 5 planes of 10 rows of 20
F32_MAX_STAGES = 4     # the ring's stages at most
F32_FIXED_BYTES = 576 + 512 + 2048 + 8 * F32_MAX_STAGES  # k table, (a, t), sums, mbarriers
F32_SMEM_LIMIT = 232448  # an H100 block's dynamic shared memory


def f32_chunk(cin: int) -> int:
    """Input channels per chunk of the fp32 body's K loop: 1 where Cin = 1
    (the 9 (kd, kh) pairs are K), else 8 (K = 72: the pairs, 8 channels
    each)."""
    return 1 if cin == 1 else 8


def f32_k_steps(ck: int) -> int:
    """k steps of 8 per chunk: 9 CK rounded up to 8."""
    return -(-9 * ck // 8)


def f32_slice(cout: int) -> int:
    """Output channels of a slice, NS: the wgmma's N is 3 NS (kw, channel);
    Cout > 32 takes two slices of 32."""
    return 16 if cout <= 16 else 32


def f32_warpgroups(cout: int) -> int:
    """Consumer warpgroups of an fp32 conv block, one output plane of a tile
    each: three for a slice of 16 channels, two for one of 32."""
    return 3 if f32_slice(cout) == 16 else 2


def f32_tile(cout: int) -> tuple:
    """(TILE_D, TILE_H, TILE_W): an output tile of the fp32 body's
    persistent blocks for ``cout`` output channels."""
    return (f32_warpgroups(cout), *F32_TILE_HW)


def f32_stage_bytes(ck: int, cout: int) -> int:
    """One stage of the ring: the haloed input tile of CK channels (from a
    128-byte boundary), then the chunk's weight slab, the hi and lo planes
    (32 N bytes each, N = 3 NS) of every k step."""
    return -(-ck * F32_XCH * 4 // 128) * 128 + 64 * 3 * f32_slice(cout) * f32_k_steps(ck)


def f32_smem_bytes(cin: int, cout: int) -> int:
    """Dynamic shared memory of an fp32 conv block: as many stages as fit
    (at most F32_MAX_STAGES) and the fixed part."""
    stage = f32_stage_bytes(f32_chunk(cin), cout)
    return min(F32_MAX_STAGES, (F32_SMEM_LIMIT - F32_FIXED_BYTES) // stage) * stage \
        + F32_FIXED_BYTES


def pack_weights_f32(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Cin, Cout) -> fp32 (nslices, nchunks, KS, 2, 2, 3 NS, 4): per
    slice of NS = f32_slice(Cout) output channels and chunk of CK =
    f32_chunk(Cin) input channels, K = 9 CK (k = CK (3 kd + kh) + ci,
    zero-padded to KS = f32_k_steps(CK) steps of 8) by N = 3 NS (n = NS kw
    + channel), and per k step a hi and a lo plane (hi = tf32(w), lo =
    tf32(w - hi)), each two core matrices of N rows x 4 k (k = 4 kg + e):
    the wgmma's K-major layout without swizzle, one (slice, chunk) slab the
    fp32 body's shared-memory image (zero past Cout and past Cin)."""
    cin, cout = w.shape[3], w.shape[4]
    ck, ns = f32_chunk(cin), f32_slice(cout)
    ks, nch, nsl = f32_k_steps(ck), -(-cin // ck), -(-cout // ns)
    w5 = w.float()
    if (nch * ck, nsl * ns) != (cin, cout):
        w5 = F.pad(w5, (0, nsl * ns - cout, 0, nch * ck - cin))
    # (kd, kh, kw, chunk, ci, slice, co) -> (slice, chunk, (kd, kh, ci), (kw, co))
    wk = w5.reshape(3, 3, 3, nch, ck, nsl, ns).permute(5, 3, 0, 1, 4, 2, 6)
    wk = wk.reshape(nsl, nch, 9 * ck, 3 * ns)
    if 8 * ks != 9 * ck:
        wk = F.pad(wk, (0, 0, 0, 8 * ks - 9 * ck))
    # each k step's (kg, e, n) as the planes' (kg, n, e), written in place
    src = wk.reshape(nsl, nch, ks, 2, 4, 3 * ns).permute(0, 1, 2, 3, 5, 4)
    out = torch.empty((nsl, nch, ks, 2, 2, 3 * ns, 4), dtype=torch.float32, device=w.device)
    hi, lo = out[:, :, :, 0], out[:, :, :, 1]
    hi_bits, lo_bits = hi.view(torch.int32), lo.view(torch.int32)
    # TF32 as cvt.rna.tf32.f32 rounds: to 10 mantissa bits, to nearest, ties away
    torch.add(src.view(torch.int32), 0x1000, out=hi_bits).bitwise_and_(-0x2000)
    torch.sub(src, hi, out=lo)
    lo_bits.add_(0x1000).bitwise_and_(-0x2000)
    return out


def f32_launch_dims(device: torch.device, shape: tuple, cout: int) -> tuple:
    """(grid x, grid y, grid z, threads, dynamic shared memory in bytes) of
    the fp32 body on x of ``shape`` (B, Cin, D, H, W): persistent blocks of
    f32_warpgroups(Cout) warpgroups, one an SM (at most one a unit), walking
    the units (an output tile of f32_tile(Cout) voxels and a slice of its
    output channels). A tile's sums do not depend on the grid: the result
    is the same bits on any card."""
    bsz, cin, d, h, w = shape
    td, th, tw = f32_tile(cout)
    units = bsz * -(-d // td) * -(-h // th) * -(-w // tw) * -(-cout // f32_slice(cout))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(units, sms), 1, 1, 128 * td, f32_smem_bytes(cin, cout)


def _f32_call(name: str, entry: str, x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor | None) -> Launch:
    wk, bk, out = conv_operands(name, x, w, b, torch.float32)
    cout = out.shape[1]
    args = (x.data_ptr(), wk.data_ptr(), None if bk is None else bk.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], cout, *x.shape[2:],
            *f32_launch_dims(x.device, tuple(x.shape), cout))
    return Launch(entry, args, out, (x, wk, bk, out))


def relu_f32_call(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> Launch:
    """Kernel 7's fp32 call on CUDA tensors: relu(conv3d(x, w) + b) of an
    fp32 x (B, Cin, D, H, W), w (3, 3, 3, Cin, Cout), b (Cout,) -> fp32
    (B, Cout, D, H, W). The weights are packed in fp32 once per call."""
    return _f32_call("conv3x3x3_cf_relu_f32", "mmseg_conv3_f32_bias_relu", x, w, b)


def conv_f32_call(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> Launch:
    """Kernel 1's fp32 call on CUDA tensors: conv3d(x, w) + b of an fp32 x,
    in fp32 (the training forward)."""
    return _f32_call("conv3x3x3_cf_f32", "mmseg_conv3_f32", x, w, b)


def dx_f32_call(g: torch.Tensor, w: torch.Tensor) -> Launch:
    """Kernel 1's fp32 call as the dx of the conv with weights w: the same
    body on the fp32 cotangent g with flip_transpose(w), no bias."""
    return _f32_call("conv3x3x3_cf_dx_f32", "mmseg_conv3_f32", g, flip_transpose(w), None)


def conv3x3x3_cf_relu_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel 7's fp32 instance: relu(conv3d(x, w) + b) of an fp32 x, in
    fp32; the plain version on the CPU."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_relu_reference(x, w, b)
    out = run("conv3x3x3_cf_relu_f32", relu_f32_call(x, w, b), x)
    count(conv3x3x3_cf_relu_f32)
    return out


def _conv_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The training forward without autograd; its bf16 launches count on
    conv3x3x3_cf, its fp32 ones on conv3x3x3_cf_f32."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_reference(x, w, b)
    if x.dtype == torch.float32:
        return conv3x3x3_cf_f32(x, w, b)
    out = run("conv3x3x3_cf", conv_call(x, w, b), x)
    count(conv3x3x3_cf)
    return out


def conv3x3x3_cf_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Kernel 1's fp32 instance, without autograd: conv3d(x, w) + b of an
    fp32 x, in fp32; the plain version on the CPU."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_reference(x, w, b)
    out = run("conv3x3x3_cf_f32", conv_f32_call(x, w, b), x)
    count(conv3x3x3_cf_f32)
    return out


def conv3x3x3_cf_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of the conv: g (B, Cout, D, H, W), w (3, 3, 3, Cin, Cout) ->
    (B, Cin, D, H, W) in g's dtype; bf16 here on CUDA, fp32 through
    :func:`conv3x3x3_cf_dx_f32`."""
    if g.device.type == "cpu":
        return conv3x3x3_cf_dx_reference(g, w)
    if g.dtype == torch.float32:
        return conv3x3x3_cf_dx_f32(g, w)
    out = run("conv3x3x3_cf_dx", dx_call(g, w), g)
    count(conv3x3x3_cf_dx)
    return out


def conv3x3x3_cf_dx_f32(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel 1-dx's fp32 instance: the dx of the conv with weights w from
    an fp32 cotangent g, in fp32; the plain version on the CPU."""
    if g.device.type == "cpu":
        return conv3x3x3_cf_dx_reference(g, w)
    out = run("conv3x3x3_cf_dx_f32", dx_f32_call(g, w), g)
    count(conv3x3x3_cf_dx_f32)
    return out


DW_WAVES = 2  # waves of the dW kernel's first pass, one block per SM


def dw_partial_blocks(device: torch.device, cin: int) -> int:
    """Blocks per 16-channel chunk of the dW kernel's first pass: DW_WAVES
    waves of one block per SM over all chunks. The split depends on the SM
    count and the chunk count only, so the sum order and the result do not
    change from run to run on one card."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, DW_WAVES * sms // -(-cin // 16))


def _check_dw(name: str, x: torch.Tensor, g: torch.Tensor, dtype: torch.dtype) -> None:
    """Raise unless a dW kernel takes input x and cotangent g, both of ``dtype``."""
    _build.require(name, x, dtype, 5)
    _build.require(name, g, dtype, 5)
    cin, cout = x.shape[1], g.shape[1]
    if g.shape[0] != x.shape[0] or g.shape[2:] != x.shape[2:]:
        raise ValueError(
            f"{name}: cotangent {tuple(g.shape)} does not match input {tuple(x.shape)}")
    if not supported(cin, cout):
        raise ValueError(f"{name}: the kernel takes Cin, Cout <= {MAX_CHANNELS}, got {cin}, {cout}")


def dw_operands(name: str, x: torch.Tensor, g: torch.Tensor):
    """Checks for a dW kernel on input x and cotangent g; its fp32 scratch
    (one (27, 16, Cout16) partial per block and chunk), its fp32 output
    (3, 3, 3, Cin, Cout) and its integer arguments."""
    _check_dw(name, x, g, torch.bfloat16)
    bsz, cin, d, h, wd = x.shape
    cout = g.shape[1]
    nblk = dw_partial_blocks(x.device, cin)
    partial = torch.empty(nblk * -(-cin // 16) * 27 * 16 * (-(-cout // 16) * 16),
                          dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    return partial, dw, (bsz, cin, cout, d, h, wd, nblk)


def dw_call(x: torch.Tensor, g: torch.Tensor) -> Launch:
    """Kernel 2's call on CUDA tensors (the training conv's dW)."""
    partial, dw, args = dw_operands("conv3x3x3_cf_dw", x, g)
    return Launch("mmseg_conv3_dw", (x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                                     dw.data_ptr(), *args), dw, (x, g, partial, dw))


def conv3x3x3_cf_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """fp32 dW (3, 3, 3, Cin, Cout) of the conv from its input x (B, Cin, D,
    H, W) and cotangent g (B, Cout, D, H, W); on CUDA bf16 inputs here, fp32
    ones through :func:`conv3x3x3_cf_dw_f32`."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_dw_reference(x, g)
    if x.dtype == torch.float32:
        return conv3x3x3_cf_dw_f32(x, g)
    dw = run("conv3x3x3_cf_dw", dw_call(x, g), x)
    count(conv3x3x3_cf_dw)
    return dw


# ---- the fp32 dW body (csrc/conv3_dw_f32.cu) ------------------------------

DW_F32_TILE = (3, 3, 16)  # DTD, DTH, DTW: a block's output tile
DW_F32_CI = 16          # input channels per block (the grid's y)
DW_F32_CO = 32          # output channels per block (the grid's z)
DW_F32_THREADS = 576    # 18 warps, one block an SM
DW_F32_CP = 456         # plane floats per input channel ((DTD + 2) (DTH + 2) rows of DTW + 2)
DW_F32_GP = 152         # plane floats per cotangent channel (DTD DTH rows of DTW)
DW_F32_RAW_PITCH = 24   # floats per staged raw input row: voxels w0 - 4 .. w0 + 19


def dw_f32_smem_bytes(cout: int) -> int:
    """Dynamic shared memory of an fp32 dW block for ``cout`` output
    channels (a block holds 16 of them where Cout <= 16, else DW_F32_CO):
    the hi and lo planes of DW_F32_CI input channels and of its cotangent
    channels, two raw stages (the input's (DTD + 2) (DTH + 2) staged rows of
    DW_F32_RAW_PITCH floats, the cotangent's DTD DTH rows, the prologue's a
    and t) and their two mbarriers."""
    td, th, tw = DW_F32_TILE
    cout16 = 16 if cout <= 16 else DW_F32_CO
    planes = 2 * (DW_F32_CI * DW_F32_CP + cout16 * DW_F32_GP)
    stage = (DW_F32_CI * (td + 2) * (th + 2) * DW_F32_RAW_PITCH + cout16 * td * th * tw
             + 2 * DW_F32_CI)
    return 4 * (planes + 2 * stage + 4)


def dw_f32_launch_dims(device: torch.device, shape: tuple, cout: int) -> tuple:
    """(grid x, grid y, grid z, threads, dynamic shared memory in bytes) of
    the fp32 dW on x of ``shape`` (B, Cin, D, H, W): grid x is nblk, one
    wave of one block an SM over the ceil(Cin / DW_F32_CI) x ceil(Cout /
    DW_F32_CO) channel blocks, each walking every nblk-th output tile. The split depends on the SM count and the channels only,
    so the sum order and the result do not change from run to run on one
    card."""
    cb, cz = -(-shape[1] // DW_F32_CI), -(-cout // DW_F32_CO)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    nblk = max(1, sms // (cb * cz))
    return nblk, cb, cz, DW_F32_THREADS, dw_f32_smem_bytes(cout)


def dw_f32_operands(name: str, x: torch.Tensor, g: torch.Tensor):
    """Checks for an fp32 dW kernel on input x and cotangent g; its fp32
    scratch (one (27, Cin, Cout) partial per block row, grid x), its fp32
    output (3, 3, 3, Cin, Cout) and its integer arguments, the descriptor
    last."""
    _check_dw(name, x, g, torch.float32)
    bsz, cin, d, h, wd = x.shape
    cout = g.shape[1]
    dims = dw_f32_launch_dims(x.device, tuple(x.shape), cout)
    partial = torch.empty(dims[0] * 27 * cin * cout, dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    return partial, dw, (bsz, cin, cout, d, h, wd, *dims)


def dw_f32_call(x: torch.Tensor, g: torch.Tensor) -> Launch:
    """Kernel 2's fp32 call on CUDA tensors: fp32 dW (3, 3, 3, Cin, Cout)
    from an fp32 input x (B, Cin, D, H, W) and cotangent g (B, Cout, D, H,
    W)."""
    partial, dw, args = dw_f32_operands("conv3x3x3_cf_dw_f32", x, g)
    return Launch("mmseg_conv3_dw_f32", (x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                                         dw.data_ptr(), *args), dw, (x, g, partial, dw))


def conv3x3x3_cf_dw_f32(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel 2's fp32 instance: dW of the conv from an fp32 input and
    cotangent, in fp32; the plain version on the CPU."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_dw_reference(x, g)
    dw = run("conv3x3x3_cf_dw_f32", dw_f32_call(x, g), x)
    count(conv3x3x3_cf_dw_f32)
    return dw


conv3x3x3_cf_relu.launches = 0
conv3x3x3_cf_relu_f32.launches = 0
conv3x3x3_cf_f32.launches = 0
conv3x3x3_cf_dx.launches = 0
conv3x3x3_cf_dx_f32.launches = 0
conv3x3x3_cf_dw.launches = 0
conv3x3x3_cf_dw_f32.launches = 0


class _Conv3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.b_dtype = b.dtype
        return _conv_fwd(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = conv3x3x3_cf_dx(g, w) if ctx.needs_input_grad[0] else None
        dw = conv3x3x3_cf_dw(x, g).to(w.dtype) if ctx.needs_input_grad[1] else None
        db = g.float().sum(dim=(0, 2, 3, 4)).to(ctx.b_dtype) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def conv3x3x3_cf(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAME 3x3x3 conv + bias, differentiable: x (B, Cin, D, H, W) in the
    working dtype (bf16 or fp32), w (3, 3, 3, Cin, Cout) and b (Cout,) fp32
    -> x's dtype."""
    return _Conv3.apply(x, w, b)


conv3x3x3_cf.launches = 0  # forward kernel launches
