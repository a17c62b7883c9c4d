"""2x2x2 stride-2 transpose conv (UpConv) on channel-first volumes.

Port of ``multimodal_segmentation_project_tpu/ops/upconv.py``'s
``upconv2x_cf``, a differentiable op. With kernel == stride every output
voxel receives exactly one kernel tap, so the op is a per-voxel (8*Cout x
Cin) product plus bias followed by depth-to-space. On a CUDA tensor the
forward launches ``csrc/upconv_d2s.cu``, a GEMM on the tensor cores over
tiles of TM input voxels with the weights packed by :func:`pack_kernel`
(:func:`upconv_call` builds the launch); on a CPU tensor it runs
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
from multimodal_segmentation_project_tpu_torch.ops._build import Launch, run

MAX_OUT_CHANNELS = 64  # wider upconvs (the deep region) use the plain torch op


def supported(cout: int) -> bool:
    return cout <= MAX_OUT_CHANNELS


def route(dtype: torch.dtype, cout: int) -> str | None:
    """The C entry point of a forward upconv of (dtype, Cout) on the card,
    or None where the model calls the library: an upconv wider than
    MAX_OUT_CHANNELS (the deep region), and every upconv not in bf16, which
    the JAX package sends to an XLA einsum (its kernel is bf16-only)."""
    return "mmseg_upconv_d2s" if dtype == torch.bfloat16 and supported(cout) else None


def runs_op(x: torch.Tensor, cout: int) -> bool:
    """Whether the model's upconv of x (Cout channels out) goes through
    :func:`upconv2x_cf`, or else through the library's transpose conv: on
    the card where the kernel takes it (:func:`route`); on the CPU up to
    MAX_OUT_CHANNELS in any dtype, since there the op runs its plain
    version, in fp32 the JAX package's own einsum."""
    if x.device.type == "cpu":
        return supported(cout)
    return route(x.dtype, cout) is not None


def upconv2x_cf_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version: the per-voxel einsum, then depth-to-space by reshape."""
    b, _, d, h, w = x.shape
    cout = kernel.shape[4]
    t = torch.einsum("bidhw,apqio->bodahpwq", x.float(), kernel.to(x.dtype).float())
    out = t.reshape(b, cout, 2 * d, 2 * h, 2 * w) + bias.float().reshape(1, -1, 1, 1, 1)
    return out.to(x.dtype)


TM = 64  # input voxels per tile of the kernel (csrc/upconv_d2s.cu)
OG = 16  # output channels per block (the kernel's grid y)
UPCONV_WAVES = 4  # blocks per SM over all channel groups: the kernel's tile walk
MAX_IN_CHANNELS = 256  # the block's weights and input tiles in shared memory: 156 KB


def pack_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(2, 2, 2, Cin, Cout) -> bf16 (8, Cout16, Cin16), zero-padded: row
    (phase (a, p, q), o) holds the Cin weights of output channel o, the
    kernel's B operand rows (Cin16, Cout16: rounded up to 16). One
    cast-and-permute copy into the packed buffer, which is zero-filled
    first only where Cin or Cout is not a multiple of 16."""
    cin, cout = kernel.shape[3], kernel.shape[4]
    cin_p, cout_p = -(-cin // 16) * 16, -(-cout // 16) * 16
    alloc = torch.empty if (cin_p, cout_p) == (cin, cout) else torch.zeros
    out = alloc((8, cout_p, cin_p), dtype=torch.bfloat16, device=kernel.device)
    out[:, :cout, :cin].copy_(kernel.permute(0, 1, 2, 4, 3).reshape(8, cout, cin))
    return out


def tiles(b: int, d: int, h: int, w: int) -> int:
    """The kernel's tiles: TM consecutive input voxels of one batch element
    each, the last of each element partial."""
    return b * -(-(d * h * w) // TM)


def blocks(device: torch.device, ntiles: int, cout: int) -> int:
    """Blocks per channel group: UPCONV_WAVES blocks per SM over all
    ceil(Cout/OG) groups, at most one per tile. Block k walks the tiles k,
    k + blocks, ...; the split changes no sum, so the result is the same
    bits for any block count."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(ntiles, UPCONV_WAVES * sms // -(-cout // OG)))


def upconv_call(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> Launch:
    """Kernel 10's call on CUDA tensors: bf16 x (B, Cin, D, H, W), kernel
    (2, 2, 2, Cin, Cout), bias (Cout,) -> bf16 (B, Cout, 2D, 2H, 2W)."""
    name = "upconv2x_cf"
    _build.require(name, x, torch.bfloat16, 5)
    b, cin, d, h, w = x.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (2, 2, 2, cin):
        raise ValueError(f"{name}: kernel {tuple(kernel.shape)} does not match Cin={cin}")
    if cin > MAX_IN_CHANNELS:
        raise ValueError(f"{name}: the kernel takes Cin <= {MAX_IN_CHANNELS}, got {cin}")
    cout = kernel.shape[4]
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} does not match Cout={cout}")
    kp = pack_kernel(kernel.to(x.device))
    bk = bias.to(x.device, torch.float32).contiguous()
    out = torch.empty((b, cout, 2 * d, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    nblk = blocks(x.device, tiles(b, d, h, w), cout)
    args = (x.data_ptr(), kp.data_ptr(), bk.data_ptr(), out.data_ptr(), b, cin, cout, d, h, w,
            nblk)
    return Launch("mmseg_upconv_d2s", args, out, (x, kp, bk, out))


def _upconv_fwd(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward without autograd; its launches count on upconv2x_cf."""
    if x.device.type == "cpu":
        return upconv2x_cf_reference(x, kernel, bias)
    out = run("upconv2x_cf", upconv_call(x, kernel, bias), x)
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
