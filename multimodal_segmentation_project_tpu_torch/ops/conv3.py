"""SAME 3x3x3 convolutions on channel-first volumes: the eval conv with bias
and ReLU, and the training conv with its backward.

Port of ``multimodal_segmentation_project_tpu/ops/pallas_conv.py``:

* :func:`conv3x3x3_cf_relu` -- ``conv3x3x3_cf_relu``, the eval forward's
  conv (BatchNorm already folded into ``w``/``b`` by the caller). Rounding:
  the weights are cast to the working dtype, products and sums are fp32,
  the fp32 bias is added, ReLU, one cast back.
* :func:`conv3x3x3_cf` -- ``conv3x3x3_cf``, the training conv, as an
  autograd Function. Forward: the conv's one cast to the working dtype,
  then the bias added in the working dtype. Backward, as
  ``_conv_bwd_rule``: dx is the same conv on the cotangent with the weights
  flipped spatially and Cin/Cout swapped (:func:`conv3x3x3_cf_dx`, skipped
  when x needs no gradient: the image at the first conv), dW the fp32
  weight gradient (:func:`conv3x3x3_cf_dw`), db a plain fp32 sum.

On CUDA tensors each launches its hand-written kernel: ``csrc/conv3.cu``
(one implicit-GEMM body; the eval conv's bias+ReLU epilogue and the
training conv's cast-then-bias epilogue, also used for dx) and
``csrc/conv3_dw.cu``. On CPU tensors each runs its ``*_reference``, the
plain version of the same arithmetic. Each wrapper counts its launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch.ops import _build

MAX_CHANNELS = 64  # the kernels' channel cap (supported_conv in the JAX package)


def supported(cin: int, cout: int) -> bool:
    """Convs the model routes to the kernels; wider ones are the deep region."""
    return cin <= MAX_CHANNELS and cout <= MAX_CHANNELS


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
    """(3, 3, 3, Cin, Cout) -> bf16 (ceil(Cin/16), 27, 16, Cout16), zero-padded:
    one [tap][cin][cout] slab per chunk of 16 input channels, the kernel's
    shared-memory image (Cout16 is Cout rounded up to 16)."""
    cin, cout = w.shape[3], w.shape[4]
    cin_p, cout_p = -(-cin // 16) * 16, -(-cout // 16) * 16
    w27 = w.reshape(27, cin, cout).to(torch.bfloat16)
    w27 = F.pad(w27, (0, cout_p - cout, 0, cin_p - cin))
    return w27.reshape(27, cin_p // 16, 16, cout_p).permute(1, 0, 2, 3).contiguous()


def _check_conv(name: str, x: torch.Tensor, w: torch.Tensor) -> int:
    """Raise unless the kernel takes (x, w); return Cout."""
    _build.require(name, x, torch.bfloat16, 5)
    cin = x.shape[1]
    if w.dim() != 5 or tuple(w.shape[:4]) != (3, 3, 3, cin):
        raise ValueError(f"{name}: weights {tuple(w.shape)} do not match Cin={cin}")
    cout = w.shape[4]
    if not supported(cin, cout):
        raise ValueError(f"{name}: the kernel takes Cin, Cout <= {MAX_CHANNELS}, got {cin}, {cout}")
    return cout


def _launch_conv(name: str, entry: str, x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor | None) -> torch.Tensor:
    cout = _check_conv(name, x, w)
    bsz, cin, d, h, wd = x.shape
    wk = pack_weights(w.to(x.device))
    bk = None
    if b is not None:
        if tuple(b.shape) != (cout,):
            raise ValueError(f"{name}: bias {tuple(b.shape)} does not match Cout={cout}")
        bk = b.to(x.device, torch.float32).contiguous()
    out = torch.empty((bsz, cout, d, h, wd), dtype=torch.bfloat16, device=x.device)
    _build.launch(name, entry, x, x.data_ptr(), wk.data_ptr(),
                  None if bk is None else bk.data_ptr(), out.data_ptr(), bsz, cin, cout, d, h, wd)
    return out


def conv3x3x3_cf_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(conv3d(x, w) + b) in x's dtype; bf16 only on CUDA."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_relu_reference(x, w, b)
    out = _launch_conv("conv3x3x3_cf_relu", "mmseg_conv3_bias_relu", x, w, b)
    conv3x3x3_cf_relu.launches += 1
    return out


def _conv_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The training forward without autograd; its launches count on conv3x3x3_cf."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_reference(x, w, b)
    out = _launch_conv("conv3x3x3_cf", "mmseg_conv3", x, w, b)
    conv3x3x3_cf.launches += 1
    return out


def conv3x3x3_cf_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of the conv: g (B, Cout, D, H, W), w (3, 3, 3, Cin, Cout) ->
    (B, Cin, D, H, W) in g's dtype; bf16 only on CUDA."""
    if g.device.type == "cpu":
        return conv3x3x3_cf_dx_reference(g, w)
    out = _launch_conv("conv3x3x3_cf_dx", "mmseg_conv3", g, flip_transpose(w), None)
    conv3x3x3_cf_dx.launches += 1
    return out


def dw_partial_blocks(device: torch.device, cin: int) -> int:
    """Blocks per 16-channel chunk of the dW kernel's first pass: four
    waves of one block per SM over all chunks (a fixed split, so the sum
    order and the result do not change from run to run)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, 4 * sms // -(-cin // 16))


def conv3x3x3_cf_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """fp32 dW (3, 3, 3, Cin, Cout) of the conv from its input x (B, Cin, D,
    H, W) and cotangent g (B, Cout, D, H, W); bf16 inputs only on CUDA."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_dw_reference(x, g)
    name = "conv3x3x3_cf_dw"
    _build.require(name, x, torch.bfloat16, 5)
    _build.require(name, g, torch.bfloat16, 5)
    bsz, cin, d, h, wd = x.shape
    cout = g.shape[1]
    if g.shape[0] != bsz or g.shape[2:] != x.shape[2:]:
        raise ValueError(
            f"{name}: cotangent {tuple(g.shape)} does not match input {tuple(x.shape)}")
    if not supported(cin, cout):
        raise ValueError(f"{name}: the kernel takes Cin, Cout <= {MAX_CHANNELS}, got {cin}, {cout}")
    nblk = dw_partial_blocks(x.device, cin)
    partial = torch.empty(nblk * -(-cin // 16) * 27 * 16 * (-(-cout // 16) * 16),
                          dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=x.device)
    _build.launch(name, "mmseg_conv3_dw", x, x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                  dw.data_ptr(), bsz, cin, cout, d, h, wd, nblk)
    conv3x3x3_cf_dw.launches += 1
    return dw


conv3x3x3_cf_relu.launches = 0
conv3x3x3_cf_dx.launches = 0
conv3x3x3_cf_dw.launches = 0


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
    working dtype, w (3, 3, 3, Cin, Cout) and b (Cout,) fp32 -> x's dtype."""
    return _Conv3.apply(x, w, b)


conv3x3x3_cf.launches = 0  # forward kernel launches
