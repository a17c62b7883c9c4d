"""SAME 3x3x3 convolution + bias + ReLU on channel-first volumes.

Port of ``multimodal_segmentation_project_tpu/ops/pallas_conv.py``'s
``conv3x3x3_cf_relu`` (the eval forward's conv, BatchNorm already folded
into ``w``/``b`` by the caller). On a CUDA tensor it launches the hand-
written kernel ``csrc/conv3_bias_relu.cu``; on a CPU tensor it runs
:func:`conv3x3x3_cf_relu_reference`, the plain version of the same
arithmetic.

Rounding points, as on the TPU: the weights are cast to the working dtype,
products and sums are fp32, the fp32 bias is added, ReLU, one cast back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch.ops import _build

MAX_CHANNELS = 64  # the kernel's channel cap (supported_conv in the JAX package)


def supported(cin: int, cout: int) -> bool:
    """Convs the model routes to the kernel; wider ones are the deep region."""
    return cin <= MAX_CHANNELS and cout <= MAX_CHANNELS


def conv3x3x3_cf_relu_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, Cin, D, H, W), w (3, 3, 3, Cin, Cout), b (Cout,)."""
    wt = w.to(x.dtype).float().permute(4, 3, 0, 1, 2)  # (Cout, Cin, kd, kh, kw)
    y = F.conv3d(x.float(), wt, b.float(), padding=1)
    return torch.relu(y).to(x.dtype)


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, 3, Cin, Cout) -> bf16 (ceil(Cin/16), 27, 16, Cout16), zero-padded:
    one [tap][cin][cout] slab per chunk of 16 input channels, the kernel's
    shared-memory image (Cout16 is Cout rounded up to 16)."""
    cin, cout = w.shape[3], w.shape[4]
    cin_p, cout_p = -(-cin // 16) * 16, -(-cout // 16) * 16
    w27 = w.reshape(27, cin, cout).to(torch.bfloat16)
    w27 = F.pad(w27, (0, cout_p - cout, 0, cin_p - cin))
    return w27.reshape(27, cin_p // 16, 16, cout_p).permute(1, 0, 2, 3).contiguous()


def conv3x3x3_cf_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(conv3d(x, w) + b) in x's dtype; bf16 only on CUDA."""
    if x.device.type == "cpu":
        return conv3x3x3_cf_relu_reference(x, w, b)
    name = "conv3x3x3_cf_relu"
    _build.require(name, x, torch.bfloat16, 5)
    bsz, cin, d, h, wd = x.shape
    if tuple(w.shape[:4]) != (3, 3, 3, cin) or w.dim() != 5:
        raise ValueError(f"{name}: weights {tuple(w.shape)} do not match Cin={cin}")
    cout = w.shape[4]
    if not supported(cin, cout):
        raise ValueError(f"{name}: the kernel takes Cin, Cout <= {MAX_CHANNELS}, got {cin}, {cout}")
    if tuple(b.shape) != (cout,):
        raise ValueError(f"{name}: bias {tuple(b.shape)} does not match Cout={cout}")
    wk = pack_weights(w.to(x.device))
    bk = b.to(x.device, torch.float32).contiguous()
    out = torch.empty((bsz, cout, d, h, wd), dtype=torch.bfloat16, device=x.device)
    _build.launch(name, "mmseg_conv3_bias_relu", x, x.data_ptr(), wk.data_ptr(),
                  bk.data_ptr(), out.data_ptr(), bsz, cin, cout, d, h, wd)
    conv3x3x3_cf_relu.launches += 1
    return out


conv3x3x3_cf_relu.launches = 0
