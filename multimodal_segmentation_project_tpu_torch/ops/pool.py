"""2x2x2 stride-2 max pool on channel-first volumes (forward).

Port of ``multimodal_segmentation_project_tpu/ops/pool.py``'s
``max_pool2x_cf`` forward. On a CUDA tensor it launches
``csrc/pool2x.cu``; on a CPU tensor it runs :func:`max_pool2x_cf_reference`.
Odd extents use floor semantics. The backward (equal shares to tied
maxima) belongs to the training slice.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.ops import _build

MAX_CHANNELS = 64  # the model pools wider (deep-region) tensors with the plain version


def supported(c: int) -> bool:
    return c <= MAX_CHANNELS


def max_pool2x_cf_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: a reshape into 2x2x2 windows and a max over them."""
    b, c, d, h, w = x.shape
    x = x[:, :, : d // 2 * 2, : h // 2 * 2, : w // 2 * 2]
    x = x.reshape(b, c, d // 2, 2, h // 2, 2, w // 2, 2)
    return x.amax(dim=(3, 5, 7))


def max_pool2x_cf(x: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, C, D//2, H//2, W//2); bf16 only on CUDA."""
    if x.device.type == "cpu":
        return max_pool2x_cf_reference(x)
    name = "max_pool2x_cf"
    _build.require(name, x, torch.bfloat16, 5)
    b, c, d, h, w = x.shape
    out = torch.empty((b, c, d // 2, h // 2, w // 2), dtype=x.dtype, device=x.device)
    _build.launch(name, "mmseg_pool2x", x, x.data_ptr(), out.data_ptr(), b, c, d, h, w)
    max_pool2x_cf.launches += 1
    return out


max_pool2x_cf.launches = 0
