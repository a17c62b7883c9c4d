"""Synthetic abdominal volumes with organ labels, made on the device from a seed.

Each volume is a body-shaped ellipsoid holding four organ blobs (class 1
spleen, 2 liver, 3 kidneys, the two kidneys one class), each an ellipsoid
whose surface is roughened by a smooth random field. Intensities follow the
modality and then the dataset's own normalisation
(``data/dataset.py:preprocess_ct``, ``preprocess_mri``), so the images lie
in [0, 1] as the decoded cache holds them:

* CT: Hounsfield units per tissue plus noise, the abdominal window
  [-160, 240] HU mapped onto [0, 1];
* MRI: arbitrary tissue intensities under a smooth bias field, z-scored,
  clipped to the 1st and 99th percentile and min-max scaled.

Every draw comes from the caller's ``torch.Generator`` on the device, in a
few large calls per volume, so the same seed gives the same volumes on the
same device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# (class, centre (d, h, w) and radii as fractions of the volume, HU, MRI level)
ORGANS = (
    (2, (0.50, 0.38, 0.34), (0.22, 0.17, 0.20), 60.0, 0.55),   # liver
    (1, (0.50, 0.40, 0.70), (0.10, 0.07, 0.09), 50.0, 0.80),   # spleen
    (3, (0.45, 0.66, 0.36), (0.09, 0.05, 0.05), 150.0, 1.00),  # left kidney
    (3, (0.45, 0.66, 0.64), (0.09, 0.05, 0.05), 150.0, 1.00),  # right kidney
)
BODY = ((0.5, 0.5, 0.5), (0.46, 0.40, 0.46))
CT_WINDOW = (-160.0, 240.0)


def _grid(size: int, device) -> tuple[torch.Tensor, ...]:
    r = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) / size
    return r.view(-1, 1, 1), r.view(1, -1, 1), r.view(1, 1, -1)


def _smooth(gen: torch.Generator, size: int, device, coarse: int = 6) -> torch.Tensor:
    """A smooth random field of unit scale: coarse noise, trilinearly upsampled."""
    noise = torch.randn((1, 1, coarse, coarse, coarse), generator=gen, device=device)
    return F.interpolate(noise, size=(size,) * 3, mode="trilinear", align_corners=True)[0, 0]


def _ellipsoid(grid, centre, radii, rough: torch.Tensor) -> torch.Tensor:
    d, h, w = grid
    f = sum(((a - c) / r) ** 2 for a, c, r in zip((d, h, w), centre, radii))
    return f + 0.25 * rough < 1.0


def make_volume(gen: torch.Generator, size: int, modality: str, device):
    """One (1, S, S, S) fp32 image in [0, 1] and its (S, S, S) int32 labels."""
    grid = _grid(size, device)
    jitter = (torch.rand((len(ORGANS) + 1, 6), generator=gen, device=device) - 0.5).tolist()
    body = _ellipsoid(grid, BODY[0], [r * (1 + 0.1 * j) for r, j in zip(BODY[1], jitter[0][3:])],
                      _smooth(gen, size, device))
    labels = torch.zeros((size,) * 3, dtype=torch.int32, device=device)
    level = torch.where(body, 0.0, -1000.0 if modality == "ct" else 0.0)
    level = level + (-100.0 if modality == "ct" else 0.25) * body  # fat / soft tissue
    for (cls, centre, radii, hu, mri), j in zip(ORGANS, jitter[1:]):
        c = [x + 0.04 * dj for x, dj in zip(centre, j[:3])]
        r = [x * (1 + 0.2 * dj) for x, dj in zip(radii, j[3:])]
        inside = _ellipsoid(grid, c, r, _smooth(gen, size, device)) & body
        labels = torch.where(inside, torch.tensor(cls, dtype=torch.int32, device=device), labels)
        level = torch.where(inside, torch.tensor(hu if modality == "ct" else mri, device=device),
                            level)
    noise = torch.randn((size,) * 3, generator=gen, device=device)
    if modality == "ct":
        hu = level + 15.0 * noise + 20.0 * _smooth(gen, size, device)
        lo, hi = CT_WINDOW
        image = (hu.clamp(lo, hi) - lo) / (hi - lo)
    else:
        raw = (level + 0.05 * noise) * torch.exp(0.3 * _smooth(gen, size, device))
        z = (raw - raw.mean()) / (raw.std() + 1e-8)
        flat = z.reshape(-1)
        n = flat.numel()
        lo = flat.kthvalue(max(int(0.01 * n), 1)).values
        hi = flat.kthvalue(max(int(0.99 * n), 1)).values
        image = (z.clamp(lo, hi) - lo) / (hi - lo + 1e-8)
    return image[None].float().contiguous(), labels.contiguous()
