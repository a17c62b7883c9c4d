"""Stochastic augmentations on the tensors' device, drawn from an explicit
``torch.Generator``.

Port of ``multimodal_segmentation_project_tpu/ops/augment.py`` (the
reference's MONAI pipeline as distribution-level equivalents), each
transform applied with probability 0.3 per sample:

* bias field: img * exp(sum c_ijk x^i y^j z^k), degree 3, c ~ U[0, 0.1];
* Gaussian noise, std 0.01;
* contrast: gamma ~ U[0.7, 1.5] on min-max normalised intensities;
* histogram shift: a monotone piecewise-linear remap with 5 control points;
* coarse dropout: 2 holes of 16^3, fill 0, in the image AND the label.

Each transform is a deterministic function of its drawn parameters
(``bias_field``, ``gaussian_noise``, ``adjust_contrast``,
``apply_histogram_shift``, ``coarse_dropout``), so a test can hand the same
parameters to this module and to the JAX package's. The ``random_*``
wrappers draw the parameters: scalars from the generator (a CPU generator
keeps the step's decisions off the device), the noise volume on the
image's device from a generator seeded by it. The streams differ from
jax.random's, so only distributions, not draws, match across frameworks.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_PROB = 0.3


def _uniform(gen: torch.Generator, shape=(), lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _normalized_coords(shape, device):
    """Per-axis coordinate grids in [-1, 1], each of the volume's shape."""
    coords = []
    for ax, n in enumerate(shape):
        r = torch.linspace(-1.0, 1.0, n, device=device)
        coords.append(r.reshape([-1 if i == ax else 1 for i in range(len(shape))]).expand(shape))
    return coords


def _terms(degree: int):
    return [(i, j, k) for i in range(degree + 1) for j in range(degree + 1 - i)
            for k in range(degree + 1 - i - j)]


def bias_field(image: torch.Tensor, coeffs, degree: int = 3) -> torch.Tensor:
    """image (C, D, H, W) * exp(sum_t coeffs[t] x^i y^j z^k), accumulated
    term by term."""
    x, y, z = _normalized_coords(image.shape[1:], image.device)
    field = torch.zeros(image.shape[1:], dtype=image.dtype, device=image.device)
    for t, (i, j, k) in enumerate(_terms(degree)):
        field = field + coeffs[t] * x**i * y**j * z**k
    return image * torch.exp(field)[None]


def random_bias_field(gen, image, degree: int = 3, coeff_range=(0.0, 0.1)):
    coeffs = _uniform(gen, (len(_terms(degree)),), *coeff_range).tolist()
    return bias_field(image, coeffs, degree)


def gaussian_noise(image: torch.Tensor, noise: torch.Tensor, mean: float = 0.0,
                   std: float = 0.01) -> torch.Tensor:
    return image + mean + std * noise


def random_gaussian_noise(gen, image, mean: float = 0.0, std: float = 0.01):
    seed = int(torch.randint(0, 2**62, (), generator=gen, device=gen.device))
    dev_gen = torch.Generator(device=image.device).manual_seed(seed)
    noise = torch.randn(image.shape, generator=dev_gen, device=image.device, dtype=image.dtype)
    return gaussian_noise(image, noise, mean, std)


def adjust_contrast(image: torch.Tensor, gamma: float) -> torch.Tensor:
    """Gamma adjustment on min-max normalised intensities (MONAI semantics)."""
    lo = image.min()
    rng = image.max() - lo
    eps = 1e-7
    norm = (image - lo) / (rng + eps)
    return torch.pow(norm, gamma) * (rng + eps) + lo


def random_adjust_contrast(gen, image, gamma_range=(0.7, 1.5)):
    return adjust_contrast(image, float(_uniform(gen, (), *gamma_range)))


def apply_histogram_shift(image: torch.Tensor, dst) -> torch.Tensor:
    """Monotone piecewise-linear remap onto the destination control points
    ``dst`` in [0, 1] (sources evenly span [min, max]), segment by segment."""
    dst = [float(v) for v in dst]
    lo, hi = image.min(), image.max()
    span = hi - lo + 1e-7
    norm = torch.clamp((image - lo) / span, 0.0, 1.0)
    n_seg = len(dst) - 1
    t = norm * n_seg
    shifted = torch.zeros_like(norm)
    for k in range(n_seg):
        seg_val = dst[k] + (dst[k + 1] - dst[k]) * (t - k)
        in_seg = (t >= k) & (t < k + 1) if k < n_seg - 1 else (t >= k)
        shifted = torch.where(in_seg, seg_val, shifted)
    return shifted * span + lo


def random_histogram_shift(gen, image, num_control_points: int = 5):
    interior = torch.sort(_uniform(gen, (num_control_points - 2,))).values.tolist()
    return apply_histogram_shift(image, [0.0, *interior, 1.0])


def coarse_dropout(image: torch.Tensor, label: torch.Tensor, starts, hole_size=(16, 16, 16),
                   fill_value: float = 0.0):
    """Zero the boxes [start, start + hole_size) (one (d, h, w) start per
    hole) in image (C, D, H, W) AND label (D, H, W)."""
    spatial = image.shape[1:]
    keep = torch.ones(spatial, dtype=torch.bool, device=image.device)
    for start in starts:
        inside = torch.ones(spatial, dtype=torch.bool, device=image.device)
        for ax in range(3):
            idx = torch.arange(spatial[ax], device=image.device).reshape(
                [-1 if i == ax else 1 for i in range(3)])
            inside = inside & (idx >= start[ax]) & (idx < start[ax] + hole_size[ax])
        keep = keep & ~inside
    image = torch.where(keep[None], image, torch.full((), fill_value, dtype=image.dtype,
                                                      device=image.device))
    label = torch.where(keep, label, torch.full((), int(fill_value), dtype=label.dtype,
                                                device=label.device))
    return image, label


def random_coarse_dropout(gen, image, label, holes: int = 2, hole_size=(16, 16, 16)):
    spatial = image.shape[1:]
    starts = [[int(torch.randint(0, max(spatial[ax] - hole_size[ax], 0) + 1, (),
                                 generator=gen, device=gen.device)) for ax in range(3)]
              for _ in range(holes)]
    return coarse_dropout(image, label, starts, hole_size)


def augment_sample(gen, image, label, prob: float = DEFAULT_PROB):
    """The reference pipeline on one (1, D, H, W) image and (D, H, W) label."""
    apply = (_uniform(gen, (5,)) < prob).tolist()
    if apply[0]:
        image = random_bias_field(gen, image)
    if apply[1]:
        image = random_gaussian_noise(gen, image)
    if apply[2]:
        image = random_adjust_contrast(gen, image)
    if apply[3]:
        image = random_histogram_shift(gen, image)
    if apply[4]:
        image, label = random_coarse_dropout(gen, image, label)
    return image, label


def augment_batch(gen, images, labels, prob: float = DEFAULT_PROB):
    """Per-sample augmentation over the batch axis."""
    out = [augment_sample(gen, i, l, prob) for i, l in zip(images, labels)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def augmented_pair(data_root, index: int = 0, seed: int = 0, prob: float = 1.0,
                   device="cuda", modalities=None):
    """(original image, augmented image, original label, augmented label) of
    sample ``index`` of the CombinedDataset at ``data_root``: (D, H, W)
    tensors on ``device``, the images fp32 and the labels int32, augmented
    by :func:`augment_sample` from a generator seeded with ``seed``. The
    quickstart's demo and the augmentation QA script draw it."""
    from multimodal_segmentation_project_tpu_torch.data.dataset import CombinedDataset

    img, lbl = CombinedDataset(data_root, modalities=modalities, verbose=False)[index]
    image = torch.tensor(img, device=device)  # (1, D, H, W) float32
    label = torch.tensor(np.asarray(lbl, np.int32), device=device)
    aug_img, aug_lbl = augment_sample(torch.Generator().manual_seed(seed), image, label, prob)
    return image[0], aug_img[0], label, aug_lbl
