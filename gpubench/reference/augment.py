"""The training recipe's augmentation, in plain torch: a frozen copy.

The same five transforms, probabilities and draw order as the program's
(``ops/augment.py`` of the port at the time this benchmark was written):
per sample five uniforms decide which transforms run (p = 0.3 each), then
each chosen transform draws its parameters from the step's generator in
order. The Gaussian noise volume is drawn on the image's device from a
generator seeded by one draw of the step's generator. So given the same
step generator the reference works the augmented volumes out again by
itself; it reads nothing the program made.
"""

from __future__ import annotations

import torch

PROB = 0.3
DEGREE = 3


def _uniform(gen, shape=(), lo=0.0, hi=1.0):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _coords(shape, device):
    out = []
    for ax, n in enumerate(shape):
        r = torch.linspace(-1.0, 1.0, n, device=device)
        out.append(r.reshape([-1 if i == ax else 1 for i in range(len(shape))]).expand(shape))
    return out


def _terms(degree=DEGREE):
    return [(i, j, k) for i in range(degree + 1) for j in range(degree + 1 - i)
            for k in range(degree + 1 - i - j)]


def _bias_field(gen, image):
    coeffs = _uniform(gen, (len(_terms()),), 0.0, 0.1).tolist()
    x, y, z = _coords(image.shape[1:], image.device)
    field = torch.zeros(image.shape[1:], dtype=image.dtype, device=image.device)
    for c, (i, j, k) in zip(coeffs, _terms()):
        field = field + c * x**i * y**j * z**k
    return image * torch.exp(field)[None]


def _noise(gen, image, std=0.01):
    seed = int(torch.randint(0, 2**62, (), generator=gen, device=gen.device))
    dev_gen = torch.Generator(device=image.device).manual_seed(seed)
    noise = torch.randn(image.shape, generator=dev_gen, device=image.device, dtype=image.dtype)
    return image + std * noise


def _contrast(gen, image):
    gamma = float(_uniform(gen, (), 0.7, 1.5))
    lo = image.min()
    span = image.max() - lo + 1e-7
    return torch.pow((image - lo) / span, gamma) * span + lo


def _histogram_shift(gen, image, points=5):
    dst = [0.0, *torch.sort(_uniform(gen, (points - 2,))).values.tolist(), 1.0]
    lo, hi = image.min(), image.max()
    span = hi - lo + 1e-7
    t = torch.clamp((image - lo) / span, 0.0, 1.0) * (points - 1)
    seg = torch.clamp(t.floor(), max=points - 2)  # the top value belongs to the last segment
    k = seg.long()
    table = torch.tensor(dst, device=image.device, dtype=image.dtype)
    out = table[k] + (table[k + 1] - table[k]) * (t - seg)
    return out * span + lo


def _coarse_dropout(gen, image, label, holes=2, size=16):
    spatial = image.shape[1:]
    starts = [[int(torch.randint(0, max(spatial[ax] - size, 0) + 1, (), generator=gen,
                                 device=gen.device)) for ax in range(3)] for _ in range(holes)]
    keep = torch.ones(spatial, dtype=torch.bool, device=image.device)
    for s in starts:
        box = torch.zeros(spatial, dtype=torch.bool, device=image.device)
        box[s[0]:s[0] + size, s[1]:s[1] + size, s[2]:s[2] + size] = True
        keep &= ~box
    return image * keep[None], torch.where(keep, label, torch.zeros_like(label))


def augment_sample(gen, image, label):
    """image (1, D, H, W) fp32, label (D, H, W) -> the augmented pair."""
    apply = (_uniform(gen, (5,)) < PROB).tolist()
    if apply[0]:
        image = _bias_field(gen, image)
    if apply[1]:
        image = _noise(gen, image)
    if apply[2]:
        image = _contrast(gen, image)
    if apply[3]:
        image = _histogram_shift(gen, image)
    if apply[4]:
        image, label = _coarse_dropout(gen, image, label)
    return image, label


def augment_batch(gen, images, labels):
    out = [augment_sample(gen, i, l) for i, l in zip(images, labels)]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])
