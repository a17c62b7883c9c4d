"""Seeded weights of the UNet3D and the DANN discriminator, made on the device.

The benchmark makes the weights and hands the same tensors to the program
(loaded into its modules) and to the plain reference. The names are the
reference layout's state-dict keys, which the port's modules carry. All
draws come from one ``torch.Generator`` on the device, in one call per
network: a flat normal vector, cut into the tensors and scaled per kind.

* 3x3x3 convs and transpose convs: He normal (std sqrt(2 / fan_in));
* the 1x1x1 head and the discriminator's layers: LeCun normal;
* biases: 0.05 N(0, 1);
* BatchNorm: scale 1 + 0.1 N, shift 0.1 N, running mean 0.1 N, running
  variance exp(0.2 N), so that the eval forward's folding is not the
  identity.
"""

from __future__ import annotations

import math

import torch

DISC_HIDDEN = (256, 128, 64)
NUM_DOMAINS = 2


def _double_conv(prefix: str, cin: int, cout: int) -> list:
    out = []
    for conv, bn, ci in ((0, 1, cin), (4, 5, cout)):
        out += [(f"{prefix}.double_conv.{conv}.weight", (cout, ci, 3, 3, 3), "he", ci * 27),
                (f"{prefix}.double_conv.{conv}.bias", (cout,), "bias", 0),
                (f"{prefix}.double_conv.{bn}.weight", (cout,), "bn_scale", 0),
                (f"{prefix}.double_conv.{bn}.bias", (cout,), "bn_shift", 0),
                (f"{prefix}.double_conv.{bn}.running_mean", (cout,), "bn_mean", 0),
                (f"{prefix}.double_conv.{bn}.running_var", (cout,), "bn_var", 0)]
    return out


def unet3d_layout(features, in_channels: int = 1, classes: int = 4) -> list:
    """[(name, shape, kind, fan_in)] of the UNet3D's parameters and BatchNorm
    statistics, in the reference layout."""
    out, cin = [], in_channels
    for i, f in enumerate(features):
        out += _double_conv(f"encoder.{i}", cin, f)
        cin = f
    out += _double_conv("bottleneck", features[-1], 2 * features[-1])
    for i, f in enumerate(reversed(features)):
        out += [(f"upconvs.{i}.weight", (2 * f, f, 2, 2, 2), "he", 2 * f * 8),
                (f"upconvs.{i}.bias", (f,), "bias", 0)]
        out += _double_conv(f"decoder.{i}", 2 * f, f)
    out += [("final_conv.weight", (classes, features[0], 1, 1, 1), "lecun", features[0]),
            ("final_conv.bias", (classes,), "bias", 0)]
    return out


def discriminator_layout(in_features: int) -> list:
    out, cin = [], in_features
    for name, cout in zip(("fc0", "fc1", "fc2", "out"), (*DISC_HIDDEN, NUM_DOMAINS)):
        out += [(f"{name}.weight", (cout, cin), "lecun", cin), (f"{name}.bias", (cout,), "bias", 0)]
        cin = cout
    return out


def make_weights(layout: list, seed: int, device) -> dict:
    """{name: fp32 tensor on ``device``} for ``layout``, from one normal draw."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(math.prod(shape) for _, shape, _, _ in layout)
    flat = torch.randn(total, generator=gen, device=device)
    out, offset = {}, 0
    for name, shape, kind, fan_in in layout:
        n = math.prod(shape)
        z = flat[offset:offset + n].view(shape)
        offset += n
        if kind == "he":
            t = z * math.sqrt(2.0 / fan_in)
        elif kind == "lecun":
            t = z * math.sqrt(1.0 / fan_in)
        elif kind == "bias":
            t = 0.05 * z
        elif kind == "bn_scale":
            t = 1.0 + 0.1 * z
        elif kind in ("bn_shift", "bn_mean"):
            t = 0.1 * z
        else:  # bn_var
            t = torch.exp(0.2 * z)
        out[name] = t.contiguous()
    return out


def load_into(module: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into ``module``'s parameters and buffers in place (an
    optimizer built over them keeps them). Every parameter and statistic must
    be given; only BatchNorm's ``num_batches_tracked`` may be left out."""
    result = module.load_state_dict(weights, strict=False)
    missing = [k for k in result.missing_keys if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise KeyError(f"weights do not match the module: missing {missing}, "
                       f"unexpected {result.unexpected_keys}")
