"""Weight interop between the port and the JAX package.

The port's ``UNet3D`` carries the reference PyTorch state-dict layout,
which ``multimodal_segmentation_project_tpu/engine/interop.py:
torch_state_dict_to_trees`` maps onto the JAX param and batch_stats trees.
:func:`trees_to_state_dict` is its exact inverse: JAX-package weights (as
numpy) become a state dict that the port loads with ``strict=True``.

  JAX tree                               state dict (reference layout)
  -------------------------------------  -------------------------------------------
  enc{i}/conv{j}/kernel (3,3,3,Cin,Cout) encoder.{i}.double_conv.{0|4}.weight (Cout,Cin,3,3,3)
  enc{i}/bn{j}/{scale,bias}              encoder.{i}.double_conv.{1|5}.{weight,bias}
  batch_stats enc{i}/bn{j}/{mean,var}    encoder.{i}.double_conv.{1|5}.running_{mean,var}
  bottleneck/...                         bottleneck.double_conv...
  dec{i}/up/kernel (2,2,2,Cin,Cout)      upconvs.{i}.weight (Cin,Cout,2,2,2)
  dec{i}/conv/...                        decoder.{i}.double_conv...
  head_kernel (Cin,Co), head_bias        final_conv.weight (Co,Cin,1,1,1), final_conv.bias

:func:`discriminator_params_to_state_dict` does the same for the DANN
discriminator: a Dense ``{fc0,fc1,fc2,out}/kernel`` (in, out) becomes
``{name}.weight`` (out, in), and its ``bias`` ``{name}.bias``.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def trees_to_state_dict(params, batch_stats) -> dict[str, torch.Tensor]:
    """(params, batch_stats) trees of the JAX UNet3D -> reference state dict."""
    sd: dict[str, torch.Tensor] = {}

    def double_conv(src_p, src_s, prefix):
        for j, conv_idx, bn_idx in ((0, 0, 1), (1, 4, 5)):
            conv, bn, st = src_p[f"conv{j}"], src_p[f"bn{j}"], src_s[f"bn{j}"]
            sd[f"{prefix}.double_conv.{conv_idx}.weight"] = _t(
                np.transpose(np.asarray(conv["kernel"]), (4, 3, 0, 1, 2)))
            sd[f"{prefix}.double_conv.{conv_idx}.bias"] = _t(conv["bias"])
            sd[f"{prefix}.double_conv.{bn_idx}.weight"] = _t(bn["scale"])
            sd[f"{prefix}.double_conv.{bn_idx}.bias"] = _t(bn["bias"])
            sd[f"{prefix}.double_conv.{bn_idx}.running_mean"] = _t(st["mean"])
            sd[f"{prefix}.double_conv.{bn_idx}.running_var"] = _t(st["var"])
            sd[f"{prefix}.double_conv.{bn_idx}.num_batches_tracked"] = torch.tensor(0)

    num_levels = len([k for k in params if str(k).startswith("enc")])
    for i in range(num_levels):
        double_conv(params[f"enc{i}"], batch_stats[f"enc{i}"], f"encoder.{i}")
    double_conv(params["bottleneck"], batch_stats["bottleneck"], "bottleneck")
    for i in range(num_levels):
        up = params[f"dec{i}"]["up"]
        sd[f"upconvs.{i}.weight"] = _t(np.transpose(np.asarray(up["kernel"]), (3, 4, 0, 1, 2)))
        sd[f"upconvs.{i}.bias"] = _t(up["bias"])
        double_conv(params[f"dec{i}"]["conv"], batch_stats[f"dec{i}"]["conv"], f"decoder.{i}")
    sd["final_conv.weight"] = _t(np.asarray(params["head_kernel"]).T[:, :, None, None, None])
    sd["final_conv.bias"] = _t(params["head_bias"])
    return sd


def discriminator_params_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX ``DomainDiscriminator``'s params -> the port's state dict."""
    sd: dict[str, torch.Tensor] = {}
    for name, dense in params.items():
        sd[f"{name}.weight"] = _t(np.asarray(dense["kernel"]).T)
        sd[f"{name}.bias"] = _t(dense["bias"])
    return sd


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """State dict of a reference-layout ``.pth``: the ``model_state_dict``
    entry when present, with DDP ``module.`` prefixes stripped. A JAX
    ``.msgpack`` checkpoint is refused: the port reads ``.pth`` only."""
    if str(path).endswith(".msgpack"):
        raise ValueError(
            f"{path}: the port reads .pth checkpoints only; it does not read the JAX "
            "package's .msgpack checkpoints")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.removeprefix("module."): v for k, v in sd.items()}
