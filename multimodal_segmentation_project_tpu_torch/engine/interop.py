"""Weight interop between the port and the JAX package.

The port's ``UNet3D`` carries the reference PyTorch state-dict layout,
which ``multimodal_segmentation_project_tpu/engine/interop.py:
torch_state_dict_to_trees`` maps onto the JAX param and batch_stats trees.
:func:`trees_to_state_dict` is its exact inverse: JAX-package weights (as
numpy) become a state dict that the port loads with ``strict=True``, and
:func:`state_dict_to_trees` maps back, as the JAX package does.

  JAX tree                               state dict (reference layout)
  -------------------------------------  -------------------------------------------
  enc{i}/conv{j}/kernel (3,3,3,Cin,Cout) encoder.{i}.double_conv.{0|4}.weight (Cout,Cin,3,3,3)
  enc{i}/bn{j}/{scale,bias}              encoder.{i}.double_conv.{1|5}.{weight,bias}
  batch_stats enc{i}/bn{j}/{mean,var}    encoder.{i}.double_conv.{1|5}.running_{mean,var}
  bottleneck/...                         bottleneck.double_conv...
  dec{i}/up/kernel (2,2,2,Cin,Cout)      upconvs.{i}.weight (Cin,Cout,2,2,2)
  dec{i}/conv/...                        decoder.{i}.double_conv...
  head_kernel (Cin,Co), head_bias        final_conv.weight (Co,Cin,1,1,1), final_conv.bias

``num_batches_tracked`` has no JAX counterpart: it reads as 0 and is not
written. SwinUNETR, which the JAX package does not have, keeps its own
(MONAI's) names: ``swinViT.layers1.0.blocks.0.attn.qkv.weight`` is the path
``swinViT/layers1/0/blocks/0/attn/qkv/weight``, each leaf in the torch
layout, so its checkpoints nest the state dict as it stands. The DANN discriminator maps the same way: a Dense
``{fc0,fc1,fc2,out}/kernel`` (in, out) is ``{name}.weight`` (out, in), and
its ``bias`` ``{name}.bias``. The per-parameter mapping
(:func:`jax_path`, :func:`named_to_tree`, :func:`tree_to_named`) also
carries anything laid out like the params, such as the Adam moments.

JAX trees are written with their keys sorted, as ``jax.device_get`` leaves
them before the JAX package serializes a checkpoint.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# The one mapping between reference names and JAX paths, read both ways:
# each rule pairs a reference-name template with a JAX-path template ('.'
# between path keys). A field in braces is an index, kept as it is, or one
# of the tables below, whose keys are the reference side's.
_FIELDS = {
    "conv": {"0": "conv0", "4": "conv1"},
    "bn": {"1": "bn0", "5": "bn1"},
    "w": {"weight": "kernel", "bias": "bias"},
    "s": {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"},
}
# the same on both sides; a SwinUNETR name (MONAI's) is its own path
_ANY = {"i": r"\d+", "fc": r"fc\d+|out", "swin": r"swinViT|encoder(?:[1-4]|10)|decoder[1-5]|out",
        "rest": r"\w+(?:\.\w+)+"}
_RULES = (
    ("final_conv.weight", "head_kernel"),
    ("final_conv.bias", "head_bias"),
    ("upconvs.{i}.{w}", "dec{i}.up.{w}"),
    ("encoder.{i}.double_conv.{conv}.{w}", "enc{i}.{conv}.{w}"),
    ("encoder.{i}.double_conv.{bn}.{s}", "enc{i}.{bn}.{s}"),
    ("decoder.{i}.double_conv.{conv}.{w}", "dec{i}.conv.{conv}.{w}"),
    ("decoder.{i}.double_conv.{bn}.{s}", "dec{i}.conv.{bn}.{s}"),
    ("bottleneck.double_conv.{conv}.{w}", "bottleneck.{conv}.{w}"),
    ("bottleneck.double_conv.{bn}.{s}", "bottleneck.{bn}.{s}"),
    ("{swin}.{rest}", "{swin}.{rest}"),  # SwinUNETR: no JAX counterpart, the torch layout
    ("{fc}.{w}", "{fc}.{w}"),  # a discriminator Dense
)
STATS = ("mean", "var")  # the batch_stats leaves


def _table(field: str, side: int) -> dict:
    """``field``'s table from ``side`` (0 reference, 1 JAX) to the other."""
    table = _FIELDS[field]
    return table if side == 0 else {v: k for k, v in table.items()}


def _regex(template: str, side: int) -> re.Pattern:
    parts = re.split(r"\{(\w+)\}", template)
    return re.compile("".join(
        re.escape(part) if k % 2 == 0 else
        f"(?P<{part}>{_ANY[part] if part in _ANY else '|'.join(_table(part, side))})"
        for k, part in enumerate(parts)))


_COMPILED = [((_regex(ref, 0), _regex(jax, 1)), (ref, jax)) for ref, jax in _RULES]


def _translate(text: str, side: int) -> str | None:
    """A reference name (side 0) as its JAX path, or back (side 1); None
    where no rule matches."""
    for regexes, templates in _COMPILED:
        m = regexes[side].fullmatch(text)
        if m:
            fill = {k: v if k in _ANY else _table(k, side)[v] for k, v in m.groupdict().items()}
            return templates[1 - side].format(**fill)
    return None


def _c(a: np.ndarray) -> np.ndarray:
    """C-contiguous and writable (torch shares it), 0-d kept 0-d
    (``np.ascontiguousarray`` makes it 1-d)."""
    return np.array(a, order="C", copy=not (a.flags.c_contiguous and a.flags.writeable))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(_c(np.asarray(a, dtype=np.float32)))


def _np32(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):  # a bfloat16 leaf decodes as a tensor
        return value.detach().cpu().float().numpy()
    return np.asarray(value, np.float32)


def jax_path(name: str) -> tuple[str, ...]:
    """The path of a reference-layout param or running statistic in the JAX
    params (or batch_stats) tree: ``encoder.1.double_conv.4.weight`` ->
    ``(enc1, conv1, kernel)``, ``upconvs.0.bias`` -> ``(dec0, up, bias)``,
    ``fc0.weight`` -> ``(fc0, kernel)``."""
    path = _translate(name, 0)
    if path is None:
        raise KeyError(f"'{name}' has no place in the JAX package's trees")
    return tuple(path.split("."))


def reference_name(path: tuple[str, ...]) -> str:
    """The inverse of :func:`jax_path`."""
    name = _translate(".".join(path), 1)
    if name is None:
        raise KeyError(f"'{'/'.join(path)}' has no place in the reference state dict")
    return name


def _layout(path: tuple[str, ...]) -> str:
    if path == ("head_kernel",):
        return "head"
    if path[-1] != "kernel":
        return "vec"
    if path[-2] == "up":
        return "upconv"
    return "conv" if path[-2].startswith("conv") else "dense"


def to_jax_layout(path: tuple[str, ...], value) -> np.ndarray:
    """A reference-layout array (tensor or numpy) -> its JAX layout, fp32."""
    a = _np32(value)
    kind = _layout(path) if a.ndim else "vec"  # a 0-d leaf: a mask entry
    if kind == "conv":
        a = a.transpose(2, 3, 4, 1, 0)
    elif kind == "upconv":
        a = a.transpose(2, 3, 4, 0, 1)
    elif kind == "head":
        a = a[:, :, 0, 0, 0].T
    elif kind == "dense":
        a = a.T
    return _c(a)


def to_reference_layout(path: tuple[str, ...], value) -> torch.Tensor:
    """The inverse of :func:`to_jax_layout`."""
    a = _np32(value)
    kind = _layout(path) if a.ndim else "vec"
    if kind == "conv":
        a = a.transpose(4, 3, 0, 1, 2)
    elif kind == "upconv":
        a = a.transpose(3, 4, 0, 1, 2)
    elif kind == "head":
        a = a.T[:, :, None, None, None]
    elif kind == "dense":
        a = a.T
    return _t(a)


def sorted_tree(tree):
    """``tree`` with every map's keys sorted, as ``jax.device_get`` returns it."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def named_to_tree(named: dict) -> dict:
    """``{reference name: array}`` -> a JAX-layout tree (sorted keys)."""
    tree: dict = {}
    for name, value in named.items():
        path = jax_path(name)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = to_jax_layout(path, value)
    return sorted_tree(tree)


def tree_leaves(tree, path: tuple = ()):
    """(path, leaf) of every leaf of a nested dict, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, (*path, k))
    else:
        yield path, tree


def tree_get(tree, path: tuple):
    """The leaf at ``path``, or None where the tree lacks it."""
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def tree_to_named(tree) -> dict[str, torch.Tensor]:
    """A JAX-layout tree -> ``{reference name: fp32 tensor}``. Leaves with no
    place in the reference layout are skipped, as the JAX package's loads
    ignore what their target lacks."""
    named = {}
    for path, leaf in tree_leaves(tree):
        name = _translate(".".join(path), 1)
        if name is not None:
            named[name] = to_reference_layout(path, leaf)
    return named


def trees_to_state_dict(params, batch_stats) -> dict[str, torch.Tensor]:
    """(params, batch_stats) trees of the JAX UNet3D -> reference state dict
    (``num_batches_tracked`` 0 beside every BatchNorm)."""
    sd = tree_to_named(params)
    for name, value in tree_to_named(batch_stats).items():
        sd[name] = value
        if name.endswith("running_mean"):
            sd[name.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
    return sd


def state_dict_to_trees(state_dict: dict) -> tuple[dict, dict]:
    """Reference state dict -> (params, batch_stats) trees of the JAX
    UNet3D, fp32 numpy; the inverse of :func:`trees_to_state_dict`. DDP
    ``module.`` prefixes are stripped; ``num_batches_tracked`` is dropped."""
    params, stats = {}, {}
    for name, value in state_dict.items():
        name = name.removeprefix("module.")
        if name.endswith("num_batches_tracked"):
            continue
        (stats if jax_path(name)[-1] in STATS else params)[name] = value
    return named_to_tree(params), named_to_tree(stats)


def discriminator_params_to_state_dict(params) -> dict[str, torch.Tensor]:
    """The JAX ``DomainDiscriminator``'s params -> the port's state dict."""
    return tree_to_named(params)


def state_dict_to_discriminator_params(state_dict: dict) -> dict:
    """The port discriminator's state dict -> the JAX ``DomainDiscriminator``'s
    params; the inverse of :func:`discriminator_params_to_state_dict`."""
    return named_to_tree(state_dict)


def read_msgpack(path: str):
    """The tree of a ``.msgpack`` checkpoint (``engine.msgpack_codec``)."""
    from multimodal_segmentation_project_tpu_torch.engine.msgpack_codec import unpackb

    with open(path, "rb") as f:
        return unpackb(f.read())


def checkpoint_trees(path: str) -> tuple[dict, dict | None]:
    """(params, batch_stats) of a JAX ``.msgpack`` checkpoint: its
    ``params`` and ``batch_stats`` entries, or the whole tree as params
    where it has no ``params`` entry (``checkpoint.py:load_params_only``).
    batch_stats is None where the checkpoint has none. A file that holds no
    array at all is refused with a ValueError."""
    raw = read_msgpack(path)
    if not isinstance(raw, dict) or not any(
            isinstance(leaf, (np.ndarray, torch.Tensor)) for _, leaf in tree_leaves(raw)):
        raise ValueError(f"{path} is not a model checkpoint: it holds no arrays")
    params = raw.get("params", raw)
    return params, raw.get("batch_stats") or None


def load_reference_state_dict(path: str) -> dict[str, torch.Tensor]:
    """State dict of a reference-layout ``.pth`` (the ``model_state_dict``
    entry when present, with DDP ``module.`` prefixes stripped), or of a JAX
    ``.msgpack`` checkpoint (its params and, when present, batch_stats)."""
    if not str(path).endswith((".pth", ".pt")):
        params, stats = checkpoint_trees(path)
        return trees_to_state_dict(params, stats or {})
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k.removeprefix("module."): v for k, v in sd.items()}
