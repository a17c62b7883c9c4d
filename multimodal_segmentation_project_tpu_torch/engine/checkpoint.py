"""Checkpoints in two formats.

* ``.pth`` in the reference layout: a dict whose ``model_state_dict`` holds
  the model's state dict (``Trainer.save_checkpoint`` writes a train
  checkpoint in this layout for a ``.pth`` path).
* The JAX package's ``.msgpack`` (``multimodal_segmentation_project_tpu/
  engine/checkpoint.py``): one flax-serialized tree and a JSON sidecar
  ``<path>.json`` with the scalar metadata. :func:`save_checkpoint`,
  :func:`load_checkpoint`, :func:`load_metadata` and
  :func:`state_checkpoint_tree` are its counterparts, on the port's own
  codec (``engine/msgpack_codec.py``), so the port reads and writes the
  files without flax. The train CLIs write these, under the JAX CLIs' names.

:func:`load_params_any` initialises a model from either, by suffix, with
the JAX package's strict and non-strict semantics.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from multimodal_segmentation_project_tpu_torch.engine import msgpack_codec
from multimodal_segmentation_project_tpu_torch.engine.interop import (
    STATS,
    jax_path,
    load_reference_state_dict,
    read_msgpack,
    state_dict_to_trees,
    trees_to_state_dict,
)


def save_pth(path: str, model: torch.nn.Module) -> str:
    """Write ``{"model_state_dict": model.state_dict()}`` atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save({"model_state_dict": model.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def load_pth(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference-layout ``.pth`` into ``model`` strictly: a missing or
    unexpected key, or a shape mismatch, raises."""
    model.load_state_dict(load_reference_state_dict(path), strict=True)
    return model


def load_pth_nonstrict(model: torch.nn.Module, path: str) -> list[str]:
    """Load a reference-layout ``.pth`` into ``model`` as the JAX package's
    non-strict pretrained load does (``engine/interop.py:_merge_into``): a
    key of the model that the checkpoint lacks, or holds at another shape,
    keeps the model's value; keys only the checkpoint has are ignored.
    (``load_state_dict(strict=False)`` would still raise on a shape
    mismatch.) Returns the keys that kept the model's value."""
    return _merge(model, load_reference_state_dict(path).get, strict=False)


_KEEP = object()  # a lookup's answer for an entry that keeps the model's value silently


def _merge(model: torch.nn.Module, lookup, strict: bool) -> list[str]:
    """Load ``lookup(name)`` (a reference-layout tensor, None where the
    checkpoint lacks it, or ``_KEEP``) into each entry of ``model``'s state
    dict. A missing or shape-mismatched entry raises a KeyError naming it
    when ``strict``, else keeps the model's value and is returned."""
    merged, kept = {}, []
    for name, value in model.state_dict().items():
        src = lookup(name)
        if src is _KEEP:
            merged[name] = value
        elif src is not None and tuple(src.shape) == tuple(value.shape):
            merged[name] = src.to(value.dtype)
        elif strict:
            raise KeyError(f"checkpoint missing or mismatched param '{'/'.join(jax_path(name))}' "
                           f"({name}, shape {tuple(value.shape)})")
        else:
            merged[name] = value
            kept.append(name)
    model.load_state_dict(merged, strict=True)
    return kept


def save_train_checkpoint(path: str, state, epoch: int, best_val_dice: float, scheduler,
                          train_metrics: dict, val_metrics: dict, encoder_frozen: bool,
                          extra: dict | None = None) -> str:
    """A training checkpoint in the reference ``.pth`` layout (epoch,
    model/optimizer state dicts, the epoch's losses and Dice, the frozen
    flag), plus what a true resume needs: the scheduler (None without
    one), the best val Dice and the train state (step, LR, freeze,
    accumulator). ``epoch`` counts finished epochs. ``extra`` entries are
    added as they are (DANN: the discriminator's states). Written
    atomically."""
    ckpt = {
        "epoch": epoch,
        "model_state_dict": state.model.state_dict(),
        "optimizer_state_dict": state.optimizer.state_dict(),
        "scheduler_state_dict": scheduler.state_dict() if scheduler is not None else None,
        "train_loss": train_metrics.get("loss"),
        "val_loss": val_metrics.get("loss"),
        "train_dice": train_metrics.get("dice"),
        "val_dice": val_metrics.get("dice"),
        "best_val_dice": best_val_dice,
        "encoder_frozen": encoder_frozen,
        "train_state": state.state_dict(),
        **(extra or {}),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


def load_train_checkpoint(path: str) -> dict:
    """A checkpoint written by :func:`save_train_checkpoint`, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


# ---- the JAX package's .msgpack checkpoints ------------------------------------------


def _write_atomic(path: str, payload: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)  # no torn checkpoint on a crash


def save_checkpoint(path: str, tree: dict, metadata: dict | None = None) -> str:
    """Write ``tree`` as flax's msgpack, atomically, and ``metadata`` as the
    JSON sidecar ``<path>.json``."""
    _write_atomic(path, msgpack_codec.packb(tree))
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=float)
    return path


# the JAX package's load_checkpoint(path) without a target: the raw tree, as
# flax.serialization.msgpack_restore gives it (bfloat16 leaves as tensors)
load_checkpoint = read_msgpack


def load_metadata(path: str) -> dict:
    """The JSON sidecar of ``path``, or {} where there is none."""
    sidecar = path + ".json"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    return {}


def state_checkpoint_tree(state, extra: dict | None = None) -> dict:
    """A ``TrainState`` as the JAX package's ``state_checkpoint_tree`` lays it
    out (step, params, batch_stats, opt_state, trainable_mask, lr, and the
    ``extra`` entries), with its maps' keys sorted as the JAX package writes
    them. Scalars are 0-d int32 and float32 arrays."""
    params, batch_stats = state_dict_to_trees(state.model.state_dict())
    tree = {
        "step": np.asarray(state.step, np.int32),
        "params": params,
        "batch_stats": batch_stats,
        "opt_state": state.optax_state(),
        "trainable_mask": state.trainable_mask(),
        "lr": np.asarray(state.lr, np.float32),
        **(extra or {}),
    }
    return {k: tree[k] for k in sorted(tree)}


def load_tree_into(model: torch.nn.Module, params: dict, batch_stats: dict | None,
                   strict: bool = True) -> list[str]:
    """Load JAX-layout (params, batch_stats) trees into ``model``; see
    :func:`_load_converted`."""
    return _load_converted(model, trees_to_state_dict(params, batch_stats or {}), strict)


def _load_converted(model: torch.nn.Module, sd: dict, strict: bool) -> list[str]:
    """Load a state dict converted from JAX trees (``trees_to_state_dict``)
    into ``model`` with the JAX package's semantics (``checkpoint.py:
    load_params_only``): a param missing from the checkpoint or held there
    at another shape raises a KeyError naming its JAX path, or with
    ``strict=False`` keeps the model's value; entries only the checkpoint
    has are ignored. Without batch_stats the running statistics keep the
    model's values; with them they load as the params do.
    ``num_batches_tracked`` keeps the model's. Returns the names that kept
    the model's value."""
    has_stats = any(name.endswith("running_mean") for name in sd)

    def lookup(name):
        if name.endswith("num_batches_tracked") or (
                not has_stats and jax_path(name)[-1] in STATS):
            return _KEEP
        return sd.get(name)

    return _merge(model, lookup, strict)


TRAIN_KEYS = ("step", "params", "batch_stats", "opt_state", "trainable_mask", "lr")


def restore_train_state(state, tree: dict) -> None:
    """Restore a ``TrainState`` from the JAX package's train checkpoint tree
    (``checkpoint.py:restore_train_state``): the model and its batch
    statistics strictly, AdamW, the accumulator, the frozen prefixes, the
    step and the LR (float32 in the file)."""
    missing = [k for k in TRAIN_KEYS if k not in tree]
    if missing:
        raise KeyError(f"not a train checkpoint of the JAX package: it lacks {missing}")
    load_tree_into(state.model, tree["params"], tree["batch_stats"], strict=True)
    state.load_optax_state(tree["opt_state"], tree["trainable_mask"])
    state.step = int(tree["step"])
    state.lr = float(tree["lr"])


def load_params_any(model: torch.nn.Module, path: str, strict: bool = True) -> list[str]:
    """Initialise ``model`` from a reference ``.pth``/``.pt`` or a JAX
    ``.msgpack`` checkpoint, by suffix, as the JAX package's
    ``load_params_any`` does. ``strict`` raises on a missing or mismatched
    param; otherwise such params keep the model's values, and their names
    are returned."""
    if str(path).endswith((".pth", ".pt")):
        if strict:
            load_pth(model, path)
            return []
        return load_pth_nonstrict(model, path)
    return _load_converted(model, load_reference_state_dict(path), strict)
