"""``.pth`` checkpoints in the reference layout: a dict whose
``model_state_dict`` holds the model's state dict. JAX msgpack
checkpoints are not read here (a ``.msgpack`` path raises): that needs
flax."""

from __future__ import annotations

import os

import torch

from multimodal_segmentation_project_tpu_torch.engine.interop import load_reference_state_dict


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
    saved = load_reference_state_dict(path)
    merged, kept = {}, []
    for key, value in model.state_dict().items():
        src = saved.get(key)
        if src is not None and tuple(src.shape) == tuple(value.shape):
            merged[key] = src.to(value.dtype)
        else:
            merged[key] = value
            kept.append(key)
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
