"""``.pth`` checkpoints in the reference layout: a dict whose
``model_state_dict`` holds the model's state dict. JAX msgpack
checkpoints are not read here: that needs flax."""

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


def save_train_checkpoint(path: str, state, epoch: int, best_val_dice: float, scheduler,
                          train_metrics: dict, val_metrics: dict, encoder_frozen: bool) -> str:
    """A training checkpoint in the reference ``.pth`` layout (epoch,
    model/optimizer state dicts, the epoch's losses and Dice, the frozen
    flag), plus what a true resume needs: the scheduler, the best val Dice
    and the train state (step, LR, freeze, accumulator). ``epoch`` counts
    finished epochs. Written atomically."""
    ckpt = {
        "epoch": epoch,
        "model_state_dict": state.model.state_dict(),
        "optimizer_state_dict": state.optimizer.state_dict(),
        "scheduler_state_dict": scheduler.state_dict(),
        "train_loss": train_metrics.get("loss"),
        "val_loss": val_metrics.get("loss"),
        "train_dice": train_metrics.get("dice"),
        "val_dice": val_metrics.get("dice"),
        "best_val_dice": best_val_dice,
        "encoder_frozen": encoder_frozen,
        "train_state": state.state_dict(),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


def load_train_checkpoint(path: str) -> dict:
    """A checkpoint written by :func:`save_train_checkpoint`, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
