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
