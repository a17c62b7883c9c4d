"""Segmentation metrics, in plain torch on the tensors' device.

Port of ``multimodal_segmentation_project_tpu/ops/metrics.py``'s
``per_class_dice_iou``, ``per_class_dice_iou_per_sample`` (eval: an organ
absent from the target scores 0.0, the reference eval's convention) and
``segmentation_metrics`` (train and val: the macro average over the
foreground classes PRESENT in the target, 0 when none is). eps = 1e-5 on
numerator and denominator throughout.
"""

from __future__ import annotations

import torch

EPS = 1e-5


def _scores(inter, psum, tsum) -> dict[str, torch.Tensor]:
    dice = (2.0 * inter + EPS) / (psum + tsum + EPS)
    iou = (inter + EPS) / (psum + tsum - inter + EPS)
    present = tsum > 0
    zero = torch.zeros((), dtype=dice.dtype, device=dice.device)
    return {
        "dice": torch.where(present, dice, zero),
        "iou": torch.where(present, iou, zero),
        "present": present,
    }


def per_class_dice_iou_per_sample(
    pred_classes: torch.Tensor, labels: torch.Tensor, num_classes: int = 4
) -> dict[str, torch.Tensor]:
    """(B, *spatial) class maps -> 'dice', 'iou', 'present' of shape (B, C-1)."""
    spatial = tuple(range(1, pred_classes.dim()))
    inter, psum, tsum = [], [], []
    for c in range(1, num_classes):
        pm = pred_classes == c
        tm = labels == c
        # integer counts are exact; fp32 holds them exactly below 2**24 voxels
        inter.append((pm & tm).sum(dim=spatial).float())
        psum.append(pm.sum(dim=spatial).float())
        tsum.append(tm.sum(dim=spatial).float())
    return _scores(torch.stack(inter, 1), torch.stack(psum, 1), torch.stack(tsum, 1))


def per_class_dice_iou(
    pred_classes: torch.Tensor, labels: torch.Tensor, num_classes: int = 4
) -> dict[str, torch.Tensor]:
    """Per-class scores pooled over the whole batch: shape (C-1,) each."""
    flat_p = pred_classes.reshape(1, -1)
    flat_l = labels.reshape(1, -1)
    out = per_class_dice_iou_per_sample(flat_p, flat_l, num_classes)
    return {k: v[0] for k, v in out.items()}


def segmentation_metrics(logits: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
    """Train/val 'dice', 'iou' and 'acc' of one batch, as 0-d fp32 tensors:
    argmax over the class axis, global sums over the batch, macro average
    over the foreground classes present in the target."""
    pred = logits.argmax(dim=1)
    inter, psum, tsum = [], [], []
    for c in range(1, logits.shape[1]):
        pm, tm = pred == c, labels == c
        inter.append((pm & tm).sum().float())
        psum.append(pm.sum().float())
        tsum.append(tm.sum().float())
    inter, psum, tsum = torch.stack(inter), torch.stack(psum), torch.stack(tsum)
    present = tsum > 0
    valid = present.sum().clamp(min=1).float()
    zero = torch.zeros((), device=logits.device)
    dice = (2.0 * inter + EPS) / (psum + tsum + EPS)
    iou = (inter + EPS) / (psum + tsum - inter + EPS)
    return {
        "dice": torch.where(present, dice, zero).sum() / valid,
        "iou": torch.where(present, iou, zero).sum() / valid,
        "acc": (pred == labels).float().mean(),
    }
