"""Segmentation metrics, in plain torch on the tensors' device.

Port of ``multimodal_segmentation_project_tpu/ops/metrics.py``, every
function with the JAX one's arguments, defaults and epsilons:

* ``calculate_dice``, ``calculate_iou``, ``calculate_accuracy`` and
  ``segmentation_metrics`` (train and val: argmax over the class axis,
  global sums over the batch, the macro average over the foreground classes
  PRESENT in the target, 0 when none is) and
  ``segmentation_metrics_per_sample`` (the same per volume);
* ``per_class_dice_iou`` and ``per_class_dice_iou_per_sample`` (eval: an
  organ absent from the target scores 0.0, the reference eval's
  convention);
* the legacy binary trio ``dice_score``, ``iou_score``, ``accuracy_score``
  (a 0.5 threshold on ``pred``, eps = 1e-6), which no CLI uses.

eps = 1e-5 on numerator and denominator elsewhere. Every multiclass metric
reads its sums from one helper, :func:`_confusion_sums`.

On a multi-device mesh (``parallel/mesh.py``) the counts are all-reduced as
integers: the batch-pooled ones over the whole mesh, the per-sample ones
over the spatial group (a volume's rows lie on one data rank), so every
rank reads the metrics of the global batch, or of its own volumes.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.parallel.mesh import (
    MESH_AXES,
    SPATIAL_AXIS,
    active_multi_mesh,
    reduce_count,
    reduce_sum,
)

EPS = 1e-5


def _confusion_sums(pred_classes: torch.Tensor, labels: torch.Tensor, num_classes: int,
                    axis: str = SPATIAL_AXIS):
    """Per-sample fp32 (intersection, pred_sum, target_sum) of classes
    1..C-1 over every axis but the first: (B, C-1) each; the integer counts
    summed over the mesh's ``axis`` first."""
    spatial = tuple(range(1, pred_classes.dim()))
    inter, psum, tsum = [], [], []
    for c in range(1, num_classes):
        pm = pred_classes == c
        tm = labels == c
        inter.append((pm & tm).sum(dim=spatial))
        psum.append(pm.sum(dim=spatial))
        tsum.append(tm.sum(dim=spatial))
    counts = reduce_sum(torch.stack([torch.stack(inter, 1), torch.stack(psum, 1),
                                     torch.stack(tsum, 1)]), axis)
    # integer counts are exact; fp32 holds them exactly below 2**24 voxels
    return tuple(counts.float())


def _global_sums(logits: torch.Tensor, labels: torch.Tensor):
    """The argmax and its sums pooled over the whole (global) batch: (C-1,)
    each."""
    pred = logits.argmax(dim=1)
    sums = _confusion_sums(pred.reshape(1, -1), labels.reshape(1, -1), logits.shape[1],
                           MESH_AXES)
    return pred, tuple(s[0] for s in sums)


def _accuracy(pred: torch.Tensor, labels: torch.Tensor, dims=None,
              axis: str = MESH_AXES) -> torch.Tensor:
    """The share of voxels whose class is right, over ``dims`` (all), the
    counts summed over the mesh's ``axis`` first."""
    hit = pred == labels
    if active_multi_mesh() is None:
        return hit.float().mean() if dims is None else hit.float().mean(dim=dims)
    n = hit.numel() if dims is None else hit[0].numel()
    total = hit.sum() if dims is None else hit.sum(dim=dims)
    return reduce_sum(total, axis).float() / reduce_count(n, axis)


def _scores(inter, psum, tsum, eps: float = EPS) -> dict[str, torch.Tensor]:
    dice = (2.0 * inter + eps) / (psum + tsum + eps)
    iou = (inter + eps) / (psum + tsum - inter + eps)
    present = tsum > 0
    zero = torch.zeros((), dtype=dice.dtype, device=dice.device)
    return {
        "dice": torch.where(present, dice, zero),
        "iou": torch.where(present, iou, zero),
        "present": present,
    }


def _present_mean(scores: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """The mean over the last axis of the classes present (absent ones hold
    0), 0 when none is."""
    return scores.sum(-1) / present.sum(-1).clamp(min=1)


def per_class_dice_iou_per_sample(
    pred_classes: torch.Tensor, labels: torch.Tensor, num_classes: int = 4
) -> dict[str, torch.Tensor]:
    """(B, *spatial) class maps -> 'dice', 'iou', 'present' of shape (B, C-1)."""
    return _scores(*_confusion_sums(pred_classes, labels, num_classes))


def per_class_dice_iou(
    pred_classes: torch.Tensor, labels: torch.Tensor, num_classes: int = 4
) -> dict[str, torch.Tensor]:
    """Per-class scores pooled over the whole batch: shape (C-1,) each."""
    flat_p = pred_classes.reshape(1, -1)
    flat_l = labels.reshape(1, -1)
    out = _scores(*_confusion_sums(flat_p, flat_l, num_classes, MESH_AXES))
    return {k: v[0] for k, v in out.items()}


def calculate_dice(logits: torch.Tensor, labels: torch.Tensor,
                   epsilon: float = 1e-5) -> torch.Tensor:
    """Macro dice over the foreground classes present in the target."""
    _, sums = _global_sums(logits, labels)
    s = _scores(*sums, eps=epsilon)
    return _present_mean(s["dice"], s["present"])


def calculate_iou(logits: torch.Tensor, labels: torch.Tensor,
                  epsilon: float = 1e-5) -> torch.Tensor:
    """Macro IoU over the foreground classes present in the target."""
    _, sums = _global_sums(logits, labels)
    s = _scores(*sums, eps=epsilon)
    return _present_mean(s["iou"], s["present"])


def calculate_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Voxel accuracy after the argmax."""
    return _accuracy(logits.argmax(dim=1), labels)


def segmentation_metrics(logits: torch.Tensor, labels: torch.Tensor) -> dict[str, torch.Tensor]:
    """Train/val 'dice', 'iou' and 'acc' of one batch, as 0-d fp32 tensors,
    from one argmax and one pass of sums."""
    pred, sums = _global_sums(logits, labels)
    s = _scores(*sums)
    return {
        "dice": _present_mean(s["dice"], s["present"]),
        "iou": _present_mean(s["iou"], s["present"]),
        "acc": _accuracy(pred, labels),
    }


def segmentation_metrics_per_sample(logits: torch.Tensor,
                                    labels: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-volume 'dice', 'iou' and 'acc': shape (B,) each; at batch 1 the
    numbers of :func:`segmentation_metrics`."""
    pred = logits.argmax(dim=1)
    s = _scores(*_confusion_sums(pred, labels, logits.shape[1]))
    return {
        "dice": _present_mean(s["dice"], s["present"]),
        "iou": _present_mean(s["iou"], s["present"]),
        "acc": _accuracy(pred, labels, tuple(range(1, pred.dim())), SPATIAL_AXIS),
    }


# ---- the legacy binary metrics: (B, 1, *spatial) probability volumes ----

def _binary_sums(pred: torch.Tensor, target: torch.Tensor):
    p = (pred > 0.5).float()
    t = target.float()
    axes = tuple(range(1, p.dim()))
    return (p * t).sum(dim=axes), p.sum(dim=axes), t.sum(dim=axes)


def dice_score(pred: torch.Tensor, target: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    inter, psum, tsum = _binary_sums(pred, target)
    return ((2.0 * inter + epsilon) / (psum + tsum + epsilon)).mean()


def iou_score(pred: torch.Tensor, target: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    inter, psum, tsum = _binary_sums(pred, target)
    return ((inter + epsilon) / (psum + tsum - inter + epsilon)).mean()


def accuracy_score(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred > 0.5).float() == target.float()).float().mean()
