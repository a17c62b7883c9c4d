"""The baseline train step and the eval step.

Port of ``multimodal_segmentation_project_tpu/engine/steps.py``'s
``make_train_step`` and ``make_eval_step``. A train step: optional
augmentation, the train-mode forward, the loss, the backward, the metrics
on the device, and the masked AdamW update of ``engine.state.TrainState``.

The NaN guard skips a step whose gradients are not all finite and leaves
the whole state as it was before the step: params, both Adam moments and
the step counts (no update is applied), the accumulator and its counter
(nothing is folded in), and the BatchNorm running statistics (the
forward's update is undone). That is what the JAX package's rollback
leaves. The check reads one flag on the host per step. The step's
``loss`` then reads 0 and ``nonfinite`` 1.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.ops.augment import augment_batch
from multimodal_segmentation_project_tpu_torch.ops.metrics import segmentation_metrics


def _bn_buffers(model: torch.nn.Module) -> list[torch.Tensor]:
    return [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var",
                                                               "num_batches_tracked"))]


def make_train_step(loss_fn, augment: bool = False, nan_guard: bool = False):
    """train_step(state, images, labels, generator) -> metrics (0-d tensors
    on the device: dice, iou, acc, loss, and nonfinite with the guard).
    ``generator`` draws the augmentation and the dropout masks."""

    def train_step(state, images, labels, generator=None):
        model = state.model
        model.train()
        if augment:
            images, labels = augment_batch(generator, images, labels)
        saved = [b.clone() for b in _bn_buffers(model)] if nan_guard else None
        for p in model.parameters():
            p.grad = None
        logits = model(images, generator=generator)
        loss = loss_fn(logits, labels)
        loss.backward()
        metrics = segmentation_metrics(logits.detach(), labels)
        metrics["loss"] = loss.detach()
        if nan_guard:
            grads = [p.grad for p in model.parameters() if p.grad is not None]
            finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
            metrics["nonfinite"] = torch.tensor(0.0 if finite else 1.0, device=loss.device)
            if not finite:
                metrics["loss"] = torch.zeros((), device=loss.device)
                with torch.no_grad():
                    for b, old in zip(_bn_buffers(model), saved):
                        b.copy_(old)
                for p in model.parameters():
                    p.grad = None
                return metrics
        state.apply_gradients()
        return metrics

    return train_step


def make_eval_step(loss_fn):
    """eval_step(state, images, labels) -> metrics of the eval forward."""

    @torch.no_grad()
    def eval_step(state, images, labels):
        model = state.model
        model.eval()
        logits = model(images)
        metrics = segmentation_metrics(logits, labels)
        metrics["loss"] = loss_fn(logits, labels)
        return metrics

    return eval_step
