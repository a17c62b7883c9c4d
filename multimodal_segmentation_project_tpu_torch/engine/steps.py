"""The train, eval, distillation and DANN steps.

Port of ``multimodal_segmentation_project_tpu/engine/steps.py``'s
``make_train_step``, ``make_eval_step``, ``make_distill_step`` and
``make_dann_step``. A train step: optional augmentation, the train-mode
forward, the loss, the backward, the metrics on the device, and the masked
AdamW update of ``engine.state.TrainState``. Every parameter's gradient is
computed, the frozen ones' too (``TrainState.apply_gradients`` drops them
before AdamW), as the JAX package computes every gradient and masks the
updates.

The NaN guard skips a step whose gradients are not all finite, frozen
parameters' included, and leaves the whole state as it was before the
step: params, both Adam moments and the step counts (no update is
applied), the accumulator and its counter (nothing is folded in), and the
BatchNorm running statistics (the forward's update is undone). That is
what the JAX package's rollback leaves. The check reads one flag on the
host per step. The step's losses then read 0 and ``nonfinite`` 1.

Each step's backward runs inside ``library_precision(model.dtype)``, the
scope the model's forward runs its library calls in: in an fp32 step
cuDNN's backward of the deep region's convs and of the fp32 transpose
convs runs with TF32 off, as the forward does, and the flag reads as
before once the backward returns. A bf16 step leaves it alone.
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.models.unet3d import library_precision
from multimodal_segmentation_project_tpu_torch.ops.augment import augment_batch
from multimodal_segmentation_project_tpu_torch.ops.grl import grad_reverse
from multimodal_segmentation_project_tpu_torch.ops.losses import cross_entropy_loss
from multimodal_segmentation_project_tpu_torch.ops.metrics import segmentation_metrics


def _bn_buffers(model: torch.nn.Module) -> list[torch.Tensor]:
    return [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var",
                                                               "num_batches_tracked"))]


def _zero_grads(*models: torch.nn.Module) -> None:
    for model in models:
        for p in model.parameters():
            p.grad = None


def _backward(loss: torch.Tensor, model: torch.nn.Module) -> None:
    """loss.backward() in the model's library-precision scope: cuDNN's TF32
    off in an fp32 model's backward."""
    with library_precision(model.dtype):
        loss.backward()


def _guard(metrics: dict, models: tuple, saved: list, loss_keys: tuple) -> bool:
    """The NaN guard over the gradients of ``models``: sets
    ``metrics['nonfinite']`` and returns whether all are finite. If not, it
    zeroes the losses ``loss_keys``, restores the first model's BatchNorm
    buffers from ``saved`` and drops every gradient, so no update follows."""
    grads = [p.grad for m in models for p in m.parameters() if p.grad is not None]
    finite = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
    device = grads[0].device
    metrics["nonfinite"] = torch.tensor(0.0 if finite else 1.0, device=device)
    if not finite:
        for k in loss_keys:
            metrics[k] = torch.zeros((), device=device)
        with torch.no_grad():
            for b, old in zip(_bn_buffers(models[0]), saved):
                b.copy_(old)
        _zero_grads(*models)
    return finite


def _supervised_step(state, images, labels, generator, nan_guard: bool, loss_fn):
    """The train and distillation steps after their augmentation: the
    train-mode forward, ``loss_fn(logits, labels)``, the backward, the
    metrics, the guard and the update."""
    model = state.model
    model.train()
    saved = [b.clone() for b in _bn_buffers(model)] if nan_guard else None
    _zero_grads(model)
    logits = model(images, generator=generator)
    loss = loss_fn(logits, labels)
    _backward(loss, model)
    metrics = segmentation_metrics(logits.detach(), labels)
    metrics["loss"] = loss.detach()
    if nan_guard and not _guard(metrics, (model,), saved, ("loss",)):
        return metrics
    state.apply_gradients()
    return metrics


def make_train_step(loss_fn, augment: bool = False, nan_guard: bool = False):
    """train_step(state, images, labels, generator) -> metrics (0-d tensors
    on the device: dice, iou, acc, loss, and nonfinite with the guard).
    ``generator`` draws the augmentation and the dropout masks."""

    def train_step(state, images, labels, generator=None):
        if augment:  # rebinding frees the batch from before the augmentation
            images, labels = augment_batch(generator, images, labels)
        return _supervised_step(state, images, labels, generator, nan_guard, loss_fn)

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


def make_distill_step(kd_loss_fn, augment: bool = False, nan_guard: bool = False):
    """distill_step(state, teacher, images, labels, generator) -> metrics.

    The student takes the train step with ``kd_loss_fn(student_logits,
    teacher_logits, labels)``. The teacher is a separate ``UNet3D`` with
    its parameters frozen (``requires_grad_(False)``); it runs its eval
    forward (BatchNorm folded) under ``torch.no_grad()`` on the step's
    (augmented) images, before the student's forward."""

    def distill_step(state, teacher, images, labels, generator=None):
        if augment:
            images, labels = augment_batch(generator, images, labels)
        teacher.eval()
        with torch.no_grad():
            teacher_logits = teacher(images)
        return _supervised_step(
            state, images, labels, generator, nan_guard,
            lambda logits, labels: kd_loss_fn(logits, teacher_logits, labels))

    return distill_step


def _split_generator(generator: torch.Generator | None, n: int) -> list:
    """``n`` generators seeded from ``generator``'s next draws (None: n Nones)."""
    if generator is None:
        return [None] * n
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    return [torch.Generator(device=generator.device).manual_seed(int(s)) for s in seeds]


def make_dann_step(loss_fn, lambda_domain: float, nan_guard: bool = False):
    """dann_step(seg_state, disc_state, src_images, src_labels, tgt_images,
    generator) -> metrics (dice, iou, acc of the source batch, task_loss,
    domain_loss, loss, and nonfinite with the guard).

    The JAX package's semantics, its double lambda included: the gradient
    reversal scales by -lambda and the total is task + lambda * domain, so
    the discriminator trains on lambda * CE and the features see
    -lambda**2 * dCE. One backward feeds both states, each with its own
    AdamW. The domain labels are 0 for the source and 1 for the target.
    ``generator`` seeds three dropout streams, in this order: the source
    forward's, the target forward's and the discriminator's.

    Both forwards are whole train-mode forwards, so the BatchNorm running
    statistics take the source batch and then the target batch, the
    decoder's included, as the JAX package's ``mut_t`` does. The target's
    logits are dropped at once: no decoder backward runs for them, and
    their activations are freed. The NaN guard covers both states' gradients
    and undoes both forwards' statistics."""

    def dann_step(seg_state, disc_state, src_images, src_labels, tgt_images, generator=None):
        model, disc = seg_state.model, disc_state.model
        model.train()
        disc.train()
        g_src, g_tgt, g_disc = _split_generator(generator, 3)
        saved = [b.clone() for b in _bn_buffers(model)] if nan_guard else None
        _zero_grads(model, disc)
        src_logits, src_feat = model(src_images, return_features=True, generator=g_src)
        task_loss = loss_fn(src_logits, src_labels)
        tgt_feat = model(tgt_images, return_features=True, generator=g_tgt)[1]
        feats = torch.cat([grad_reverse(src_feat, lambda_domain),
                           grad_reverse(tgt_feat, lambda_domain)])
        domain_logits = disc(feats, generator=g_disc)
        domain_labels = torch.cat([
            torch.zeros(src_feat.shape[0], dtype=torch.long, device=feats.device),
            torch.ones(tgt_feat.shape[0], dtype=torch.long, device=feats.device),
        ])
        domain_loss = cross_entropy_loss(domain_logits, domain_labels)
        total = task_loss + lambda_domain * domain_loss
        _backward(total, model)  # the discriminator's matmuls are full fp32 already
        metrics = segmentation_metrics(src_logits.detach(), src_labels)
        metrics.update(task_loss=task_loss.detach(), domain_loss=domain_loss.detach(),
                       loss=total.detach())
        if nan_guard and not _guard(metrics, (model, disc), saved,
                                    ("task_loss", "domain_loss", "loss")):
            return metrics
        seg_state.apply_gradients()
        disc_state.apply_gradients()
        return metrics

    return dann_step
