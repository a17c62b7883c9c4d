"""Segmentation losses in plain torch (channel-first), in fp32 whatever the
compute dtype.

Port of ``multimodal_segmentation_project_tpu/ops/losses.py``, with the
reference quirks it keeps on purpose:

* every reduction is a GLOBAL sum over batch and volume (not per sample);
* ``combined_ce_tversky_loss`` hard-codes the 0.3/0.7 CE/Tversky mix while
  exposing Tversky's alpha/beta; the drivers pass alpha = beta = 0.5;
* ``distillation_loss`` calls the CE+Tversky term with ITS defaults
  (alpha 0.7, beta 0.3) and reduces the KL term with a global mean, then
  scales it by T^2;
* ``get_loss_fn('ce')`` is plain, correct cross-entropy (the reference's
  'ce' option is broken).

Logits are ``(B, C, *spatial)``; labels are integer class maps
``(B, *spatial)``. A ``(B, C)`` / ``(B,)`` pair works too.

On a multi-device mesh (``parallel/mesh.py``) each rank holds its shard of
the global batch, and each global sum is the sum all-reduced over the mesh
(``reduce_sum``, whose backward all-reduces too): the CE sum over the
global count, the per-class sums of Dice and Tversky, the KL mean. Every
rank then computes the loss of the global batch, as the JAX loss sees the
global array. ``parallel.mesh.reduction_axis`` narrows that to one axis
(a per-sample loss, rows replicated over the spatial axis).
"""

from __future__ import annotations

import torch

from multimodal_segmentation_project_tpu_torch.parallel.mesh import reduce_mean, reduce_sum

CH = 1  # channel axis (B, C, *spatial)


def _per_class_fg_sums(logits: torch.Tensor, labels: torch.Tensor):
    """Per foreground class c: (sum p_c*t_c, sum p_c, sum t_c, sum p_c*(1-t_c),
    sum (1-p_c)*t_c), each stacked over c = 1..C-1."""
    p = torch.softmax(logits.float(), dim=CH)
    tp, ps, ts = [], [], []
    for c in range(1, logits.shape[CH]):
        pc = p.select(CH, c)
        tc = (labels == c).float()
        tp.append((pc * tc).sum())
        ps.append(pc.sum())
        ts.append(tc.sum())
    tp, ps, ts = reduce_sum(torch.stack([torch.stack(tp), torch.stack(ps), torch.stack(ts)]))
    return tp, ps, ts, ps - tp, ts - tp


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over all voxels (nn.CrossEntropyLoss)."""
    logp = torch.log_softmax(logits.float(), dim=CH)
    picked = logp.gather(CH, labels.long().unsqueeze(CH)).squeeze(CH)
    return -reduce_mean(picked)


def soft_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                   epsilon: float = 1e-5) -> torch.Tensor:
    """mean_c [1 - (2*I_c + eps) / (P_c + T_c + eps)] over foreground classes."""
    tp, ps, ts, _, _ = _per_class_fg_sums(logits, labels)
    dice = (2.0 * tp + epsilon) / (ps + ts + epsilon)
    return (1.0 - dice).mean()


def combined_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE + mean foreground soft-dice."""
    return cross_entropy_loss(logits, labels) + soft_dice_loss(logits, labels)


def tversky_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 0.5,
                 beta: float = 0.5, epsilon: float = 1e-6) -> torch.Tensor:
    """Multi-class Tversky loss over foreground classes."""
    tp, _, _, fp, fn = _per_class_fg_sums(logits, labels)
    tversky = (tp + epsilon) / (tp + alpha * fp + beta * fn + epsilon)
    return (1.0 - tversky).mean()


def combined_ce_tversky_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: float = 0.7,
                             beta: float = 0.3) -> torch.Tensor:
    """0.3*CE + 0.7*Tversky(alpha, beta), the reference's hard-coded mix."""
    ce = cross_entropy_loss(logits, labels)
    tv = tversky_loss(logits, labels, alpha=alpha, beta=beta)
    return 0.3 * ce + 0.7 * tv


def distillation_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                      labels: torch.Tensor, alpha: float = 0.7,
                      temperature: float = 2.0) -> torch.Tensor:
    """alpha*(CE+Tversky) + (1-alpha)*T^2*KL(teacher||student), with the
    reference's quirks (module docstring)."""
    seg = combined_ce_tversky_loss(student_logits, labels)
    s = student_logits.float() / temperature
    t = teacher_logits.float() / temperature
    kl = torch.softmax(t, dim=CH) * (torch.log_softmax(t, dim=CH) - torch.log_softmax(s, dim=CH))
    return alpha * seg + (1.0 - alpha) * reduce_mean(kl) * temperature**2


def get_loss_fn(loss_type: str):
    """The drivers' loss registry: tversky/ce_tversky with alpha = beta = 0.5;
    anything unknown is the combined CE + dice loss."""
    if loss_type == "ce":
        return cross_entropy_loss
    if loss_type == "tversky":
        return lambda logits, labels: tversky_loss(logits, labels, alpha=0.5, beta=0.5)
    if loss_type == "dice":
        return soft_dice_loss
    if loss_type == "ce_tversky":
        return lambda logits, labels: combined_ce_tversky_loss(logits, labels, alpha=0.5, beta=0.5)
    return combined_loss
