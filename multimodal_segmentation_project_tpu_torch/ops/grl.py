"""The gradient reversal layer of DANN.

Port of ``multimodal_segmentation_project_tpu/ops/grl.py``: the identity
forward, ``-lambda_ * g`` backward, and no gradient to ``lambda_``. Plain
torch on every device: the JAX package computes it as a ``custom_vjp``
outside any Pallas kernel.
"""

from __future__ import annotations

import torch


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lambda_):
        ctx.lambda_ = float(lambda_)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lambda_ * g, None


def grad_reverse(x: torch.Tensor, lambda_: float) -> torch.Tensor:
    """x in the forward; the cotangent times -lambda_ in the backward."""
    return _GradReverse.apply(x, lambda_)
