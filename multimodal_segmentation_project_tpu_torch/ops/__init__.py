"""Ops of the port. Each kernel op launches a hand-written CUDA kernel on
CUDA tensors and runs its plain PyTorch version on CPU tensors; each counts
its kernel launches in a ``launches`` attribute. The differentiable ops
(the training conv, the fused DoubleConv's convs, the pool, the upconv and
the head) count their forward launches on themselves and their backward
kernels on the wrappers named here; the eval conv, the pool and the head
count their fp32 instances on the ``*_f32`` wrappers (the training conv's
forward, dx and dW, the pool's backward and the head's dx and weight
gradient too), the fused DoubleConv's five kernels on ``*_f32`` counters.

Beside them, the JAX package's ``ops`` exports: the losses, the metrics and
``grad_reverse``, in plain torch."""

from multimodal_segmentation_project_tpu_torch.ops.conv3 import (
    conv3x3x3_cf,
    conv3x3x3_cf_dw,
    conv3x3x3_cf_dw_f32,
    conv3x3x3_cf_dx,
    conv3x3x3_cf_dx_f32,
    conv3x3x3_cf_f32,
    conv3x3x3_cf_relu,
    conv3x3x3_cf_relu_f32,
)
from multimodal_segmentation_project_tpu_torch.ops.conv3_fused import (
    conv3x3x3_cf_boundary,
    conv3x3x3_cf_boundary_f32,
    conv3x3x3_cf_boundary_stats,
    conv3x3x3_cf_boundary_stats_f32,
    conv3x3x3_cf_dw_prologue,
    conv3x3x3_cf_dw_prologue_f32,
    conv3x3x3_cf_dx_epilogue,
    conv3x3x3_cf_dx_epilogue_f32,
    conv3x3x3_cf_stats,
    conv3x3x3_cf_stats_f32,
)
from multimodal_segmentation_project_tpu_torch.ops.grl import grad_reverse
from multimodal_segmentation_project_tpu_torch.ops.head import (
    head1x1_cf,
    head1x1_cf_dw,
    head1x1_cf_dw_f32,
    head1x1_cf_dx,
    head1x1_cf_dx_f32,
    head1x1_cf_f32,
)
from multimodal_segmentation_project_tpu_torch.ops.losses import (
    combined_ce_tversky_loss,
    combined_loss,
    cross_entropy_loss,
    distillation_loss,
    get_loss_fn,
    soft_dice_loss,
    tversky_loss,
)
from multimodal_segmentation_project_tpu_torch.ops.metrics import (
    calculate_accuracy,
    calculate_dice,
    calculate_iou,
    per_class_dice_iou,
    segmentation_metrics,
)
from multimodal_segmentation_project_tpu_torch.ops.pool import (
    max_pool2x_cf,
    max_pool2x_cf_bwd,
    max_pool2x_cf_bwd_f32,
    max_pool2x_cf_f32,
)
from multimodal_segmentation_project_tpu_torch.ops.upconv import upconv2x_cf

KERNEL_OPS = {
    "conv3x3x3_cf_relu": conv3x3x3_cf_relu,
    "conv3x3x3_cf": conv3x3x3_cf,
    "conv3x3x3_cf_dx": conv3x3x3_cf_dx,
    "conv3x3x3_cf_dw": conv3x3x3_cf_dw,
    "conv3x3x3_cf_stats": conv3x3x3_cf_stats,
    "conv3x3x3_cf_boundary_stats": conv3x3x3_cf_boundary_stats,
    "conv3x3x3_cf_boundary": conv3x3x3_cf_boundary,
    "conv3x3x3_cf_dx_epilogue": conv3x3x3_cf_dx_epilogue,
    "conv3x3x3_cf_dw_prologue": conv3x3x3_cf_dw_prologue,
    "max_pool2x_cf": max_pool2x_cf,
    "max_pool2x_cf_bwd": max_pool2x_cf_bwd,
    "upconv2x_cf": upconv2x_cf,
    "head1x1_cf": head1x1_cf,
    "head1x1_cf_dx": head1x1_cf_dx,
    "head1x1_cf_dw": head1x1_cf_dw,
    # the fp32 instances of 7, 8 and 11 (the eval forward under the fp32 policy)
    "conv3x3x3_cf_relu_f32": conv3x3x3_cf_relu_f32,
    "max_pool2x_cf_f32": max_pool2x_cf_f32,
    "head1x1_cf_f32": head1x1_cf_f32,
    # the fp32 instances of the train step's 1, 1-dx, 2, 9, 11-dx and 11-dw
    # (the fp32 policy's training on the card)
    "conv3x3x3_cf_f32": conv3x3x3_cf_f32,
    "conv3x3x3_cf_dx_f32": conv3x3x3_cf_dx_f32,
    "conv3x3x3_cf_dw_f32": conv3x3x3_cf_dw_f32,
    "max_pool2x_cf_bwd_f32": max_pool2x_cf_bwd_f32,
    "head1x1_cf_dx_f32": head1x1_cf_dx_f32,
    "head1x1_cf_dw_f32": head1x1_cf_dw_f32,
    # the fp32 instances of the fused DoubleConv: 3, 4, 12, 5 and 6
    "conv3x3x3_cf_stats_f32": conv3x3x3_cf_stats_f32,
    "conv3x3x3_cf_boundary_stats_f32": conv3x3x3_cf_boundary_stats_f32,
    "conv3x3x3_cf_boundary_f32": conv3x3x3_cf_boundary_f32,
    "conv3x3x3_cf_dx_epilogue_f32": conv3x3x3_cf_dx_epilogue_f32,
    "conv3x3x3_cf_dw_prologue_f32": conv3x3x3_cf_dw_prologue_f32,
}


def launch_counts() -> dict[str, int]:
    return {name: op.launches for name, op in KERNEL_OPS.items()}


def reset_launch_counts() -> None:
    for op in KERNEL_OPS.values():
        op.launches = 0


__all__ = [
    # the JAX package's ops exports
    "cross_entropy_loss",
    "soft_dice_loss",
    "combined_loss",
    "tversky_loss",
    "combined_ce_tversky_loss",
    "distillation_loss",
    "get_loss_fn",
    "calculate_dice",
    "calculate_iou",
    "calculate_accuracy",
    "per_class_dice_iou",
    "segmentation_metrics",
    "grad_reverse",
    # the kernel ops and their launch counters
    *KERNEL_OPS,
    "KERNEL_OPS",
    "launch_counts",
    "reset_launch_counts",
]
