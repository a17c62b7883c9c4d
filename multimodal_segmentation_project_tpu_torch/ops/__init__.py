"""Ops of the port. Each kernel op launches a hand-written CUDA kernel on
CUDA tensors and runs its plain PyTorch version on CPU tensors; each counts
its kernel launches in a ``launches`` attribute. The differentiable ops
(the training conv, the fused DoubleConv's convs, the pool, the upconv and
the head) count their forward launches on themselves and their backward
kernels on the wrappers named here; the eval conv, the pool and the head
count their fp32 instances on the ``*_f32`` wrappers (the training conv's
forward, dx and dW, the pool's backward and the head's dx and weight
gradient too)."""

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
    conv3x3x3_cf_boundary_stats,
    conv3x3x3_cf_dw_prologue,
    conv3x3x3_cf_dx_epilogue,
    conv3x3x3_cf_stats,
)
from multimodal_segmentation_project_tpu_torch.ops.head import (
    head1x1_cf,
    head1x1_cf_dw,
    head1x1_cf_dw_f32,
    head1x1_cf_dx,
    head1x1_cf_dx_f32,
    head1x1_cf_f32,
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
    # the fp32 instances of the train step's per-conv chain: 1, 1-dx, 2, 9,
    # 11-dx and 11-dw (the fp32 policy's training on the card)
    "conv3x3x3_cf_f32": conv3x3x3_cf_f32,
    "conv3x3x3_cf_dx_f32": conv3x3x3_cf_dx_f32,
    "conv3x3x3_cf_dw_f32": conv3x3x3_cf_dw_f32,
    "max_pool2x_cf_bwd_f32": max_pool2x_cf_bwd_f32,
    "head1x1_cf_dx_f32": head1x1_cf_dx_f32,
    "head1x1_cf_dw_f32": head1x1_cf_dw_f32,
}


def launch_counts() -> dict[str, int]:
    return {name: op.launches for name, op in KERNEL_OPS.items()}


def reset_launch_counts() -> None:
    for op in KERNEL_OPS.values():
        op.launches = 0
