"""Ops of the port. The four kernel ops each launch a hand-written CUDA
kernel on CUDA tensors and run their plain PyTorch version on CPU tensors;
each counts its kernel launches in a ``launches`` attribute."""

from multimodal_segmentation_project_tpu_torch.ops.conv3 import conv3x3x3_cf_relu
from multimodal_segmentation_project_tpu_torch.ops.head import head1x1_cf
from multimodal_segmentation_project_tpu_torch.ops.pool import max_pool2x_cf
from multimodal_segmentation_project_tpu_torch.ops.upconv import upconv2x_cf

KERNEL_OPS = {
    "conv3x3x3_cf_relu": conv3x3x3_cf_relu,
    "max_pool2x_cf": max_pool2x_cf,
    "upconv2x_cf": upconv2x_cf,
    "head1x1_cf": head1x1_cf,
}


def launch_counts() -> dict[str, int]:
    return {name: op.launches for name, op in KERNEL_OPS.items()}


def reset_launch_counts() -> None:
    for op in KERNEL_OPS.values():
        op.launches = 0
