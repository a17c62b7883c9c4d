"""The least time of a training step's convolution work (every pass of the
3x3x3 and transpose convs, the larger of FLOPs over the peak and bytes over
the memory rate) over the device time of the kernels that do that work, in %."""

from gpubench.metrics_lib import conv_roofline


def read(layer):
    return conv_roofline(layer) if layer["kind"] == "train" else None
