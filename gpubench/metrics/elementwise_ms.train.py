"""Device ms a training step of every kernel that is none of the port's,
no library convolution or matmul, no copy and no collective: the eager
torch kernels (elementwise, reductions, concatenation)."""

from gpubench.metrics_lib import per_unit_ms


def read(layer):
    if layer["kind"] != "train":
        return None
    skip = set(layer["classes"]["not_elementwise"])
    return per_unit_ms(layer, lambda cls: cls not in skip)
