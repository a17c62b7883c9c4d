"""The training step's model FLOPs (gpubench/flops.py) over the traced
window's seconds times the chips' dense peak in the configuration's dtype,
in %."""

from gpubench.metrics_lib import mfu


def read(layer):
    return mfu(layer) if layer["kind"] == "train" else None
