"""Device ms a training step in the window-attention kernels: every kernel
whose name starts with ``window_attn`` (``ops/window_attn.py``'s forward and
its two backward kernels), summed over the traced steps, over their count.
None where the trace holds none (a model without windowed attention)."""

from gpubench.flops_swin import window_attn_seconds


def read(layer):
    spent = window_attn_seconds(layer)
    return None if spent is None else 1e3 * spent / layer["units"]
