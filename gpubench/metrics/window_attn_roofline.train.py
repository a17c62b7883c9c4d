"""The least time of a training step's window-attention passes (per pass
the larger of its FLOPs over the dtype's peak and its bytes over the memory
rate, ``flops_swin.py``) over the device time of the ``window_attn``
kernels, in %. None where the trace holds no such kernel."""

from gpubench.flops_swin import attn_least_seconds, window_attn_seconds


def read(layer):
    spent = window_attn_seconds(layer)
    if spent is None:
        return None
    least = attn_least_seconds(layer["work"], layer["peak_flops"], layer["hbm_bytes_per_s"])
    return 100.0 * least * layer["units"] / (spent * layer["chips"])
