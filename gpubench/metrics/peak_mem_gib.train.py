"""The allocator's peak over the measured window of a training cell, GiB."""

from gpubench.metrics_lib import peak_gib


def read(layer):
    return peak_gib(layer) if layer["kind"] == "train" else None
