"""The device's idle share of the traced window of a training cell, in %:
1 - (the union of its kernel and copy intervals) / the window."""

from gpubench.metrics_lib import idle_share


def read(layer):
    return idle_share(layer) if layer["kind"] == "train" else None
