"""Device ms a training step in the InstanceNorm kernels: every kernel whose
name contains ``instance_norm`` (``ops/instance_norm.py``'s three forward
and three backward kernels), summed over the traced steps, over their count.
None where the trace holds none (a model without InstanceNorm, or a program
that runs it through another kernel)."""


def instance_norm_seconds(layer: dict) -> float | None:
    """Device seconds of the traced window in kernels whose names contain
    ``instance_norm``; None where a training trace holds none."""
    s = layer["trace"]
    if layer["kind"] != "train" or s is None or not layer["units"]:
        return None
    spent = sum(t for name, _, t in s.kernels if "instance_norm" in name)
    return spent if spent > 0 else None


def read(layer):
    spent = instance_norm_seconds(layer)
    return None if spent is None else 1e3 * spent / layer["units"]
