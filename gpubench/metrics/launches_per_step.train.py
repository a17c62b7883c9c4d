"""Device kernels launched a training step, counted in the trace (copies
and memsets are not kernels)."""


def read(layer):
    s = layer["trace"]
    if layer["kind"] != "train" or s is None or not layer["units"]:
        return None
    return sum(n for cls, n in s.count_by_class().items() if cls != "copy") / layer["units"]
