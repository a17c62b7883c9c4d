"""CUDA-graph launches a training step: the ``step.replay`` spans, each of
which holds one graph's launch and nothing else. A traced step that ran
eagerly reads 0."""


def read(layer):
    s = layer["trace"]
    if layer["kind"] != "train" or s is None or not layer["units"]:
        return None
    return sum(name == "step.replay" for name, _, _ in s.host_ops) / layer["units"]
