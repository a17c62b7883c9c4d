"""What the readers of the program's spans share.

The port marks its training path's host time with flat named spans on the
profiler's clock (``multimodal_segmentation_project_tpu_torch/utils/spans.py``):
none lies inside another, so each is among the trace's outermost host
operations, ``TraceSummary.host_ops``. A program without them leaves its
readers with nothing to read.
"""

from __future__ import annotations


def span_ms(layer, names) -> float | None:
    """Host ms a training step inside the spans named ``names``: their
    summed durations over the traced steps, or None where the trace holds
    none of them."""
    s = layer["trace"]
    if layer["kind"] != "train" or s is None or not layer["units"]:
        return None
    found = [end - start for name, start, end in s.host_ops if name in names]
    if not found:
        return None
    return 1e3 * sum(found) / layer["units"]
