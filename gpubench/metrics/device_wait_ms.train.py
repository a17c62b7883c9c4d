"""Host ms a training step blocked on the device: the ``step.sync`` span,
the host's read of the NaN guard's finite flag, which waits for the step's
backward to finish on the device."""

from gpubench.span_metrics import span_ms


def read(layer):
    return span_ms(layer, {"step.sync"})
