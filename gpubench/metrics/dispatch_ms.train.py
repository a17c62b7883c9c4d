"""Host ms a training step spent dispatching the step's work to the device:
the ``step.augment``, ``step.forward``, ``step.backward`` and
``step.update`` spans, everything of the step but its wait on the device."""

from gpubench.span_metrics import span_ms


def read(layer):
    return span_ms(layer, {"step.augment", "step.forward", "step.backward", "step.update"})
