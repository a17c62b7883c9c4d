"""Host ms a training step that the loop waits for its batch: the
``data.wait`` spans, the loader's consumer polling until the batch its
threads prepare is ready."""

from gpubench.span_metrics import span_ms


def read(layer):
    return span_ms(layer, {"data.wait"})
