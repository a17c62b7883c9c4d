"""Host ms a training step in the upload of its batch: the ``data.upload``
spans, each array copied into pinned memory and handed to a non-blocking
copy to the device."""

from gpubench.span_metrics import span_ms


def read(layer):
    return span_ms(layer, {"data.upload"})
