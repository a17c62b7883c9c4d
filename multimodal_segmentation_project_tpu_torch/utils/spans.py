"""Named spans of the training path, on the profiler's clock.

``span(name)`` marks a stretch of the host's work in ``torch.profiler``'s
trace, so the span shares the profiler's clock with every kernel the card
runs. Each span carries the current step's id, ``"<epoch>:<step>"``
(:func:`numbered` sets it), under the key ``step`` of the event's inputs,
which the profiler keeps when it records inputs (``record_shapes=True``;
the Chrome trace then shows it among the event's ``args``). While no
profiler records, ``span`` returns one shared no-op context: a flag read.
Nothing is written here; whoever runs the profiler keeps the spans.

The training path's spans all lie on the thread that drives the steps,
and flat: none contains another, so each stretch of the host's time, and
each idle gap of the card that a trace names after the outermost host
operation, falls to one span. Spans of one name inside one step add up.

=================  ===========================================================
``data.wait``      the loader's consumer until the batch is ready (the prefetch
                   path's poll; the synchronous path's collate)
``data.upload``    ``pin_memory`` and the non-blocking copy to the device
``step.augment``   the augmentation and, on a mesh, the slice
``step.forward``   the train-mode forward(s) and the loss; the distillation
                   teacher's forward in a span of its own
``step.backward``  ``loss.backward()`` and the mesh's gradient all-reduce
``step.update``    the metrics and the NaN guard's launches before
                   ``step.sync``; the rollback or the optimizer after it
``step.sync``      the host's blocking read of the NaN guard's finite flag
=================  ===========================================================

No span goes on a loader thread or inside an autograd ``backward``, which
runs on the autograd engine's thread on a GPU: a span there would overlap
the main thread's and take the names of its idle gaps.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()
_step: ContextVar[str] = ContextVar("step", default="")


def span(name: str):
    """A context that records ``name`` with the current step's id while a
    profiler records, and does nothing otherwise.

    ``torch.profiler.record_function`` would cost about 10 us a call even
    with no profiler on, and keeps no string argument in the trace; the
    profiler's fast record keeps the id as a keyword input."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name, (), {"step": _step.get()})


def set_step(epoch: int, step: int) -> None:
    """The id that the spans opened from now on carry: ``"<epoch>:<step>"``."""
    _step.set(f"{epoch}:{step}")


def numbered(epoch: int, batches):
    """``enumerate(batches)`` with the step id set to ``"<epoch>:<i>"``
    before batch ``i`` is fetched, so that the loader's wait carries the id
    of the step it feeds."""
    it = iter(batches)
    i = 0
    while True:
        set_step(epoch, i)
        try:
            batch = next(it)
        except StopIteration:
            return
        yield i, batch
        i += 1
