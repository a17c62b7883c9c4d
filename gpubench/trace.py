"""The device trace of a traced window, reduced to what the per-layer metrics read.

``traced(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) and returns a :class:`TraceSummary`: every device kernel and
copy with its class (``kernel_classes.json``), the union of their intervals
(the device's busy time), the traced window on the host clock, the device
operations that took most time and the longest idle gaps, each gap named by
the outermost host operation that overlaps it most. User annotations' device
spans are skipped: they overlap the kernels they launched.
"""

from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass, field
from pathlib import Path

CLASSES_FILE = Path(__file__).resolve().parent / "kernel_classes.json"


def load_classes(path: Path = CLASSES_FILE) -> list:
    """[(compiled pattern, class)] in the file's order: the first match wins."""
    rules = json.loads(path.read_text())["rules"]
    return [(re.compile(r["pattern"], re.IGNORECASE if r.get("ignore_case") else 0), r["class"])
            for r in rules]


def classify(name: str, rules: list, default: str = "elementwise") -> str:
    for pattern, cls in rules:
        if pattern.search(name):
            return cls
    return default


def merge_busy(spans) -> float:
    """Length of the union of (start, end) intervals."""
    spans = sorted((s, e) for s, e in spans if e > s)
    if not spans:
        return 0.0
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s)


def idle_gaps(spans, start: float, end: float) -> list:
    """The (start, end) gaps in [start, end] that no interval covers."""
    gaps, cur = [], start
    for s, e in sorted(spans):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
    if end > cur:
        gaps.append((cur, end))
    return [(s, e) for s, e in gaps if e > s]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)  # (name, class, seconds)
    host_ops: list = field(default_factory=list)  # (name, start_s, end_s), outermost only
    device_span: tuple = (0.0, 0.0)

    def seconds_by_class(self) -> dict:
        out = {}
        for _, cls, s in self.kernels:
            out[cls] = out.get(cls, 0.0) + s
        return out

    def count_by_class(self) -> dict:
        out = {}
        for _, cls, _ in self.kernels:
            out[cls] = out.get(cls, 0) + 1
        return out

    def top_ops(self, n: int = 10) -> list:
        by_name = {}
        for name, _, s in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + s
        return [[k[:200], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def gaps(self, spans, n: int = 10) -> list:
        """The ``n`` longest idle gaps inside the device's span, each named by
        the outermost host operation that overlaps it most."""
        out = []
        for s, e in sorted(idle_gaps(spans, *self.device_span), key=lambda g: g[0] - g[1])[:n]:
            best, name = 0.0, "host outside any torch operation"
            for op, os_, oe in self.host_ops:
                overlap = min(e, oe) - max(s, os_)
                if overlap > best:
                    best, name = overlap, op
            out.append([name[:200], e - s])
        return out


def traced(fn, sync, device_type: str = "cuda"):
    """(fn's result, TraceSummary, the device spans) of ``fn()`` under the
    profiler; ``sync`` waits for the device before the window closes. On a
    CPU device (the harness's own tests) the innermost host operations stand
    in for the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rules = load_classes()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        sync()
        window = time.perf_counter() - t0
    spans, kernels, host = [], [], []
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if device_type == "cpu":
            on_device = not evt.cpu_children
        else:
            on_device = "cuda" in str(getattr(evt, "device_type", "")).lower()
        if on_device:
            if getattr(evt, "is_user_annotation", False) or end <= start:
                continue
            spans.append((start * 1e-6, end * 1e-6))
            kernels.append((evt.name, classify(evt.name, rules), (end - start) * 1e-6))
        if evt.cpu_parent is None and end > start and not (on_device and device_type == "cuda"):
            host.append((evt.name, start * 1e-6, end * 1e-6))
    if not spans:
        raise RuntimeError("the profiler recorded no device time in the traced window")
    summary = TraceSummary(window_s=window, busy_s=merge_busy(spans), kernels=kernels,
                           host_ops=host, device_span=(min(s for s, _ in spans),
                                                       max(e for _, e in spans)))
    return result, summary, spans
