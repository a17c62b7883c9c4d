"""The training path's spans (``utils/spans.py``) on the CPU, at a toy size
(features 4, 8; 16^3; batch 1; accumulation 2; two volumes, so two steps
an epoch and one update):

* with no profiler recording, ``span`` calls nothing of torch's profiler,
  and no span of a whole epoch of the trainer does;
* under ``torch.profiler``, an epoch of the supervised ``Trainer`` (with
  augmentation and its two loader threads), of the distillation
  ``Trainer`` (the synchronous loader, the teacher's forward) and of the
  ``DannTrainer`` gives each span its count a step, every span on one
  thread, none inside another, each with its step's ``"epoch:step"``;
* the epoch's metrics are bitwise those of the same epoch untraced;
* the ``--profile`` epoch's Chrome trace holds each span with its step's id.
"""

import collections
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_threads  # noqa: F401
from multimodal_segmentation_project_tpu_torch.engine.trainer import (
    DannTrainer,
    Trainer,
    TrainerConfig,
    build_model,
)
from multimodal_segmentation_project_tpu_torch.ops.losses import distillation_loss
from multimodal_segmentation_project_tpu_torch.utils import spans

NAMES = {"data.wait", "data.upload", "step.augment", "step.forward", "step.backward",
         "step.update", "step.sync"}
ONE_STEP = {"data.wait": 1, "data.upload": 1, "step.augment": 1, "step.forward": 1,
            "step.backward": 1, "step.update": 2, "step.sync": 1}
PER_STEP = {
    "train": ONE_STEP,
    "distill": {**ONE_STEP, "step.forward": 2},
    "dann": {**ONE_STEP, "data.wait": 2, "data.upload": 2, "step.augment": 0},
}
EPOCH = 3


def _volumes(n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(1, 16, 16, 16)).astype(np.float32),
             rng.integers(0, 4, size=(16, 16, 16)).astype(np.int32)) for _ in range(n)]


def _trainer(kind, tmp_path):
    cfg = TrainerConfig(experiment_dir=str(tmp_path), experiment_name=kind, epochs=1,
                        grad_accum=2, features=(4, 8), precision="fp32", device="cpu",
                        augment=kind != "dann", num_workers=0 if kind == "distill" else 2)
    train = _volumes(2, 0)
    if kind == "dann":
        return DannTrainer(cfg, train, _volumes(2, 1), train[:1], lambda_domain=0.2)
    if kind == "distill":
        return Trainer(cfg, train, train[:1], teacher=build_model(cfg),
                       kd_loss_fn=distillation_loss)
    return Trainer(cfg, train, train[:1])


class _Counting:
    """Counts the calls of one of torch's profiler entries for a program
    span's name (torch's optimizer opens its own), then makes them."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, name, *args, **kw):
        self.calls += name in NAMES
        return self.real(name, *args, **kw)


@pytest.fixture
def profiler_calls(monkeypatch):
    """The calls of torch's record-function entries for the spans, counted."""
    fast = _Counting(torch._C._profiler._RecordFunctionFast)
    enter = _Counting(torch.ops.profiler._record_function_enter_new)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", fast)
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", enter)
    return lambda: fast.calls + enter.calls


def test_span_calls_nothing_without_a_profiler(profiler_calls):
    spans.set_step(0, 0)
    with spans.span("data.wait"), spans.span("step.sync"):
        pass
    assert spans.span("data.wait") is spans.span("step.update")
    assert profiler_calls() == 0
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("data.wait"):
            pass
    assert profiler_calls() == 1


@pytest.mark.parametrize("kind", sorted(PER_STEP))
def test_epoch_spans_flat_and_numbered(kind, tmp_path, profiler_calls):
    plain = _trainer(kind, tmp_path / "plain").train_epoch(EPOCH)
    assert profiler_calls() == 0

    trainer = _trainer(kind, tmp_path / "traced")
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        traced = trainer.train_epoch(EPOCH)
    assert traced == plain  # bitwise: the spans change nothing

    # the profiler's raw events: its FunctionEvent tree takes seconds to build here
    found = sorted((e for e in prof.profiler.kineto_results.events() if e.name() in NAMES),
                   key=lambda e: e.start_ns())
    assert {e.start_thread_id() for e in found} == {found[0].start_thread_id()}
    # flat: each span ends before the next one starts, so none holds another
    assert all(a.end_ns() <= b.start_ns() for a, b in zip(found, found[1:]))
    by_step = collections.defaultdict(collections.Counter)
    for e in found:
        by_step[e.kwinputs()["step"]][e.name()] += 1
    want = collections.Counter({k: v for k, v in PER_STEP[kind].items() if v})
    assert dict(by_step) == {f"{EPOCH}:0": want, f"{EPOCH}:1": want}


def test_profiled_epoch_trace_holds_the_spans_with_their_steps(tmp_path):
    trainer = _trainer("train", tmp_path)
    trainer._profiled_train_epoch(EPOCH)
    with open(tmp_path / "train" / "logs" / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    steps = collections.Counter((e["name"], e["args"]["step"]) for e in events
                                if e.get("name") in NAMES)
    assert steps == {(name, f"{EPOCH}:{i}"): n for name, n in ONE_STEP.items() for i in (0, 1)}
