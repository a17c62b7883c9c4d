"""The readers of the program's spans, on a trace summary built by hand: ms a
training step from the outermost host operations named as the spans, and
None where there is no trace or no such span (a program without spans)."""

import pytest

from gpubench import common, trace

BENCH = common.benchmark()
SPAN_METRICS = {"loader_wait_ms.train": 2.0, "upload_ms.train": 3.5,
                "dispatch_ms.train": 45.0, "device_wait_ms.train": 1.25}


def _read(name, layer):
    reader = common.load_module(common.BENCH_DIR / "metrics" / f"{name}.py", "reader_" + name[:-6])
    return reader.read(layer)


def _layer(host_ops, units=2, kind="train"):
    s = trace.TraceSummary(window_s=0.2, busy_s=0.05, host_ops=host_ops, device_span=(0.0, 0.2))
    return {"kind": kind, "trace": s, "units": units}


# two steps: the host's spans (seconds) and a torch op outside them
STEPS = [
    ("data.wait", 0.000, 0.001), ("data.upload", 0.001, 0.004), ("step.augment", 0.004, 0.010),
    ("step.forward", 0.010, 0.030), ("step.backward", 0.030, 0.050), ("step.update", 0.050, 0.052),
    ("step.sync", 0.052, 0.0535), ("step.update", 0.0535, 0.0555),
    ("aten::add", 0.0555, 0.056),
    ("data.wait", 0.056, 0.059), ("data.upload", 0.059, 0.063), ("step.augment", 0.063, 0.070),
    ("step.forward", 0.070, 0.090), ("step.backward", 0.090, 0.100),
    ("step.update", 0.100, 0.102), ("step.sync", 0.102, 0.103), ("step.update", 0.103, 0.104),
]


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_reader_gives_ms_a_step(name):
    assert _read(name, _layer(STEPS)) == pytest.approx(SPAN_METRICS[name])
    assert _read(name, _layer(STEPS, units=4)) == pytest.approx(SPAN_METRICS[name] / 2)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_reader_finds_nothing_without_spans(name):
    without = [op for op in STEPS if not op[0].startswith(("data.", "step."))]
    assert _read(name, _layer(without)) is None
    assert _read(name, {"kind": "train", "trace": None, "units": 0}) is None
    assert _read(name, _layer(STEPS, units=0)) is None
    assert _read(name, _layer(STEPS, kind="eval")) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metric_entries(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["unit"] == "ms/step"
    assert entry["moves"] == "train_samples_per_s"
    assert entry["workloads"] == ["unet3d-bf16.train", "unet3d-dann-bf16.train"]
