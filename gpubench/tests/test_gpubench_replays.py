"""The reader of the CUDA-graph launches a training step, on a trace summary
built by hand: the ``step.replay`` host operations over the traced steps, 0
where the steps ran eagerly, None where there is no trace or no step."""

import pytest

from gpubench import common, trace

BENCH = common.benchmark()
NAME = "graph_replays_per_step.train"

# two replayed steps: the graph's launch, then the guard's read and the update
REPLAYED = [
    ("data.upload", 0.000, 0.003), ("step.augment", 0.003, 0.005),
    ("step.forward", 0.005, 0.006), ("step.replay", 0.006, 0.00605),
    ("step.update", 0.00605, 0.007), ("step.sync", 0.007, 0.060),
    ("step.update", 0.060, 0.062),
    ("data.upload", 0.062, 0.065), ("step.augment", 0.065, 0.067),
    ("step.forward", 0.067, 0.068), ("step.replay", 0.068, 0.06805),
    ("step.update", 0.06805, 0.069), ("step.sync", 0.069, 0.120),
    ("step.update", 0.120, 0.122),
]


def _read(layer):
    reader = common.load_module(common.BENCH_DIR / "metrics" / f"{NAME}.py", "reader_replays")
    return reader.read(layer)


def _layer(host_ops, units=2, kind="train"):
    s = trace.TraceSummary(window_s=0.2, busy_s=0.15, host_ops=host_ops, device_span=(0.0, 0.2))
    return {"kind": kind, "trace": s, "units": units}


@pytest.mark.parametrize("units, want", [(2, 1.0), (4, 0.5)])
def test_replays_a_step(units, want):
    assert _read(_layer(REPLAYED, units=units)) == pytest.approx(want)


def test_eager_steps_read_zero_and_no_step_reads_nothing():
    eager = [op for op in REPLAYED if op[0] != "step.replay"]
    assert _read(_layer(eager)) == 0
    assert _read({"kind": "train", "trace": None, "units": 0}) is None
    assert _read(_layer(REPLAYED, units=0)) is None
    assert _read(_layer(REPLAYED, kind="eval")) is None


def test_replay_metric_entry():
    entry = next(m for m in BENCH["per_layer"] if m["name"] == NAME)
    assert entry["source"] == "program_span" and entry["unit"] == "replays/step"
    assert entry["layer"] == "steps" and entry["better"] == "higher"
    assert entry["moves"] == "train_samples_per_s"
    assert entry["workloads"] == ["unet3d-bf16.train", "unet3d-dann-bf16.train"]
