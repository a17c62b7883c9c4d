"""The benchmark's own tests: CPU tests of the harness, and tests marked
``card`` that need a CUDA device and skip without one."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


TINY = {"config": {"features": [4, 8], "volume_size": 16, "grad_accum": 2, "num_workers": 2},
        "mix": {"volumes": 2, "source_volumes": 2, "target_volumes": 2, "traced_epochs": 1}}


def tiny(precision=None, **mix):
    """Overrides that cut a cell to a CPU test's size (widths and all)."""
    out = {"config": dict(TINY["config"]), "mix": {**TINY["mix"], **mix}}
    if precision:
        out["config"]["precision"] = precision
    return out


def run_cpu(cell, overrides, seed=2147483900, seconds=0.5, trace=0, set_up=None):
    import time

    from gpubench import run

    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.execute(args, device="cpu", t0=time.perf_counter(), overrides=overrides,
                       set_up=set_up)
