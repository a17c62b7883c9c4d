"""The plain reference against the port's CPU path at a small size: with the
program in fp32 the two differ by the order of their sums only, so every
number compared reads near zero. That shows the reference works out the
program's data order, augmentation, dropout masks, BatchNorm, loss, AdamW,
gradient reversal and discriminator by itself."""

import pytest

from conftest import run_cpu, tiny

FP32_FLOOR = {"loss_gap": 1e-5, "logit_err": 1e-4, "grad_norm_gap": 5e-3, "update_norm_gap": 5e-3}


@pytest.mark.parametrize("cell", ["unet3d-bf16.train", "unet3d-dann-bf16.train"])
def test_reference_matches_fp32_program(cell):
    res = run_cpu(cell, tiny("fp32"))
    for name, c in res["checks"].items():
        assert c["value"] <= FP32_FLOOR[name], (name, c["value"])
    assert res["attempted"] > 0 and res["failed"] == 0


def test_traced_run_reports_per_layer_metrics():
    set_up = {"kernel_library_s": 0.25, "kernel_library_built": False}
    res = run_cpu("unet3d-bf16.train", tiny(), trace=1, set_up=set_up)
    assert {"device_idle_share.train", "launches_per_step.train", "elementwise_ms.train",
            "mfu.train"} <= set(res["metrics"])
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert len(res["breakdown"]["device_ops"]) <= 10 and res["breakdown"]["idle_gaps"]
    assert res["set_up"] == set_up and list(res)[-1] == "checks"
