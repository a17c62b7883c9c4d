"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have: a step that leaves its state unchanged. Half of
a batch left out cannot happen at the cells' batch of 1, and no cell
exchanges anything between devices. The harness's look for a device is
skipped (the run is on the CPU, the program in fp32 so that the sound run
reads near zero); the cells' own limits judge."""

import pytest

from conftest import run_cpu, tiny


@pytest.mark.parametrize("cell", ["unet3d-bf16.train", "unet3d-dann-bf16.train"])
def test_state_left_unchanged(cell, monkeypatch):
    from multimodal_segmentation_project_tpu_torch.engine import state

    assert run_cpu(cell, tiny("fp32"))["correct"]
    monkeypatch.setattr(state.TrainState, "apply_gradients", lambda self: None)
    res = run_cpu(cell, tiny("fp32"))
    assert not res["correct"]
    assert res["checks"]["update_norm_gap"]["value"] == pytest.approx(1.0)

