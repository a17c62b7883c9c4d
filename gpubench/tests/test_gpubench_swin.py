"""The SwinUNETR cell (``swin-unetr-bf16.train``): its loop on the CPU at a
small size through ``run.execute``'s overrides, its weights' layout against
the program's model, its work counts and readers, its control, and on the
card a traced run from the command line."""

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from gpubench import common, flops_swin
from conftest import run_cpu

CELL = "swin-unetr-bf16.train"
BENCH = common.benchmark()
FP32_FLOOR = {"loss_gap": 1e-5, "logit_err": 1e-4, "grad_norm_gap": 5e-3, "update_norm_gap": 5e-3}


def small(precision=None):
    """32^3 (the smallest volume SwinUNETR takes: sides multiples of 32) at
    the published widths, two volumes, accumulation 2."""
    config = {"volume_size": 32, "grad_accum": 2, "num_workers": 2}
    if precision:
        config["precision"] = precision
    return {"config": config, "mix": {"volumes": 2, "traced_epochs": 1}}


def test_reference_matches_fp32_program():
    """In fp32 the program and the reference differ by their sums' order:
    every number compared reads near zero."""
    res = run_cpu(CELL, small("fp32"))
    for name, c in res["checks"].items():
        assert c["value"] <= FP32_FLOOR[name], (name, c["value"])
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0


def test_traced_run_reports_per_layer_metrics():
    res = run_cpu(CELL, small(), trace=1)
    assert {"device_idle_share.train", "mfu.train", "launches_per_step.train",
            "graph_replays_per_step.train", "loader_wait_ms.train"} <= set(res["metrics"])
    # the CPU runs the plain attention: no window_attn kernel to read
    assert not {"window_attn_ms.train", "window_attn_roofline.train"} & set(res["metrics"])


def test_weights_layout_is_the_programs():
    import torch

    from multimodal_segmentation_project_tpu_torch.models.swin_unetr import SwinUNETR

    files = common.cell_files(BENCH, CELL)
    layout = files["loop"].swin_layout(files["config"])
    want = {k: tuple(v.shape) for k, v in SwinUNETR(dtype=torch.float32).state_dict().items()}
    assert {name: shape for name, shape, _, _ in layout} == want
    weights = files["loop"].make_swin_weights(layout, 2147483900, "cpu")
    table = weights["swinViT.layers1.0.blocks.0.attn.relative_position_bias_table"]
    assert float(table.abs().max()) <= 0.04 and abs(float(table.std()) - 0.017) < 0.003


def test_work_counts_and_readers():
    config = common.cell_files(BENCH, CELL)["config"]
    work = flops_swin.step_work(config)
    fwd = sum(f for _, p, f, _ in work if p == "fwd")
    assert 5.0e12 < fwd < 5.1e12 and 15.1e12 < flops_swin.model_flops(work) < 15.3e12
    attn = [(op, p, f) for op, p, f, _ in work if op.kind == "attn"]
    assert len(attn) == 16  # 8 blocks, forward and backward
    op = attn[0][0]  # stage 1: 96^3 real tokens, a 343-token window, C = 48
    assert (op.tokens, op.taps, op.cin) == (96 ** 3, 343, 48)
    assert attn[0][2] == 4 * 96 ** 3 * 343 * 48 and attn[1][2] == 10 * 96 ** 3 * 343 * 48
    least = flops_swin.attn_least_seconds(work, 989e12, 3.35e12)
    trace = SimpleNamespace(kernels=[("window_attn_fwd", "elementwise", least / 2),
                                     ("window_attn_bwd_dq", "elementwise", least),
                                     ("cutlass_gemm", "matmul", 1.0)])
    layer = {"kind": "train", "trace": trace, "units": 1, "work": work, "chips": 1,
             "peak_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    ms, roofline = (common.load_module(common.BENCH_DIR / "metrics" / f"{name}.py", name)
                    for name in ("window_attn_ms.train", "window_attn_roofline.train"))
    assert ms.read(layer) == pytest.approx(1.5e3 * least)
    assert roofline.read(layer) == pytest.approx(100 / 1.5)
    layer["trace"] = SimpleNamespace(kernels=[("cutlass_gemm", "matmul", 1.0)])
    assert ms.read(layer) is None and roofline.read(layer) is None


def test_control_fails_a_limit():
    files = common.cell_files(BENCH, CELL)
    s = small()
    numbers = files["loop"].control({**files["config"], **s["config"]},
                                    {**files["mix"], **s["mix"]}, 2147483900, "cpu")
    limits = files["cell"]["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.card
def test_traced_cell_on_the_card(card):
    """The cell from the command line, traced: correct, the step replayed as
    one CUDA graph, the window-attention kernels found and within their
    roofline."""
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELL, "--seed",
                          "2147483998", "--seconds", "5", "--trace", "1"],
                         capture_output=True, text=True, cwd=common.ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    assert metrics["window_attn_ms.train"] > 0
    assert 0 < metrics["window_attn_roofline.train"] <= 100
    assert metrics["graph_replays_per_step.train"] == 1.0
