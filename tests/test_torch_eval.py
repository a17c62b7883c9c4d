"""The port's eval CLI against the JAX package's, on the same synthetic NIfTI
cases and the same reference-layout ``.pth`` weights, both in fp32 on the
CPU: the same metric keys and CSV columns, per-sample Dice/IoU equal to
1e-6, the same predictions with the source NIfTI header."""

import csv
import json
import os

import numpy as np
import pytest
import torch

from multimodal_segmentation_project_tpu.data.nifti import load_nifti, save_nifti
from multimodal_segmentation_project_tpu.workloads import test_model as jax_eval
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.workloads import test_model as port_eval
from tests.test_interop import reference_shaped_state_dict

SIZE = 16
FEATURES = "4,8"


def _write_cases(root, dataset, n, seed):
    """Label-correlated intensities: a liver block, a spleen block and a
    kidney block over noise."""
    rng = np.random.default_rng(seed)
    img_dir, lbl_dir = root / dataset / "images", root / dataset / "labels"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    affine = np.diag([1.5, 1.5, 2.0, 1.0])
    affine[:3, 3] = (-10.0, 4.0, 7.5)
    for i in range(n):
        lbl = np.zeros((SIZE,) * 3, np.int16)
        lbl[2:9, 3:10, 4:12] = 2
        lbl[10:14, 2:6, 9:14] = 1
        lbl[9:13, 11:15, 1:5] = 3
        img = lbl.astype(np.float32) * 60 + rng.normal(0, 25, lbl.shape)
        save_nifti(img.astype(np.float32), str(img_dir / f"c{i:02d}.nii.gz"), affine=affine)
        save_nifti(lbl, str(lbl_dir / f"c{i:02d}.nii.gz"), affine=affine)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    data = root / "data"
    _write_cases(data / "test", "synth_ct", 2, seed=0)
    _write_cases(data / "test", "synth_mri", 1, seed=1)
    sd = reference_shaped_state_dict(features=(4, 8), seed=2)
    sd = {k: (v * 0.3 if v.ndim == 5 else v) for k, v in sd.items()}
    pth = root / "ref.pth"
    torch.save({"model_state_dict": sd}, pth)
    return root, data, pth


def _argv(data, pth, exp, name, extra=()):
    return ["--model_path", str(pth), "--data_root", str(data), "--experiment_dir", str(exp),
            "--model_name", name, "--precision", "fp32", "--features", FEATURES, *extra]


def _results(exp, name):
    (d,) = [x for x in os.listdir(exp) if x.startswith(f"test_results_{name}_")]
    rd = os.path.join(exp, d)
    with open(os.path.join(rd, "metrics", "metrics.json")) as f:
        overall = json.load(f)
    with open(os.path.join(rd, "metrics", "per_sample_metrics.csv")) as f:
        reader = csv.DictReader(f)
        rows = list(reader)
        header = reader.fieldnames
    return rd, overall, header, rows


def test_port_eval_cli_matches_jax(setup):
    root, data, pth = setup
    exp_j, exp_p = root / "exp_jax", root / "exp_port"
    jax_eval.main(jax_eval.build_parser().parse_args(
        _argv(data, pth, exp_j, "ref", ["--no_visualizations"])))
    ops.reset_launch_counts()
    port_eval.main(port_eval.build_parser().parse_args(
        _argv(data, pth, exp_p, "ref", ["--device", "cpu"])))
    assert sum(ops.launch_counts().values()) == 0

    rd_j, overall_j, header_j, rows_j = _results(exp_j, "ref")
    rd_p, overall_p, header_p, rows_p = _results(exp_p, "ref")
    assert set(overall_p) == set(overall_j)
    assert header_p == header_j
    assert [r["filename"] for r in rows_p] == [r["filename"] for r in rows_j]
    for rp, rj in zip(rows_p, rows_j):
        for key in header_j:
            if key.startswith(("dice_", "iou_")):
                assert abs(float(rp[key]) - float(rj[key])) <= 1e-6, (rp["filename"], key)
    for key in overall_j:
        if key.startswith("mean_"):
            assert abs(overall_p[key] - overall_j[key]) <= 1e-6, key

    preds = sorted(os.listdir(os.path.join(rd_j, "predictions")))
    assert preds == sorted(os.listdir(os.path.join(rd_p, "predictions"))) and len(preds) == 3
    for name in preds:
        pj = load_nifti(os.path.join(rd_j, "predictions", name))
        pp = load_nifti(os.path.join(rd_p, "predictions", name))
        assert pp.data.dtype == np.uint8 and set(np.unique(pp.data)) <= {0, 1, 2, 3}
        assert pp.header_bytes == pj.header_bytes
        np.testing.assert_array_equal(pp.affine, pj.affine)
        np.testing.assert_array_equal(pp.data, pj.data)
    assert len(os.listdir(os.path.join(rd_p, "visualizations"))) == 3


def test_port_eval_cli_strict_load_rejects_wrong_features(setup):
    root, data, pth = setup
    args = port_eval.build_parser().parse_args(
        _argv(data, pth, root / "exp_bad", "bad", ["--device", "cpu"]))
    args.features = "4,8,16"
    with pytest.raises(RuntimeError, match="state_dict"):
        port_eval.main(args)
