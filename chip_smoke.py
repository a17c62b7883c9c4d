#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line per check; any failure exits non-zero:

1. device: a CUDA device must be present; prints its name, the
   ``nvidia-smi`` name and power limit, and the torch and CUDA versions;
2. build: compiles every kernel of ``multimodal_segmentation_project_tpu_torch/csrc``
   with nvcc, from the sources in this checkout;
3. kernels: each kernel against its plain PyTorch version at every shape the
   192^3 eval forward gives it, in bf16, on seeded inputs; prints the error
   against the stated tolerance and the median time of both over distinct
   inputs (CUDA events);
4. slice: writes two synthetic 192^3 CT cases and a seeded default-width
   UNet3D ``.pth``, runs the port's eval CLI (``workloads.test_model.main``)
   on the GPU, checks its artifacts and that every forward launched exactly
   11 conv, 3 pool, 3 upconv and 1 head kernel;
5. parity: the GPU's bf16 forward against the port's fp32 plain forward on
   the CPU, one 64^3 volume at full width.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Scratch files go to
``build/chip_smoke/`` in this checkout.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "chip_smoke"
SEED = 0
N_TIMED = 5  # distinct inputs per timed kernel / plain call

# (Cin, Cout, S) of every conv3x3x3_cf_relu launch in the 192^3 eval forward
CONV_SHAPES = [
    (1, 16, 192), (16, 16, 192),                       # enc0
    (16, 32, 96), (32, 32, 96),                        # enc1
    (32, 64, 48), (64, 64, 48),                        # enc2
    (64, 64, 48),                                      # dec1.conv1
    (64, 32, 96), (32, 32, 96),                        # dec2
    (32, 16, 192), (16, 16, 192),                      # dec3
]
POOL_SHAPES = [(16, 192), (32, 96), (64, 48)]          # (C, S) in
UPCONV_SHAPES = [(128, 64, 24), (64, 32, 48), (32, 16, 96)]  # (Cin, Cout, S in)
HEAD_SHAPES = [(16, 4, 192)]                           # (Cin, classes, S)
PER_FORWARD = {"conv3x3x3_cf_relu": 11, "max_pool2x_cf": 3, "upconv2x_cf": 3, "head1x1_cf": 1}
KERNEL_INFO = {
    "conv3x3x3_cf_relu": (
        "multimodal_segmentation_project_tpu_torch/csrc/conv3_bias_relu.cu",
        "multimodal_segmentation_project_tpu/ops/pallas_conv.py:314",
    ),
    "max_pool2x_cf": (
        "multimodal_segmentation_project_tpu_torch/csrc/pool2x.cu",
        "multimodal_segmentation_project_tpu/ops/pool.py:65",
    ),
    "upconv2x_cf": (
        "multimodal_segmentation_project_tpu_torch/csrc/upconv_d2s.cu",
        "multimodal_segmentation_project_tpu/ops/upconv.py:69",
    ),
    "head1x1_cf": (
        "multimodal_segmentation_project_tpu_torch/csrc/head1x1.cu",
        "multimodal_segmentation_project_tpu/ops/head.py:39",
    ),
}
# conv/upconv: the kernel and the plain version round once, at the same
# point, from fp32 sums taken in different orders, so they may differ by
# one bf16 ulp; 2**-7 * max|plain| bounds one ulp at the largest output.
BF16_ONE_ULP = 2.0**-7
HEAD_TOL = 1e-5  # fp32 logits: sum order only, scaled by max|plain|


class SmokeFailure(RuntimeError):
    pass


def fail_unless(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase_device():
    import torch

    fail_unless(torch.cuda.is_available(), "torch.cuda.is_available() is false: no GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    fail_unless(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] {name} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"count {torch.cuda.device_count()} | name, power limit:", flush=True)
    print(card, flush=True)  # as nvidia-smi gives it
    # fp32 plain versions are the yardstick: no TF32 anywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return name, card


def phase_build() -> None:
    import multimodal_segmentation_project_tpu_torch as pkg
    from multimodal_segmentation_project_tpu_torch.ops import _build

    # the port must come from this checkout, not from an installed copy
    fail_unless(Path(pkg.__file__).resolve().is_relative_to(ROOT),
                f"port package imported from {pkg.__file__}, not from {ROOT}")
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load()
    secs = time.perf_counter() - t0
    print(f"[build] {_build.library_path().relative_to(ROOT)} "
          f"{'loaded from an earlier build' if cached else 'built by nvcc and loaded'} "
          f"in {secs:.2f} s", flush=True)


def _time_ms(fn, inputs) -> float:
    """Median over distinct inputs of one call each, by CUDA events."""
    import torch

    fn(*inputs[0])  # warm-up
    torch.cuda.synchronize()
    times = []
    for args in inputs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _errors(label: str, kern, plain, inputs, tol: float):
    """(max abs error, max error scaled by max|plain|, within tolerance) of
    the kernel against its plain version over ``inputs``; tol 0 means exact."""
    import torch

    err = rel = 0.0
    for args in inputs:
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        fail_unless(got.shape == want.shape and got.dtype == want.dtype,
                    f"{label}: {tuple(got.shape)}/{got.dtype} vs "
                    f"{tuple(want.shape)}/{want.dtype}")
        e = (got.float() - want.float()).abs().max().item()
        err = max(err, e)
        rel = max(rel, e / max(want.float().abs().max().item(), 1e-30))
    return err, rel, (rel <= tol if tol > 0 else err == 0.0)


def _count(shapes) -> list:
    """Unique shapes in first-seen order, each with its launches per forward."""
    out: dict = {}
    for shape in shapes:
        out[shape] = out.get(shape, 0) + 1
    return list(out.items())


def phase_kernels() -> dict:
    """Each kernel vs its plain version at every slice shape."""
    import torch

    from multimodal_segmentation_project_tpu_torch.ops import conv3, head, pool, upconv

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def conv_inputs(cin, cout, s):
        w = randn(3, 3, 3, cin, cout, scale=(2.0 / (27 * cin)) ** 0.5, dtype=torch.float32)
        b = randn(cout, scale=0.1, dtype=torch.float32)
        return [(randn(1, cin, s, s, s), w, b) for _ in range(N_TIMED)]

    def pool_inputs(c, s):
        return [(randn(1, c, s, s, s),) for _ in range(N_TIMED)]

    def upconv_inputs(cin, cout, s):
        k = randn(2, 2, 2, cin, cout, scale=(1.0 / cin) ** 0.5, dtype=torch.float32)
        b = randn(cout, scale=0.1, dtype=torch.float32)
        return [(randn(1, cin, s, s, s), k, b) for _ in range(N_TIMED)]

    def head_inputs(cin, co, s):
        k = randn(cin, co, scale=(1.0 / cin) ** 0.5, dtype=torch.float32)
        b = randn(co, scale=0.1, dtype=torch.float32)
        return [(randn(1, cin, s, s, s), k, b) for _ in range(N_TIMED)]

    plan = {
        "conv3x3x3_cf_relu": (conv3.conv3x3x3_cf_relu, conv3.conv3x3x3_cf_relu_reference,
                              conv_inputs, CONV_SHAPES, BF16_ONE_ULP),
        "max_pool2x_cf": (pool.max_pool2x_cf, pool.max_pool2x_cf_reference,
                          pool_inputs, POOL_SHAPES, 0.0),
        "upconv2x_cf": (upconv.upconv2x_cf, upconv.upconv2x_cf_reference,
                        upconv_inputs, UPCONV_SHAPES, BF16_ONE_ULP),
        "head1x1_cf": (head.head1x1_cf, head.head1x1_cf_reference,
                       head_inputs, HEAD_SHAPES, HEAD_TOL),
    }
    results = {}
    for name, (kern, plain, make, shapes, tol) in plan.items():
        tot_ms = tot_plain = max_abs = 0.0
        for shape, mult in _count(shapes):
            inputs = make(*shape)
            err, rel, ok = _errors(f"{name} {shape}", kern, plain, inputs, tol)
            ms = _time_ms(kern, inputs)
            plain_ms = _time_ms(plain, inputs)
            tol_s = f"<= {tol:.3g} scaled" if tol > 0 else "== 0 (exact)"
            print(f"[kernel] {name} {shape} x{mult}/forward: max_abs_err {err:.4g} "
                  f"scaled {rel:.4g} {tol_s} {'ok' if ok else 'FAIL'} | "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms", flush=True)
            fail_unless(ok, f"{name} {shape}: error {err} (scaled {rel}) over tolerance")
            max_abs = max(max_abs, err)
            tot_ms += mult * ms
            tot_plain += mult * plain_ms
            del inputs
            torch.cuda.empty_cache()
        results[name] = {"max_abs_err": max_abs, "ms": tot_ms, "plain_ms": tot_plain}
        print(f"[kernel] {name}: summed over one 192^3 forward: kernel {tot_ms:.4f} ms, "
              f"plain {tot_plain:.4f} ms", flush=True)

    # ragged shapes the slice does not reach: batch 2, odd extents, partial
    # channel chunks and channel groups; correctness only
    edges = [
        ("conv3x3x3_cf_relu", (randn(2, 3, 5, 7, 37),
                               randn(3, 3, 3, 3, 8, scale=0.2, dtype=torch.float32),
                               randn(8, scale=0.1, dtype=torch.float32))),
        ("conv3x3x3_cf_relu", (randn(1, 40, 3, 9, 20),
                               randn(3, 3, 3, 40, 20, scale=0.05, dtype=torch.float32),
                               randn(20, scale=0.1, dtype=torch.float32))),
        ("max_pool2x_cf", (randn(2, 3, 5, 7, 9),)),
        ("upconv2x_cf", (randn(2, 70, 3, 5, 7),
                         randn(2, 2, 2, 70, 20, scale=0.1, dtype=torch.float32),
                         randn(20, scale=0.1, dtype=torch.float32))),
        ("head1x1_cf", (randn(2, 5, 3, 5, 7), randn(5, 3, dtype=torch.float32),
                        randn(3, dtype=torch.float32))),
    ]
    for name, args in edges:
        kern, plain, _, _, tol = plan[name]
        label = f"{name} edge input {tuple(args[0].shape)}"
        err, rel, ok = _errors(label, kern, plain, [args], tol)
        print(f"[kernel] {label}: scaled err {rel:.4g} {'ok' if ok else 'FAIL'}", flush=True)
        fail_unless(ok, f"{label}: error {err} over tolerance")
    return results


def write_case(path_img: Path, path_lbl: Path, size: int, seed: int) -> None:
    """One synthetic abdominal CT volume (HU) and its labels: a liver,
    a spleen and two kidneys as ellipsoids with organ-typical intensities
    over soft-tissue noise. Uncompressed NIfTI, so host decode stays short."""
    import numpy as np

    from multimodal_segmentation_project_tpu_torch.data import save_nifti

    rng = np.random.default_rng(seed)
    g = (np.arange(size, dtype=np.float32) + 0.5) / size
    z, y, x = g[:, None, None], g[None, :, None], g[None, None, :]
    lbl = np.zeros((size,) * 3, np.uint8)
    organs = [  # (label, centre, radii) in unit coordinates
        (2, (0.45, 0.35, 0.55), (0.22, 0.18, 0.25)),  # liver
        (1, (0.50, 0.70, 0.35), (0.10, 0.09, 0.12)),  # spleen
        (3, (0.55, 0.40, 0.25), (0.07, 0.06, 0.09)),  # kidneys
        (3, (0.55, 0.65, 0.75), (0.07, 0.06, 0.09)),
    ]
    for label, (cz, cy, cx), (rz, ry, rx) in organs:
        jit = rng.uniform(-0.03, 0.03, 3)
        inside = (((z - cz - jit[0]) / rz) ** 2 + ((y - cy - jit[1]) / ry) ** 2
                  + ((x - cx - jit[2]) / rx) ** 2) <= 1.0
        lbl[inside] = label
    hu = np.array([-40.0, 110.0, 60.0, 180.0], np.float32)[lbl]
    img = hu + rng.normal(0.0, 20.0, lbl.shape).astype(np.float32)
    affine = np.diag([1.5, 1.5, 1.5, 1.0])
    save_nifti(img, str(path_img), affine=affine)
    save_nifti(lbl.astype(np.int16), str(path_lbl), affine=affine)


def make_model(dtype, seed: int = SEED):
    """Default-width UNet3D with seeded He-normal weights and seeded,
    non-trivial eval BatchNorm statistics (so the fold is exercised)."""
    import torch

    from multimodal_segmentation_project_tpu_torch.models import UNet3D

    gen = torch.Generator().manual_seed(seed)
    model = UNet3D(in_channels=1, out_channels=4, features=(16, 32, 64, 128),
                   dropout_rate=0.0, dtype=dtype, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                n = m.num_features
                m.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model.eval()


def phase_slice(n_cases: int = 2, size: int = 192) -> dict:
    """The port's eval CLI on the GPU; checks its artifacts and returns the
    kernel launch counts of its run."""
    import csv

    import numpy as np
    import torch

    from multimodal_segmentation_project_tpu_torch import ops
    from multimodal_segmentation_project_tpu_torch.data import load_nifti
    from multimodal_segmentation_project_tpu_torch.engine.checkpoint import save_pth
    from multimodal_segmentation_project_tpu_torch.workloads import test_model

    shutil.rmtree(SCRATCH, ignore_errors=True)
    case_dir = SCRATCH / "data" / "test" / "synth_ct"
    (case_dir / "images").mkdir(parents=True)
    (case_dir / "labels").mkdir(parents=True)
    t0 = time.perf_counter()
    for i in range(n_cases):
        write_case(case_dir / "images" / f"case{i:02d}.nii",
                   case_dir / "labels" / f"case{i:02d}.nii", size, seed=SEED + i)
    pth = save_pth(str(SCRATCH / "unet3d_seed0.pth"), make_model(torch.bfloat16))
    print(f"[slice] wrote {n_cases} synthetic {size}^3 CT cases and {Path(pth).name} "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    exp = SCRATCH / "exp"
    args = test_model.build_parser().parse_args([
        "--model_path", pth, "--data_root", str(SCRATCH / "data"),
        "--experiment_dir", str(exp), "--model_name", "smoke", "--no_visualizations",
    ])
    ops.reset_launch_counts()
    test_model.main(args)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    n_forwards = 1 + n_cases  # the untimed warm-up, then one per case (batch 1)
    print(f"[slice] launches over {n_forwards} forwards: {counts}", flush=True)
    for name, per in PER_FORWARD.items():
        fail_unless(counts[name] == per * n_forwards,
                    f"{name}: {counts[name]} launches, want {per} x {n_forwards} forwards")

    (rd,) = exp.glob("test_results_smoke_*")
    metrics = json.loads((rd / "metrics" / "metrics.json").read_text())
    for key in ("mean_dice_overall", "mean_iou_overall", "total_inference_time"):
        fail_unless(np.isfinite(metrics.get(key, np.nan)), f"metrics.json: {key} missing")
    with open(rd / "metrics" / "per_sample_metrics.csv") as f:
        rows = list(csv.DictReader(f))
    fail_unless(len(rows) == n_cases, f"per_sample_metrics.csv has {len(rows)} rows")
    preds = sorted((rd / "predictions").glob("*_pred.nii.gz"))
    fail_unless(len(preds) == n_cases, f"{len(preds)} predictions written")
    for p in preds:
        img = load_nifti(str(p))
        fail_unless(img.data.dtype == np.uint8 and img.data.shape == (size,) * 3,
                    f"{p.name}: {img.data.dtype} {img.data.shape}")
        fail_unless(set(np.unique(img.data)) <= {0, 1, 2, 3}, f"{p.name}: labels outside 0..3")
    per_volume = [float(r["inference_time"]) for r in rows]
    print(f"[slice] artifacts ok in {rd.relative_to(ROOT)}: metrics.json, "
          f"{len(rows)} CSV rows, {len(preds)} uint8 predictions | mean dice "
          f"{metrics['mean_dice_overall']:.4f} | per-volume inference (host clock, "
          f"H2D + forward + argmax + metrics + D2H) {[round(t, 4) for t in per_volume]} s",
          flush=True)

    # the forward alone, device-resident input, CUDA events, distinct inputs
    model = make_model(torch.bfloat16).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    xs = [torch.rand(1, 1, size, size, size, generator=gen, device="cuda")
          for _ in range(N_TIMED)]
    with torch.inference_mode():
        fwd_ms = _time_ms(lambda x: model(x), [(x,) for x in xs])
        torch.cuda.reset_peak_memory_stats()
        model(xs[0])
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[slice] UNet3D eval forward at {size}^3, batch 1, bf16: median {fwd_ms:.3f} ms "
          f"(CUDA events, {N_TIMED} distinct inputs) | peak allocated {peak:.2f} GiB", flush=True)
    return counts


# slice parity: bf16 on the GPU against fp32 on the CPU, full width.
# bf16 rounds every activation (8 significant bits) through 22 convs, so
# logits move by about a percent of their range; a voxel whose two top
# logits are that close may change class.
PARITY_SIZE = 64
PARITY_LOGIT_TOL = 0.05   # max |gpu - cpu| / max |cpu|
PARITY_ARGMAX_MIN = 0.98  # share of voxels with the same class


def phase_parity() -> None:
    import numpy as np
    import torch

    from multimodal_segmentation_project_tpu_torch.data import load_nifti, preprocess_ct

    s = PARITY_SIZE
    write_case(SCRATCH / "parity_img.nii", SCRATCH / "parity_lbl.nii", s, seed=SEED + 100)
    img = preprocess_ct(load_nifti(str(SCRATCH / "parity_img.nii")).data.astype(np.float32))
    x = torch.from_numpy(img)[None, None]
    with torch.inference_mode():
        want = make_model(torch.float32)(x)
        got = make_model(torch.bfloat16).cuda()(x.cuda()).cpu()
    fail_unless(got.shape == want.shape == (1, 4, s, s, s), f"shapes {got.shape} {want.shape}")
    fail_unless(bool(torch.isfinite(got).all()), "non-finite logits on the GPU")
    err = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(1) == want.argmax(1)).float().mean().item()
    ok = err <= PARITY_LOGIT_TOL and agree >= PARITY_ARGMAX_MIN
    print(f"[parity] {s}^3 full width, GPU bf16 kernels vs CPU fp32 plain: scaled max logit "
          f"error {err:.4g} (<= {PARITY_LOGIT_TOL}), argmax agreement {agree:.6f} "
          f"(>= {PARITY_ARGMAX_MIN}) {'ok' if ok else 'FAIL'}", flush=True)
    fail_unless(ok, "slice parity over tolerance")


def main() -> int:
    try:
        name, _ = phase_device()
        phase_build()
        kernels = phase_kernels()
        launches = phase_slice()
        phase_parity()
    except Exception as e:  # every phase's failure fails the run
        import traceback

        traceback.print_exc()
        print(f"[FAIL] {type(e).__name__}: {e}", flush=True)
        return 1
    import torch

    report = {"kernels": [
        {"name": kname, "route": "cuda", "source": KERNEL_INFO[kname][0],
         "replaces": KERNEL_INFO[kname][1], "launches": launches[kname],
         "max_abs_err": kernels[kname]["max_abs_err"], "ms": kernels[kname]["ms"],
         "plain_ms": kernels[kname]["plain_ms"]}
        for kname in PER_FORWARD
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
