"""Evaluation: full-volume inference, per-organ metrics and exports, on a GPU.

Port of ``multimodal_segmentation_project_tpu/workloads/test_model.py``:
the same flags and the same artifacts under
``<experiment_dir>/test_results_<model_name>_<timestamp>/``:

* ``metrics/per_sample_metrics.csv`` (per-organ Dice/IoU, inference time);
* ``metrics/metrics.json`` (per-organ and overall means, timings);
* ``predictions/<dataset>_<case>_pred.nii.gz`` (uint8, source header);
* ``visualizations/<dataset>_<case>_pred.png`` (3x3 panel) unless
  ``--no_visualizations``.

    python -m multimodal_segmentation_project_tpu_torch.workloads.test_model \\
        --model_path best_model_unet.msgpack --data_root data --experiment_dir exp --model_name unet

One UNet3D eval forward per batch (batch 1 by default, no sliding window),
then argmax and the metrics on the device. The model loads strictly from
a reference-layout ``.pth`` or from a JAX ``.msgpack`` checkpoint (the
train CLIs of both packages write ``best_model_<name>.msgpack``). It runs
on CUDA; with no GPU it runs on the CPU only when asked with ``--device
cpu``. ``--precision`` picks the compute dtype on either device: bf16 (the
default) or fp32, whose forward on the GPU runs the fp32 instances of the
conv, pool and head kernels and the library's convs and transpose convs
with cuDNN's TF32 off, as the JAX package's fp32 policy computes it. The
first forward is a warm-up (kernel build and load included) and is not
timed; every timed forward is bracketed by ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

import numpy as np
import torch

from multimodal_segmentation_project_tpu_torch import NUM_CLASSES, ORGAN_NAMES
from multimodal_segmentation_project_tpu_torch.data import (
    CombinedDataset,
    DataLoader,
    load_nifti_header,
    save_nifti,
)
from multimodal_segmentation_project_tpu_torch.engine.checkpoint import load_params_any
from multimodal_segmentation_project_tpu_torch.models.unet3d import UNet3D
from multimodal_segmentation_project_tpu_torch.ops.metrics import per_class_dice_iou_per_sample
from multimodal_segmentation_project_tpu_torch.workloads.common import (
    parse_features,
    parse_modalities,
    resolve_device,
)

ORGAN_COLORS = {1: (1.0, 0.0, 0.0), 2: (1.0, 0.65, 0.0), 3: (0.0, 0.5, 0.0)}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Test UNet3D model (PyTorch/CUDA)")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--experiment_dir", type=str, required=True)
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="test_results")
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--modalities", type=str, default="all")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--precision", type=str, default="bf16", choices=["bf16", "fp32"])
    parser.add_argument("--no_visualizations", action="store_true")
    parser.add_argument("--no_predictions", action="store_true")
    parser.add_argument("--features", type=str, default="16,32,64,128",
                        help="encoder widths of the trained model")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu', which runs the plain PyTorch ops")
    return parser


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_slice(label: np.ndarray, axis: int) -> int:
    """Slice with the most organ voxels along ``axis``."""
    other = tuple(a for a in range(3) if a != axis)
    counts = (label > 0).sum(axis=other)
    best = int(np.argmax(counts))
    return best if counts[best] > 0 else label.shape[axis] // 2


def _overlay(image_slice: np.ndarray, label_slice: np.ndarray) -> np.ndarray:
    rgb = np.repeat(image_slice[..., None], 3, axis=-1).astype(np.float64)
    lo, hi = rgb.min(), rgb.max()
    rgb = (rgb - lo) / (hi - lo + 1e-8)
    for cls, color in ORGAN_COLORS.items():
        rgb[label_slice == cls] = color
    return rgb


def visualize_prediction(image, label, pred, save_path):
    """3x3 panel: rows = axial/sagittal/coronal, cols = orig/GT/pred."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Patch

    image, label, pred = np.squeeze(image), np.squeeze(label), np.squeeze(pred)
    views = [
        ("Axial", 2, _best_slice(label, 2)),
        ("Sagittal", 0, _best_slice(label, 0)),
        ("Coronal", 1, _best_slice(label, 1)),
    ]
    fig, axes = plt.subplots(3, 3, figsize=(18, 18))
    plt.subplots_adjust(hspace=0.3, wspace=0.3)
    for row, (name, axis, idx) in enumerate(views):
        img_s, lbl_s, prd_s = (np.take(v, idx, axis=axis) for v in (image, label, pred))
        panels = [
            (np.rot90(img_s), f"{name} - Original", "gray"),
            (np.rot90(_overlay(img_s, lbl_s)), f"{name} - Ground Truth", None),
            (np.rot90(_overlay(img_s, prd_s)), f"{name} - Prediction", None),
        ]
        for col, (panel, title, cmap) in enumerate(panels):
            axes[row, col].imshow(panel, cmap=cmap)
            axes[row, col].set_title(title, pad=20)
            axes[row, col].axis("off")
    legend = [
        Patch(facecolor="red", label="Spleen"),
        Patch(facecolor="orange", label="Liver"),
        Patch(facecolor="green", label="Kidneys"),
    ]
    fig.legend(handles=legend, loc="upper center", bbox_to_anchor=(0.5, 0.02),
               ncol=3, bbox_transform=fig.transFigure)
    plt.tight_layout()
    plt.savefig(save_path, bbox_inches="tight", pad_inches=0.5)
    plt.close(fig)


def make_predict_fn(model: UNet3D, device: torch.device):
    """numpy (images, labels) -> (uint8 classes on the host, per-sample organ
    metrics (B, C-1) on the host)."""

    @torch.inference_mode()
    def predict(images: np.ndarray, labels: np.ndarray):
        x = torch.from_numpy(images).to(device)
        y = torch.from_numpy(labels).to(device)
        logits = model(x)
        pred = logits.argmax(dim=1)
        organ = per_class_dice_iou_per_sample(pred, y, num_classes=logits.shape[1])
        return (
            pred.to(torch.uint8).cpu().numpy(),
            organ["dice"].cpu().numpy(),
            organ["iou"].cpu().numpy(),
        )

    return predict


def test_model(model, device, test_dataset, args, results_dir) -> dict:
    predictions_dir = os.path.join(results_dir, "predictions")
    metrics_dir = os.path.join(results_dir, "metrics")
    visualizations_dir = os.path.join(results_dir, "visualizations")
    for d in (predictions_dir, metrics_dir, visualizations_dir):
        os.makedirs(d, exist_ok=True)

    predict = make_predict_fn(model, device)
    batch_size = max(1, int(args.batch_size or 1))
    loader = DataLoader(test_dataset, batch_size=batch_size, shuffle=False, num_workers=2)

    def export_sample(image0, label0, pred0, name, image_path):
        # per-sample resilience, as the reference eval: report and go on
        try:
            if not args.no_visualizations:
                visualize_prediction(
                    image0[0], label0, pred0,
                    os.path.join(visualizations_dir, f"{name}_pred.png"),
                )
            if not args.no_predictions:
                affine, header_bytes = load_nifti_header(image_path)
                save_nifti(
                    pred0, os.path.join(predictions_dir, f"{name}_pred.nii.gz"),
                    affine=affine, header=header_bytes,
                )
        except Exception as e:
            import traceback

            print(f"Error exporting {name}: {e}")
            traceback.print_exc()

    # warm-up on the full batch shape (kernel build/load; excluded from timing)
    img0, lbl0 = test_dataset[0]
    t0 = time.time()
    predict(np.repeat(img0[None], batch_size, 0), np.repeat(lbl0[None], batch_size, 0))
    _sync(device)
    warmup_time = time.time() - t0
    print(f"[WARMUP] first forward (incl. kernel build/load) took {warmup_time:.1f}s")

    per_sample = []
    total_inference_time = 0.0
    loop_start = time.time()
    # one writer thread: PNG render and NIfTI deflate overlap the next
    # forward, and pyplot's global figure state stays on one thread
    with ThreadPoolExecutor(max_workers=1) as writer_pool:
        export_futures = []
        for bi, (images, labels) in enumerate(loader):
            try:
                b = images.shape[0]
                if b < batch_size:  # ragged final batch: pad, drop rows on host
                    pad = batch_size - b
                    images = np.concatenate([images, np.repeat(images[:1], pad, 0)], 0)
                    labels = np.concatenate([labels, np.repeat(labels[:1], pad, 0)], 0)
                _sync(device)
                start = time.time()
                pred, dice, iou = predict(images, labels)
                _sync(device)
                batch_time = time.time() - start
                total_inference_time += batch_time

                for j in range(b):
                    i = bi * batch_size + j
                    sample = test_dataset.samples[i]
                    name = os.path.basename(sample.image_path)
                    for ext in (".nii.gz", ".nii"):
                        if name.endswith(ext):
                            name = name[: -len(ext)]
                    # disambiguate across datasets (the reference keys on
                    # the bare basename and overwrites shared case names)
                    name = f"{sample.dataset_name}_{name}"
                    row = {"filename": name, "inference_time": batch_time / b}
                    for c, organ in enumerate(ORGAN_NAMES):
                        row[f"dice_{organ}"] = float(dice[j, c])
                        row[f"iou_{organ}"] = float(iou[j, c])
                    print(
                        f"[{i + 1}/{len(test_dataset)}] {name}: "
                        + " ".join(f"{n}={row[f'dice_{n}']:.4f}" for n in ORGAN_NAMES)
                        + f" ({batch_time / b:.3f}s)"
                    )
                    export_futures.append(writer_pool.submit(
                        export_sample, images[j], labels[j], pred[j], name, sample.image_path,
                    ))
                    per_sample.append(row)
            except Exception as e:  # per-sample resilience, as the reference eval
                import traceback

                print(f"Error processing batch {bi + 1}: {e}")
                traceback.print_exc()
                continue
        for fut in export_futures:
            fut.result()
    end_to_end_time = time.time() - loop_start

    fieldnames = (
        ["filename"]
        + [f"dice_{n}" for n in ORGAN_NAMES]
        + [f"iou_{n}" for n in ORGAN_NAMES]
        + ["inference_time"]
    )
    with open(os.path.join(metrics_dir, "per_sample_metrics.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames)
        writer.writeheader()
        writer.writerows(per_sample)

    overall = {}
    for n in ORGAN_NAMES:
        overall[f"mean_dice_{n}"] = float(np.mean([r[f"dice_{n}"] for r in per_sample]))
        overall[f"mean_iou_{n}"] = float(np.mean([r[f"iou_{n}"] for r in per_sample]))
    overall["mean_dice_overall"] = float(np.mean([overall[f"mean_dice_{n}"] for n in ORGAN_NAMES]))
    overall["mean_iou_overall"] = float(np.mean([overall[f"mean_iou_{n}"] for n in ORGAN_NAMES]))
    overall["total_inference_time"] = total_inference_time
    # the JAX CLI's key: its first call compiles; here it builds/loads kernels
    overall["compile_time"] = warmup_time
    overall["end_to_end_time"] = end_to_end_time
    if per_sample and end_to_end_time > 0:
        overall["end_to_end_volumes_per_sec"] = round(len(per_sample) / end_to_end_time, 4)
    with open(os.path.join(metrics_dir, "metrics.json"), "w") as f:
        json.dump(overall, f, indent=4)

    print(f"\nTest results saved in: {results_dir}")
    for n in ORGAN_NAMES:
        print(f"{n.capitalize()} - Dice: {overall[f'mean_dice_{n}']:.4f}, "
              f"IoU: {overall[f'mean_iou_{n}']:.4f}")
    print(f"Overall Mean - Dice: {overall['mean_dice_overall']:.4f}, "
          f"IoU: {overall['mean_iou_overall']:.4f}")
    return overall


def main(args) -> dict:
    device = resolve_device(args.device, args.precision)
    model = UNet3D(
        in_channels=1, out_channels=NUM_CLASSES, features=parse_features(args.features),
        dropout_rate=0.0, dtype=DTYPES[args.precision],
    )
    load_params_any(model, args.model_path)
    model.to(device).eval()

    test_dataset = CombinedDataset(
        os.path.join(args.data_root, "test"), modalities=parse_modalities(args.modalities)
    )
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    results_dir = os.path.join(args.experiment_dir, f"test_results_{args.model_name}_{ts}")
    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, "test_config.txt"), "w") as f:
        f.write("Test Configuration:\n")
        for k, v in vars(args).items():
            f.write(f"{k}: {v}\n")

    print(f"\n[TEST] starting testing with model: {args.model_name} on {device}")
    return test_model(model, device, test_dataset, args, results_dir)


if __name__ == "__main__":
    main(build_parser().parse_args())
