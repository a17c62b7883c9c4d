#!/usr/bin/env python3
"""Quickstart of the PyTorch/CUDA port: the full workflow on synthetic data.

The port's counterpart of ``examples/quickstart.py``: it writes the same
tiny synthetic dataset (32^3 CT volumes from ``np.random.default_rng(0)``),
runs the augmentation pipeline on the device and renders its before/after
comparison (where matplotlib is installed), trains a UNet3D (8, 16) for a
few epochs in bf16 with the port's train CLI, and evaluates its best
checkpoint with the port's eval CLI. It runs on the GPU; ``--device cpu``
runs the plain PyTorch versions of the kernels on the CPU.

  python examples/quickstart_torch.py --workdir /tmp/quickstart_torch
  python examples/quickstart_torch.py --workdir /tmp/quickstart_torch --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from multimodal_segmentation_project_tpu_torch.data.nifti import save_nifti  # noqa: E402


def make_dataset(root, size=32):
    rng = np.random.default_rng(0)
    for split, n in [("train", 6), ("val", 2), ("test", 2)]:
        img_dir = os.path.join(root, split, "quick_ct", "images")
        lbl_dir = os.path.join(root, split, "quick_ct", "labels")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(lbl_dir, exist_ok=True)
        for i in range(n):
            lbl = np.zeros((size, size, size), np.int16)
            c = rng.integers(4, size - 14, 3)
            lbl[c[0]:c[0] + 10, c[1]:c[1] + 10, c[2]:c[2] + 10] = 2
            lbl[c[0]:c[0] + 4, c[1]:c[1] + 4, c[2]:c[2] + 4] = 1
            img = (lbl > 0) * 150.0 + rng.normal(0, 20, lbl.shape)
            save_nifti(img.astype(np.float32), f"{img_dir}/case{i:02d}.nii.gz")
            save_nifti(lbl, f"{lbl_dir}/case{i:02d}.nii.gz")
    print(f"synthetic dataset at {root}")


def augmentation_demo(root, out_png, device: str = "cuda", seed: int = 0):
    """The first training sample and its augmentation (every transform, p =
    1) on ``device``, from a generator seeded with ``seed``; the 2x2
    comparison PNG where matplotlib is installed."""
    from multimodal_segmentation_project_tpu_torch.ops.augment import augmented_pair
    from multimodal_segmentation_project_tpu_torch.workloads.common import resolve_device

    img, aug_img, lbl, aug_lbl = augmented_pair(os.path.join(root, "train"), 0, seed, 1.0,
                                                resolve_device(device, "fp32"))
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no augmentation comparison PNG")
        return

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z = img.shape[-1] // 2
    fig, axs = plt.subplots(2, 2, figsize=(10, 9))
    panels = [
        (img[:, :, z], "Original image", "gray"),
        (aug_img[:, :, z], "Augmented image", "gray"),
        (lbl[:, :, z], "Original label", "tab10"),
        (aug_lbl[:, :, z], "Augmented label", "tab10"),
    ]
    for ax, (sl, title, cmap) in zip(axs.flat, panels):
        ax.imshow(sl.float().cpu().numpy(), cmap=cmap, vmin=0 if cmap == "tab10" else None,
                  vmax=3 if cmap == "tab10" else None)
        ax.set_title(title)
        ax.axis("off")
    plt.tight_layout()
    plt.savefig(out_png)
    plt.close(fig)
    print(f"augmentation comparison saved to {out_png}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default="/tmp/quickstart_torch")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--skip_train", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu', which runs the plain PyTorch ops")
    return p


def main(argv=None) -> dict:
    """The workflow; returns the best checkpoint's path and the eval CLI's
    overall metrics (empty with ``--skip_train``)."""
    args = build_parser().parse_args(argv)
    data_root = os.path.join(args.workdir, "data")
    exp_dir = os.path.join(args.workdir, "experiments")
    make_dataset(data_root)
    augmentation_demo(data_root, os.path.join(args.workdir, "augmentation.png"), args.device)
    if args.skip_train:
        return {}

    from multimodal_segmentation_project_tpu_torch.workloads import test_model, train_unet

    train_args = train_unet.build_parser().parse_args([
        "--data_root", data_root,
        "--experiment_dir", exp_dir,
        "--batch_size", "2",
        "--epochs", str(args.epochs),
        "--loss", "ce_tversky",
        "--modalities", "ct",
        "--features", "8,16",
        "--mixed_precision", "bf16",
        "--device", args.device,
    ])
    train_unet.main(train_args)

    best = None
    for sub in sorted(os.listdir(exp_dir)):
        cdir = os.path.join(exp_dir, sub, "checkpoints")
        if os.path.isdir(cdir):
            for f in os.listdir(cdir):
                if f.startswith("best_model") and f.endswith(".msgpack"):
                    best = os.path.join(cdir, f)
    if best is None:
        raise RuntimeError("training produced no best checkpoint")

    eval_args = test_model.build_parser().parse_args([
        "--model_path", best,
        "--data_root", data_root,
        "--experiment_dir", exp_dir,
        "--model_name", "quickstart",
        "--features", "8,16",
        "--device", args.device,
    ])
    overall = test_model.main(eval_args)
    print(f"\nall artifacts under {args.workdir}")
    return {"best": best, "eval": overall}


if __name__ == "__main__":
    main()
