#!/usr/bin/env python3
"""Augmentation visual QA with the PyTorch/CUDA port: original vs augmented.

The port's counterpart of ``visualize_augmentations.py``: loads one sample
via the port's CombinedDataset, runs the port's augmentation pipeline
(``ops/augment.py``, the functions its train step applies) on the device
from a ``torch.Generator`` seeded with ``--seed``, and renders the 2x2
original/transformed image/label comparison PNG. Headless by default
(``--save``); deterministic given ``--seed``. It runs on the GPU;
``--device cpu`` runs it on the CPU.

Usage:
  python scripts/plotting/visualize_augmentations_torch.py <data_root> \
      [--index 0] [--seed 0] [--axis axial] [--save aug_comparison.png] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from multimodal_segmentation_project_tpu_torch.ops.augment import augmented_pair  # noqa: E402
from multimodal_segmentation_project_tpu_torch.workloads.common import resolve_device  # noqa: E402

AXES = {"axial": 1, "coronal": 2, "sagittal": 3}  # (D, H, W) volume axes


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data_root", help="dataset root (CombinedDataset layout)")
    ap.add_argument("--index", type=int, default=0, help="sample index")
    ap.add_argument("--seed", type=int, default=0, help="augmentation generator seed")
    ap.add_argument("--modalities", default="ct,mri")
    ap.add_argument("--axis", default="axial", choices=list(AXES))
    ap.add_argument("--save", default="aug_comparison.png",
                    help="output PNG path ('' to show interactively)")
    ap.add_argument("--prob", type=float, default=1.0,
                    help="per-transform probability (default 1.0 so the "
                         "QA image always shows every transform; training "
                         "uses 0.3)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    import matplotlib
    if args.save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    device = resolve_device(args.device, "fp32")
    orig_img, aug_img, orig_lbl, aug_lbl = (
        t.cpu().numpy() for t in augmented_pair(args.data_root, args.index, args.seed,
                                                args.prob, device, args.modalities.split(",")))

    ax_idx = AXES[args.axis] - 1  # volume is (D, H, W)
    mid = orig_img.shape[ax_idx] // 2

    def get_slice(vol):
        return np.take(vol, mid, axis=ax_idx)

    fig, axs = plt.subplots(2, 2, figsize=(12, 10))
    axs[0, 0].imshow(get_slice(orig_img), cmap="gray")
    axs[0, 0].set_title("Original Image (mid slice)")
    axs[0, 1].imshow(get_slice(aug_img), cmap="gray")
    axs[0, 1].set_title(f"Augmented Image (seed {args.seed})")
    axs[1, 0].imshow(get_slice(orig_lbl), cmap="tab10", vmin=0, vmax=3)
    axs[1, 0].set_title("Original Label (mid slice)")
    axs[1, 1].imshow(get_slice(aug_lbl), cmap="tab10", vmin=0, vmax=3)
    axs[1, 1].set_title("Augmented Label (same slice)")
    for ax in axs.ravel():
        ax.axis("off")
    plt.tight_layout()
    if args.save:
        plt.savefig(args.save, dpi=100)
        print(f"saved {args.save}")
    else:
        plt.show()


if __name__ == "__main__":
    main()
