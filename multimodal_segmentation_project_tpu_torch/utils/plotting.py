"""End-of-run training dashboards.

A copy of the JAX package's ``utils/plotting.py``: a 2x2
loss/dice/iou/accuracy figure (``training_metrics.png``) and a per-epoch
time figure (``training_time.png``) from the training CSV, with
encoder-frozen epochs shaded. matplotlib is imported inside the plotting
call, so the training path runs where it is not installed (the trainer
warns when a plot fails).
"""

from __future__ import annotations

import csv
import os


def _read_log(log_file: str) -> dict[str, list]:
    cols: dict[str, list] = {}
    with open(log_file) as f:
        for row in csv.DictReader(f):
            for k, v in row.items():
                cols.setdefault(k, []).append(v)
    out = {}
    for k, vals in cols.items():
        if k == "encoder_frozen":
            out[k] = [v.lower() == "true" for v in vals]
        elif k == "epoch":
            out[k] = [int(v) for v in vals]
        else:
            out[k] = [float(v) for v in vals]
    return out


def _frozen_regions(epochs, frozen):
    regions, start = [], None
    for e, fr in zip(epochs, frozen):
        if fr and start is None:
            start = e
        elif not fr and start is not None:
            regions.append((start, e - 1))
            start = None
    if start is not None:
        regions.append((start, epochs[-1]))
    return regions


def _shade_frozen(ax, epochs, frozen):
    if not any(frozen):
        return
    for i, (s, e) in enumerate(_frozen_regions(epochs, frozen)):
        ax.axvspan(s, e, alpha=0.2, color="red", label="Encoder Frozen" if i == 0 else "")
        ax.axvline(x=s, color="red", linestyle="--", alpha=0.7)
        ax.axvline(x=e, color="red", linestyle="--", alpha=0.7)
    ax.legend()


def plot_training_metrics(
    log_file: str,
    save_dir: str,
    title: str = "Training Metrics",
    metrics_name: str = "training_metrics.png",
    time_name: str = "training_time.png",
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = _read_log(log_file)
    epochs = d["epoch"]
    frozen = d.get("encoder_frozen", [False] * len(epochs))

    panels = [
        ("loss", "Loss", "Training and Validation Loss"),
        ("dice", "Dice Score", "Training and Validation Dice Score"),
        ("iou", "IoU Score", "Training and Validation IoU Score"),
        ("acc", "Accuracy", "Training and Validation Accuracy"),
    ]
    fig, axes = plt.subplots(2, 2, figsize=(15, 12))
    fig.suptitle(title, fontsize=16)
    for ax, (key, ylabel, subtitle) in zip(axes.flat, panels):
        tr, va = d.get(f"train_{key}"), d.get(f"val_{key}")
        if tr:
            ax.plot(epochs, tr, label=f"Train {ylabel.split()[0]}", marker="o")
        if va:
            ax.plot(epochs, va, label=f"Val {ylabel.split()[0]}", marker="o")
        ax.set_xlabel("Epoch")
        ax.set_ylabel(ylabel)
        ax.set_title(subtitle)
        ax.legend()
        ax.grid(True)
        _shade_frozen(ax, epochs, frozen)
    plt.tight_layout()
    plt.savefig(os.path.join(save_dir, metrics_name))
    plt.close(fig)

    plt.figure(figsize=(10, 6))
    plt.plot(epochs, d["time"], marker="o")
    plt.xlabel("Epoch")
    plt.ylabel("Time (seconds)")
    plt.title("Training Time per Epoch")
    plt.grid(True)
    _shade_frozen(plt.gca(), epochs, frozen)
    plt.savefig(os.path.join(save_dir, time_name))
    plt.close()
