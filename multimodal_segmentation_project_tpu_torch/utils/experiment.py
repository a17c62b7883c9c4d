"""Experiment bookkeeping: naming, directories, config dump, device log.

Port of ``multimodal_segmentation_project_tpu/utils/experiment.py``: the
same ``experiments/<name>/{checkpoints,logs,plots}`` tree, the same
``config.txt`` dump, and ``device_usage.log``, which here records the
CUDA caching allocator's statistics (the JAX package records the TPU's).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import datetime, timedelta

import torch


def format_time(seconds: float) -> str:
    return str(timedelta(seconds=int(seconds)))


def create_experiment_name(prefix: str, args, extras: str = "") -> str:
    """``<prefix>_<timestamp>_bs{b}_ep{e}_lr{lr}_wd{wd}[_freeze{n}][extras]``."""
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    core = f"bs{args.batch_size}_ep{args.epochs}_lr{args.lr}_wd{args.weight_decay}"
    if getattr(args, "freeze_encoder_epoch", None) is not None:
        core += f"_freeze{args.freeze_encoder_epoch}"
    return f"{prefix}_{ts}_{core}{extras}"


@dataclass
class ExperimentPaths:
    root: str
    checkpoints: str
    logs: str
    plots: str

    @classmethod
    def create(cls, experiment_dir: str, experiment_name: str) -> "ExperimentPaths":
        root = os.path.join(experiment_dir, experiment_name)
        paths = cls(
            root=root,
            checkpoints=os.path.join(root, "checkpoints"),
            logs=os.path.join(root, "logs"),
            plots=os.path.join(root, "plots"),
        )
        for p in (paths.root, paths.checkpoints, paths.logs, paths.plots):
            os.makedirs(p, exist_ok=True)
        return paths


def write_config(path: str, args) -> None:
    """Dump every arg as ``key: value`` lines."""
    src = vars(args) if not isinstance(args, dict) else args
    with open(path, "w") as f:
        for k, v in src.items():
            f.write(f"{k}: {v}\n")


def log_device_usage(log_file: str, device: torch.device, tag: str = "") -> None:
    """Append the device's allocator statistics (in use, peak, reserved,
    total), or a line saying the run is on the CPU."""
    lines = [f"{datetime.now().isoformat()} {tag}".rstrip()]
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        lines.append(
            f"{torch.cuda.get_device_name(device)} ({device}): "
            f"in_use={torch.cuda.memory_allocated(device) / 1e9:.3f}GB "
            f"peak={torch.cuda.max_memory_allocated(device) / 1e9:.3f}GB "
            f"reserved={torch.cuda.memory_reserved(device) / 1e9:.3f}GB "
            f"free={free / 1e9:.3f}GB total={total / 1e9:.3f}GB"
        )
    else:
        lines.append(f"{device}: no device memory statistics on the CPU")
    with open(log_file, "a") as f:
        f.write("\n".join(lines) + "\n" + "=" * 80 + "\n")
