"""Shared CLI plumbing for the port's workload drivers.

A copy of the JAX package's ``workloads/common.py`` flags and defaults
(the reference drivers' names, plus the JAX package's extras), so that a
recipe written for the JAX CLI runs here unchanged, and ``--device``,
which picks the GPU (default) or the CPU.
"""

from __future__ import annotations

import argparse

import torch


def parse_modalities(value):
    """'all' -> None; 'ct,mri' -> ['ct', 'mri']."""
    if value is None or (isinstance(value, str) and value.lower() == "all"):
        return None
    if isinstance(value, str):
        return [m.strip().lower() for m in value.split(",")]
    return value


def parse_features(value) -> tuple:
    if isinstance(value, (tuple, list)):
        return tuple(int(v) for v in value)
    return tuple(int(v) for v in str(value).split(","))


def resolve_precision(mixed_precision: str) -> str:
    """The reference's --mixed_precision -> the compute policy: 'fp16' and
    'bf16' select bf16 compute (no loss scaling), 'no' selects fp32."""
    if mixed_precision in ("fp16", "bf16"):
        return "bf16"
    return "fp32"


FP32_TRAINING_KERNELS = (
    "the conv forward and its dx, the conv weight gradient, the fused DoubleConv's conv+stats, "
    "boundary conv+stats, dx-epilogue and prologue weight-gradient kernels, the pool backward, "
    "and the head's dx and weight gradient"
)


def resolve_device(name: str, precision: str, *, eval_only: bool = False) -> torch.device:
    """The requested device; never a silent fall back to the CPU. On the GPU
    fp32 runs the eval forward only (``eval_only``: the eval CLI): the fp32
    instances of the training kernels are not ported yet, so fp32 training
    runs only with ``--device cpu``."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine. The port runs on a GPU; "
                "pass --device cpu to run the plain PyTorch path on the CPU."
            )
        if precision != "bf16" and not eval_only:
            raise ValueError(
                f"fp32 training on the GPU needs the fp32 instances of the training kernels "
                f"({FP32_TRAINING_KERNELS}), which are not ported yet: train with "
                f"--mixed_precision bf16 on the GPU, or in fp32 with --device cpu"
            )
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return device


def experiment_name(args, default) -> str:
    """``args.experiment_name`` where the caller set one on the namespace (no
    flag sets it, as in the JAX package's CLIs, which read it with ``getattr``),
    else ``default()``."""
    return getattr(args, "experiment_name", None) or default()


def add_common_args(parser: argparse.ArgumentParser, lr_default: float = 1e-3):
    parser.add_argument("--data_root", type=str, required=True,
                        help="Root directory of the dataset splits")
    parser.add_argument("--experiment_dir", type=str, default="experiments")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--lr", type=float, default=lr_default)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--mixed_precision", type=str, default="no",
                        choices=["no", "fp16", "bf16"])
    parser.add_argument("--dropout_rate", type=float, default=0.1)
    parser.add_argument("--early_stopping", action="store_true")
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--n_samples", type=int, default=None)
    # the JAX package's extras; the mesh flags take one device only here
    parser.add_argument("--n_spatial", type=int, default=1,
                        help="volume sharding over devices (only 1: one GPU)")
    parser.add_argument("--no_auto_spatial", action="store_true",
                        help="accepted for the JAX CLI's recipes; one GPU has no idle chips")
    parser.add_argument("--n_data", type=int, default=None,
                        help="data-parallel size (only 1: one GPU)")
    parser.add_argument("--no_remat", action="store_true",
                        help="accepted for the JAX CLI's recipes; the port does not rematerialize")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint to resume training from")
    parser.add_argument("--num_workers", type=int, default=2)
    parser.add_argument("--features", type=str, default="16,32,64,128",
                        help="encoder widths (bottleneck = 2x last)")
    parser.add_argument("--profile", action="store_true",
                        help="torch.profiler trace of the first epoch -> logs/profile")
    parser.add_argument("--no_nan_guard", action="store_true",
                        help="disable skip-update-on-nonfinite-gradients")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host training (not in the port yet)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu', which runs the plain PyTorch ops")
    return parser


def check_one_device(args) -> None:
    """The port trains on one GPU so far: refuse mesh flags clearly."""
    if args.n_spatial != 1 or (args.n_data not in (None, 1)) or args.multihost:
        raise ValueError(
            "the port trains on one device: --n_spatial 1, --n_data 1 (or unset) and "
            "no --multihost (multi-GPU training is a later slice)"
        )
