"""Shared CLI plumbing for the port's workload drivers.

A copy of the JAX package's ``workloads/common.py`` flags and defaults
(the reference drivers' names, plus the JAX package's extras), so that a
recipe written for the JAX CLI runs here unchanged, and ``--device``,
which picks the GPU (default) or the CPU.

Several GPUs: one process per GPU under ``torchrun``.
:func:`maybe_init_multihost` initialises ``torch.distributed`` from
torchrun's environment whenever it is present (NCCL on CUDA, gloo with
``--device cpu``); ``--multihost`` names a multi-node torchrun launch.
:func:`check_world` refuses the mesh flags the world cannot satisfy
(``--n_spatial`` or ``--n_data`` asking for more ranks than exist,
``--multihost`` without torchrun's environment), with a hint to launch
under torchrun: a run never goes on with fewer ranks than it asked for.
"""

from __future__ import annotations

import argparse

import torch

from multimodal_segmentation_project_tpu_torch.parallel.mesh import (
    TORCHRUN_HINT,
    init_distributed,
    rank,
    torchrun_env,
    world_size,
)


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


def resolve_device(name: str, precision: str) -> torch.device:
    """The requested device; never a silent fall back to the CPU. Both
    precisions run on the GPU: fp32 (``--mixed_precision no``, the JAX
    CLIs' default) through the fp32 instances of the kernels, bf16 through
    the bf16 ones, so ``precision`` does not change the device."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine. The port runs on a GPU; "
                "pass --device cpu to run the plain PyTorch path on the CPU."
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
    # the JAX package's extras: the mesh over torchrun's ranks
    parser.add_argument("--n_spatial", type=int, default=1,
                        help="spatial (D-axis halo-exchange) sharding over ranks")
    parser.add_argument("--no_auto_spatial", action="store_true",
                        help="do not auto-raise n_spatial to fill idle ranks "
                             "when the global batch is smaller than the world")
    parser.add_argument("--n_data", type=int, default=None,
                        help="data-parallel axis size (default: the largest that divides "
                             "the global batch)")
    parser.add_argument("--no_remat", action="store_true",
                        help="accepted for the JAX CLI's recipes; the port does not rematerialize")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint to resume training from")
    parser.add_argument("--num_workers", type=int, default=2)
    parser.add_argument("--features", type=str, default="16,32,64,128",
                        help="encoder widths (bottleneck = 2x last)")
    parser.add_argument("--profile", action="store_true",
                        help="torch.profiler trace of the first epoch -> logs/profile: the "
                             "Chrome trace holds the training path's spans by name (data.wait, "
                             "data.upload, step.augment/forward/backward/update/sync), each "
                             "with its step's id 'epoch:step' in its args. The profiled "
                             "epoch's train steps run eagerly: on one GPU the steps replay as "
                             "CUDA graphs only from the first step after it")
    parser.add_argument("--no_nan_guard", action="store_true",
                        help="disable skip-update-on-nonfinite-gradients")
    parser.add_argument("--multihost", action="store_true",
                        help="a multi-node torchrun launch (torch.distributed initialises "
                             "from torchrun's environment whenever it is present)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu', which runs the plain PyTorch ops")
    return parser


def add_model_arg(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """``--model``: the train and eval CLIs' architecture."""
    parser.add_argument("--model", type=str, default="unet3d", choices=["unet3d", "swin_unetr"],
                        help="unet3d (--features are its widths) or swin_unetr: MONAI's SwinUNETR "
                             "at its published widths (feature size 48; --features ignored), on "
                             "one device, in bf16 on a GPU, volume sides multiples of 32, no "
                             "--freeze_encoder_epoch")
    return parser


def maybe_init_multihost(args) -> None:
    """``torch.distributed`` from torchrun's environment, when it is present:
    NCCL on CUDA, gloo on the CPU, one rank per GPU (LOCAL_RANK)."""
    if getattr(args, "multihost", False) and not torchrun_env():
        raise ValueError(f"--multihost needs torchrun's environment (RANK, WORLD_SIZE): "
                         f"{TORCHRUN_HINT}")
    if torchrun_env():
        init_distributed(device=getattr(args, "device", "cuda"))


def check_world(args) -> None:
    """Refuse mesh flags that ask for more ranks than the world has."""
    world = world_size()
    n_spatial = getattr(args, "n_spatial", 1) or 1
    n_data = getattr(args, "n_data", None)
    needed = (n_data or 1) * n_spatial
    if n_spatial < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"--n_spatial {n_spatial} and --n_data {n_data} must be >= 1")
    if needed > world:
        raise ValueError(f"--n_spatial {n_spatial} and --n_data {n_data} need {needed} ranks, "
                         f"the world has {world}: {TORCHRUN_HINT}")


def say(*args) -> None:
    """print on rank 0 only (every rank of a multi-GPU run runs the CLI)."""
    if rank() == 0:
        print(*args, flush=True)


def init_world(args) -> None:
    """The CLIs' start: :func:`maybe_init_multihost`, then :func:`check_world`."""
    maybe_init_multihost(args)
    check_world(args)
