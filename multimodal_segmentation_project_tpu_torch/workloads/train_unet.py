"""Baseline supervised 3D U-Net training on one GPU.

Port of ``multimodal_segmentation_project_tpu/workloads/train_unet.py``:
the same flags and defaults (the reference driver's, plus the JAX
package's extras) and the same loop (``engine/trainer.py``): on-device
augmentation, the plateau LR scheduler on val Dice, and the
``experiments/<name>/{checkpoints,logs,plots}`` layout, with the JAX CLI's
checkpoints, ``checkpoint_epoch<N>_<name>.msgpack`` and
``best_model_<name>.msgpack`` and their JSON sidecars, which the eval CLI
(``workloads/test_model.py``) and the JAX package load. ``--resume`` takes
such a ``.msgpack`` or a ``.pth`` train checkpoint of the port.

    python -m multimodal_segmentation_project_tpu_torch.workloads.train_unet \\
        --data_root data --experiment_dir exp --batch_size 1 --epochs 100 \\
        --mixed_precision bf16 --loss ce_tversky --early_stopping --patience 10

It runs on the GPU unless ``--device cpu`` is given; asking for the GPU
where there is none raises. The fp32 instances of the training kernels are
not ported yet, so on the GPU ``--mixed_precision`` must be bf16 (or fp16,
which selects bf16 compute); ``no`` (fp32) trains with ``--device cpu``.
The mesh flags take one device only (``--n_spatial 1``, ``--n_data`` 1 or
unset, no ``--multihost``) until the port trains on several GPUs. ``--no_remat`` and ``--no_auto_spatial``
are accepted and change nothing here.
"""

from __future__ import annotations

import argparse
import os

from multimodal_segmentation_project_tpu_torch.data import CombinedDataset, seeded_subset
from multimodal_segmentation_project_tpu_torch.engine.trainer import Trainer, TrainerConfig
from multimodal_segmentation_project_tpu_torch.utils.experiment import create_experiment_name
from multimodal_segmentation_project_tpu_torch.workloads.common import (
    add_common_args,
    check_one_device,
    experiment_name,
    parse_features,
    parse_modalities,
    resolve_device,
    resolve_precision,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train UNet3D model (PyTorch/CUDA)")
    add_common_args(parser)
    parser.add_argument("--modalities", type=str, default="all")
    parser.add_argument("--freeze_encoder_epoch", type=int, default=None)
    parser.add_argument(
        "--loss", type=str, default="combined",
        choices=["combined", "ce", "dice", "tversky", "ce_tversky"],
    )
    return parser


def main(args) -> dict:
    check_one_device(args)
    precision = resolve_precision(args.mixed_precision)
    device = resolve_device(args.device, precision)
    modalities = parse_modalities(args.modalities)
    train_dataset = CombinedDataset(os.path.join(args.data_root, "train"), modalities=modalities)
    val_dataset = CombinedDataset(os.path.join(args.data_root, "val"), modalities=modalities)
    train_dataset = seeded_subset(train_dataset, args.n_samples, args.seed)
    if args.n_samples is not None:
        print(f"[INFO] limited training dataset to {len(train_dataset)} random samples")

    cfg = TrainerConfig(
        experiment_dir=args.experiment_dir,
        experiment_name=experiment_name(args, lambda: create_experiment_name("exp", args)),
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        weight_decay=args.weight_decay,
        grad_accum=args.gradient_accumulation_steps,
        loss=args.loss,
        dropout_rate=args.dropout_rate,
        seed=args.seed,
        augment=True,
        use_scheduler=True,
        freeze_encoder_epoch=args.freeze_encoder_epoch,
        freeze_prefixes=("enc",),
        early_stopping=args.early_stopping,
        patience=args.patience,
        precision=precision,
        features=parse_features(args.features),
        nan_guard=not args.no_nan_guard,
        profile_first_epoch=args.profile,
        resume=args.resume,
        num_workers=args.num_workers,
        device=str(device),
        extra_config={"modalities": args.modalities, "n_samples": args.n_samples},
    )
    print("[START] baseline training\n" + "=" * 50)
    return Trainer(cfg, train_dataset, val_dataset).run()


if __name__ == "__main__":
    main(build_parser().parse_args())
