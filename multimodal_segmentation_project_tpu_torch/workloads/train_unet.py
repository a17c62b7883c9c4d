"""Baseline supervised 3D U-Net training on one GPU or several.

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
where there is none raises. ``--mixed_precision no`` (the default, as in
the JAX CLI) trains in fp32, on the fp32 instances of the kernels; bf16
(or fp16, which selects bf16 compute) on the bf16 ones. ``--no_remat`` is
accepted and changes nothing here.

On several GPUs, one process per GPU under torchrun (NCCL)::

    torchrun --standalone --nproc_per_node 4 \
        -m multimodal_segmentation_project_tpu_torch.workloads.train_unet --batch_size 1 ...

``--batch_size`` is the global batch. The trainer picks the mesh as the JAX
trainer does: the largest data axis that divides the batch, then
``--n_spatial`` raised to split the volume's D over the idle ranks
(``--no_auto_spatial`` keeps them idle; ``--n_data`` and ``--n_spatial`` set
the axes). Flags asking for more ranks than torchrun started are refused.
Only rank 0 writes the experiment's files.

``--model swin_unetr`` trains SwinUNETR (``models/swin_unetr.py``) at its
published widths instead of UNet3D, on one GPU in bf16 (or on the CPU);
its checkpoints nest its state dict's names.
"""

from __future__ import annotations

import argparse
import os

from multimodal_segmentation_project_tpu_torch.data import CombinedDataset, seeded_subset
from multimodal_segmentation_project_tpu_torch.engine.trainer import Trainer, TrainerConfig
from multimodal_segmentation_project_tpu_torch.utils.experiment import create_experiment_name
from multimodal_segmentation_project_tpu_torch.workloads.common import (
    add_common_args,
    add_model_arg,
    experiment_name,
    init_world,
    parse_features,
    parse_modalities,
    resolve_device,
    resolve_precision,
    say,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train UNet3D model (PyTorch/CUDA)")
    add_common_args(parser)
    add_model_arg(parser)
    parser.add_argument("--modalities", type=str, default="all")
    parser.add_argument("--freeze_encoder_epoch", type=int, default=None)
    parser.add_argument(
        "--loss", type=str, default="combined",
        choices=["combined", "ce", "dice", "tversky", "ce_tversky"],
    )
    return parser


def main(args) -> dict:
    precision = resolve_precision(args.mixed_precision)
    device = resolve_device(args.device, precision)
    init_world(args)
    modalities = parse_modalities(args.modalities)
    train_dataset = CombinedDataset(os.path.join(args.data_root, "train"), modalities=modalities)
    val_dataset = CombinedDataset(os.path.join(args.data_root, "val"), modalities=modalities)
    train_dataset = seeded_subset(train_dataset, args.n_samples, args.seed)
    if args.n_samples is not None:
        say(f"[INFO] limited training dataset to {len(train_dataset)} random samples")

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
        n_spatial=args.n_spatial,
        auto_spatial=not args.no_auto_spatial,
        n_data=args.n_data,
        device=str(device),
        model=args.model,
        extra_config={"modalities": args.modalities, "n_samples": args.n_samples},
    )
    say("[START] baseline training\n" + "=" * 50)
    return Trainer(cfg, train_dataset, val_dataset).run()


if __name__ == "__main__":
    main(build_parser().parse_args())
