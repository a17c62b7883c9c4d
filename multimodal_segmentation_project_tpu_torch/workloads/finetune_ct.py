"""Fine-tuning a pretrained UNet3D on a few labelled CT volumes, on one GPU
or several (torchrun, as ``train_unet``).

Port of ``multimodal_segmentation_project_tpu/workloads/finetune_ct.py``:
the same flags and defaults, plus ``--device``. It differs from baseline
training as the JAX CLI does:

* the weights start from ``--pretrained_model``, a reference-layout
  ``.pth`` or a JAX ``.msgpack``, loaded strictly (another ``--features``
  is refused);
* ``--freeze_encoder`` freezes the encoder and the bottleneck from the
  start, ``--freeze_encoder_epoch N`` at epoch N (for one epoch); the
  frozen parameters' gradients are still computed and dropped before
  AdamW, so they see no step and no weight decay;
* no augmentation and no LR scheduler; lr 1e-4 by default; modalities
  ``ct``;
* ``logs/finetune_log.csv``, ``finetune_checkpoint_epoch*_<name>.msgpack``
  and ``best_finetuned_model_<name>.msgpack``, each with its JSON sidecar,
  as the JAX CLI writes them.

    python -m multimodal_segmentation_project_tpu_torch.workloads.finetune_ct \\
        --pretrained_model best_model.msgpack --data_root data --experiment_dir exp \\
        --batch_size 1 --mixed_precision bf16 --freeze_encoder

It runs on the GPU unless ``--device cpu`` is given, in fp32 by default
(``--mixed_precision no``) or bf16 (see ``train_unet``).
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

from multimodal_segmentation_project_tpu_torch.data import CombinedDataset, seeded_subset
from multimodal_segmentation_project_tpu_torch.engine.trainer import Trainer, TrainerConfig
from multimodal_segmentation_project_tpu_torch.workloads.common import (
    add_common_args,
    experiment_name,
    init_world,
    parse_features,
    parse_modalities,
    resolve_device,
    resolve_precision,
    say,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Fine-tune UNet3D on CT data (PyTorch/CUDA)")
    add_common_args(parser, lr_default=1e-4)
    parser.add_argument("--pretrained_model", type=str, required=True)
    parser.add_argument("--modalities", type=str, default="ct")
    parser.add_argument("--freeze_encoder", action="store_true")
    parser.add_argument("--freeze_encoder_epoch", type=int, default=None)
    parser.add_argument(
        "--loss", type=str, default="ce_tversky",
        choices=["combined", "ce", "dice", "tversky", "ce_tversky"],
    )
    return parser


def default_experiment_name(args) -> str:
    """finetune_<ts>_<base model>_samples_<n>."""
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    base = os.path.basename(args.pretrained_model).split(".msgpack")[0].split(".pth")[0]
    return f"finetune_{ts}_{base}_samples_{args.n_samples}"


def main(args) -> dict:
    precision = resolve_precision(args.mixed_precision)
    device = resolve_device(args.device, precision)
    init_world(args)
    modalities = parse_modalities(args.modalities)
    train_dataset = CombinedDataset(os.path.join(args.data_root, "train"), modalities=modalities)
    val_dataset = CombinedDataset(os.path.join(args.data_root, "val"), modalities=modalities)
    train_dataset = seeded_subset(train_dataset, args.n_samples, args.seed)

    cfg = TrainerConfig(
        experiment_dir=args.experiment_dir,
        experiment_name=experiment_name(args, lambda: default_experiment_name(args)),
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        weight_decay=args.weight_decay,
        grad_accum=args.gradient_accumulation_steps,
        loss=args.loss,
        dropout_rate=args.dropout_rate,
        seed=args.seed,
        augment=False,
        use_scheduler=False,
        freeze_at_start=args.freeze_encoder,
        freeze_encoder_epoch=args.freeze_encoder_epoch,
        freeze_prefixes=("enc", "bottleneck"),
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
        pretrained_model=args.pretrained_model,
        pretrained_strict=True,
        log_name="finetune_log.csv",
        ckpt_prefix="finetune_checkpoint",
        best_prefix="best_finetuned_model",
        plot_title="Fine-tuning Metrics (CT Data)",
        extra_config={"modalities": args.modalities, "n_samples": args.n_samples},
    )
    say("[START] CT fine-tuning\n" + "=" * 50)
    return Trainer(cfg, train_dataset, val_dataset).run()


if __name__ == "__main__":
    main(build_parser().parse_args())
