"""DANN domain-adversarial adaptation, MRI source to CT target, on one GPU.

Port of ``multimodal_segmentation_project_tpu/workloads/train_dann.py``:
the same flags and defaults, plus ``--device``, and the same five
directories under ``--data_root``:

  train/               source-modality labelled volumes
  dann_add_labeled/    extra target-modality labelled volumes (source stream)
  val/                 the target modality's validation split
  target/              target-modality volumes, their labels unused
  dann_add_unlabeled/  extra target-modality volumes (target stream)

``--n_add_source`` limits both extra pools, ``--n_target`` the volumes of
``target/``, and ``--n_samples`` the merged streams, each by the JAX
CLI's seeded draw (:func:`_rng_subset`). ``--pretrained_model`` (``.pth``
or JAX ``.msgpack``) loads non-strictly (a missing or shape-mismatched key
keeps its initial value), and ``--resume`` takes either format.
The encoder freezes at ``--freeze_encoder_epoch``; there is no
augmentation and no scheduler. The step (``engine/steps.py:make_dann_step``)
keeps the JAX package's double lambda, one backward and two AdamW states.
The checkpoints are the JAX CLI's ``.msgpack`` files and sidecars: the
UNet3D's train state, which the eval CLI loads, and the discriminator's
params and optimizer beside it (``disc_params``, ``disc_opt_state``).

    python -m multimodal_segmentation_project_tpu_torch.workloads.train_dann \\
        --source_modality mri --target_modality ct --data_root data_dann \\
        --experiment_dir exp --batch_size 1 --mixed_precision bf16 \\
        --lambda_domain 0.2 --loss ce_tversky

It runs on the GPU unless ``--device cpu`` is given, in fp32 by default
(``--mixed_precision no``) or bf16 (see ``train_unet``).
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np

from multimodal_segmentation_project_tpu_torch.data import CombinedDataset, ConcatDataset, Subset
from multimodal_segmentation_project_tpu_torch.engine.trainer import DannTrainer, TrainerConfig
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
    parser = argparse.ArgumentParser(
        description="DANN training for multimodal segmentation (PyTorch/CUDA)"
    )
    add_common_args(parser)
    parser.add_argument("--source_modality", type=str, required=True)
    parser.add_argument("--target_modality", type=str, required=True)
    parser.add_argument("--lambda_domain", type=float, default=0.1)
    parser.add_argument("--n_add_source", type=int, default=None)
    parser.add_argument("--n_target", type=int, default=None)
    parser.add_argument("--pretrained_model", type=str, default=None)
    parser.add_argument("--freeze_encoder_epoch", type=int, default=None)
    parser.add_argument(
        "--loss", type=str, default="ce_tversky",
        choices=["combined", "ce", "dice", "tversky", "ce_tversky"],
    )
    return parser


def _rng_subset(dataset, n, seed):
    if n is None or n >= len(dataset):
        return dataset
    rng = np.random.default_rng(seed) if seed is not None else np.random.default_rng()
    return Subset(dataset, rng.choice(len(dataset), n, replace=False))


def default_experiment_name(args) -> str:
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    return (
        f"dann_{ts}_bs{args.batch_size}_ep{args.epochs}_lr{args.lr}"
        f"_wd{args.weight_decay}_ld{args.lambda_domain}"
        f"_add{args.n_add_source}_ns{args.n_samples}"
    )


def main(args) -> dict:
    check_one_device(args)
    precision = resolve_precision(args.mixed_precision)
    device = resolve_device(args.device, precision)
    src_mod = parse_modalities(args.source_modality)
    tgt_mod = parse_modalities(args.target_modality)

    root = args.data_root
    train_src = CombinedDataset(os.path.join(root, "train"), modalities=src_mod)
    add_labeled = CombinedDataset(os.path.join(root, "dann_add_labeled"), modalities=tgt_mod)
    val_ds = CombinedDataset(os.path.join(root, "val"), modalities=tgt_mod)
    train_tgt = CombinedDataset(os.path.join(root, "target"), modalities=tgt_mod)
    add_unlabeled = CombinedDataset(os.path.join(root, "dann_add_unlabeled"), modalities=tgt_mod)

    add_labeled = _rng_subset(add_labeled, args.n_add_source, args.seed)
    add_unlabeled = _rng_subset(add_unlabeled, args.n_add_source, args.seed)
    train_tgt = _rng_subset(train_tgt, args.n_target, args.seed)
    source = _rng_subset(ConcatDataset([train_src, add_labeled]), args.n_samples, args.seed)
    target = _rng_subset(ConcatDataset([train_tgt, add_unlabeled]), args.n_samples, args.seed)
    print(
        f"[INFO] source: {len(train_src)} train + {len(add_labeled)} add = {len(source)}; "
        f"target: {len(train_tgt)} + {len(add_unlabeled)} = {len(target)}; "
        f"val: {len(val_ds)}"
    )

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
        pretrained_model=args.pretrained_model,
        pretrained_strict=False,
        extra_config={
            "source_modality": args.source_modality,
            "target_modality": args.target_modality,
            "lambda_domain": args.lambda_domain,
            "n_add_source": args.n_add_source,
            "n_samples": args.n_samples,
        },
    )
    print("[START] DANN adversarial training\n" + "=" * 50)
    return DannTrainer(cfg, source, target, val_ds, lambda_domain=args.lambda_domain).run()


if __name__ == "__main__":
    main(build_parser().parse_args())
