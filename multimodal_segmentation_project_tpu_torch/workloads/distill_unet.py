"""Knowledge distillation, a frozen teacher to a student, on one GPU.

Port of ``multimodal_segmentation_project_tpu/workloads/distill_unet.py``:
the same flags and defaults, plus ``--device``. The teacher is a UNet3D of
the same widths, loaded strictly from ``--teacher_model`` (a
reference-layout ``.pth`` or a JAX ``.msgpack``) and held frozen: on every step it runs its eval
forward (BatchNorm folded) under ``torch.no_grad()``. The student trains
on the KD loss, ``alpha * (CE + Tversky) + (1 - alpha) * T^2 * KL``
(``ops/losses.py:distillation_loss``, with ``--alpha`` and
``--temperature``), with no augmentation and no scheduler. Validation
scores the student with ``--loss``. Only the best student is saved
(``best_student_<name>.msgpack`` and its JSON sidecar, as the JAX CLI
writes it); the log is ``logs/distill_log.csv``.

    python -m multimodal_segmentation_project_tpu_torch.workloads.distill_unet \\
        --teacher_model best_model.msgpack --data_root data --experiment_dir exp \\
        --batch_size 1 --mixed_precision bf16 --alpha 0.7 --temperature 2.0

It runs on the GPU unless ``--device cpu`` is given, in fp32 by default
(``--mixed_precision no``) or bf16 (see ``train_unet``).
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

from multimodal_segmentation_project_tpu_torch.data import CombinedDataset, seeded_subset
from multimodal_segmentation_project_tpu_torch.engine import checkpoint as ckpt
from multimodal_segmentation_project_tpu_torch.engine.trainer import (
    Trainer,
    TrainerConfig,
    build_model,
)
from multimodal_segmentation_project_tpu_torch.ops.losses import distillation_loss
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
        description="Knowledge distillation for 3D U-Net segmentation (PyTorch/CUDA)"
    )
    add_common_args(parser)
    parser.add_argument("--teacher_model", type=str, required=True)
    parser.add_argument("--modalities", type=str, default="all")
    parser.add_argument("--alpha", type=float, default=0.7,
                        help="weight of the segmentation term")
    parser.add_argument("--temperature", type=float, default=4.0,
                        help="softening temperature (SLURM recipes use 2.0)")
    parser.add_argument(
        "--loss", type=str, default="combined",
        choices=["combined", "ce", "dice", "tversky", "ce_tversky"],
        help="validation loss (train always uses the KD loss)",
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

    cfg = TrainerConfig(
        experiment_dir=args.experiment_dir,
        experiment_name=experiment_name(
            args, lambda: f"distill_{datetime.now().strftime('%Y%m%d_%H%M%S')}"),
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
        early_stopping=args.early_stopping,
        patience=args.patience,
        precision=precision,
        features=parse_features(args.features),
        nan_guard=not args.no_nan_guard,
        profile_first_epoch=args.profile,
        resume=args.resume,
        num_workers=args.num_workers,
        device=str(device),
        log_name="distill_log.csv",
        best_prefix="best_student",
        checkpoint_every=10**9,  # the reference saves the best student only
        plot_title="Distillation Metrics",
        extra_config={
            "modalities": args.modalities,
            "n_samples": args.n_samples,
            "teacher_model": args.teacher_model,
            "alpha": args.alpha,
            "temperature": args.temperature,
        },
    )
    teacher = build_model(cfg)
    ckpt.load_params_any(teacher, args.teacher_model)
    print(f"[START] knowledge distillation (teacher: {args.teacher_model})")

    def kd(student_logits, teacher_logits, labels):
        return distillation_loss(student_logits, teacher_logits, labels, alpha=args.alpha,
                                 temperature=args.temperature)

    return Trainer(cfg, train_dataset, val_dataset, teacher=teacher, kd_loss_fn=kd).run()


if __name__ == "__main__":
    main(build_parser().parse_args())
