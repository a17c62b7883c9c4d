"""Orchestrator CLI: one entry point for every workload CLI of the port.

Port of ``multimodal_segmentation_project_tpu/workloads/main.py``: the
same ``--experiment {train,finetune,eval,dann,distill,transfer,cyclegan}``
and the same flags and defaults, plus ``--device``. Each CLI runs in
this process, on a namespace built from its own parser's flags, taking the
orchestrator's value where the orchestrator has the flag and its own
default otherwise. ``eval`` runs the port's ``test_model``. ``transfer``
and ``cyclegan`` are stubs that print, as in the reference.

    python -m multimodal_segmentation_project_tpu_torch.workloads.main \\
        --experiment finetune --pretrained_model best_model.msgpack \\
        --data_root data --batch_size 1 --mixed_precision bf16 --modalities ct

It runs on the GPU unless ``--device cpu`` is given; asking for the GPU
where there is none raises. Every training experiment runs in fp32 by
default (``--mixed_precision no``) or in bf16.
"""

from __future__ import annotations

import argparse
import os

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Orchestrate multimodal segmentation experiments (PyTorch/CUDA)"
    )
    parser.add_argument(
        "--experiment", type=str, default="train",
        choices=["train", "finetune", "eval", "transfer", "dann", "distill", "cyclegan"],
    )
    parser.add_argument("--data_root", type=str, default="datasets/resampled")
    parser.add_argument("--batch_size", type=int, default=2)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--experiment_dir", type=str, default="experiments")
    parser.add_argument("--modalities", type=str, default="all")
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--pretrained_model", type=str, default=None)
    parser.add_argument("--freeze_encoder", action="store_true")
    parser.add_argument("--freeze_encoder_epoch", type=int, default=None)
    parser.add_argument("--model_path", type=str, default=None)
    parser.add_argument("--model_name", type=str, default="unet")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--mixed_precision", type=str, default="no",
                        choices=["no", "fp16", "bf16"])
    parser.add_argument("--early_stopping", action="store_true")
    parser.add_argument("--patience", type=int, default=10)
    parser.add_argument("--teacher_model", type=str, default=None)
    parser.add_argument("--alpha", type=float, default=0.7)
    parser.add_argument("--temperature", type=float, default=4.0)
    parser.add_argument("--loss", type=str, default="combined",
                        choices=["combined", "ce", "dice", "tversky", "ce_tversky"])
    parser.add_argument("--dropout_rate", type=float, default=0.1)
    parser.add_argument("--n_samples", type=int, default=None)
    parser.add_argument("--n_add_source", type=int, default=None)
    parser.add_argument("--n_target", type=int, default=None)
    parser.add_argument("--source_modality", type=str, default=None)
    parser.add_argument("--target_modality", type=str, default=None)
    parser.add_argument("--lambda_domain", type=float, default=0.1)
    # the JAX package's extras (forwarded to every CLI)
    parser.add_argument("--n_spatial", type=int, default=1)
    parser.add_argument("--no_auto_spatial", action="store_true")
    parser.add_argument("--n_data", type=int, default=None)
    parser.add_argument("--no_remat", action="store_true")
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=2)
    parser.add_argument("--features", type=str, default="16,32,64,128")
    parser.add_argument("--device", type=str, default="cuda",
                        help="'cuda' (default) or 'cpu', which runs the plain PyTorch ops")
    return parser


def _sub_args(module, args) -> argparse.Namespace:
    """A workload CLI's namespace: every flag of its parser, with the
    orchestrator's value where it has the flag, else the CLI's default."""
    ns = argparse.Namespace()
    for action in module.build_parser()._actions:
        if action.dest != "help":
            setattr(ns, action.dest, getattr(args, action.dest, action.default))
    return ns


def _device_banner(name: str) -> None:
    print("\n=== Device Information ===")
    if name.startswith("cuda") and torch.cuda.is_available():
        print(f"Backend: cuda {torch.version.cuda}, torch {torch.__version__}")
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            print(f"Device {i}: {props.name}, {props.total_memory / 2**30:.1f} GiB")
    else:
        print(f"Backend: {name} (CUDA available: {torch.cuda.is_available()}), "
              f"torch {torch.__version__}")
    print(f"PID {os.getpid()}")
    print("==========================\n")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.experiment in ("train", "finetune", "eval", "dann", "distill"):
        _device_banner(args.device)

    if args.experiment == "train":
        from multimodal_segmentation_project_tpu_torch.workloads import train_unet

        train_unet.main(_sub_args(train_unet, args))
    elif args.experiment == "finetune":
        if args.pretrained_model is None:
            raise ValueError("--pretrained_model is required for fine-tuning")
        from multimodal_segmentation_project_tpu_torch.workloads import finetune_ct

        finetune_ct.main(_sub_args(finetune_ct, args))
    elif args.experiment == "eval":
        if args.model_path is None:
            raise ValueError("--model_path is required for evaluation")
        from multimodal_segmentation_project_tpu_torch.workloads import test_model

        test_model.main(_sub_args(test_model, args))
    elif args.experiment == "distill":
        if args.teacher_model is None:
            raise ValueError("--teacher_model is required for distillation")
        from multimodal_segmentation_project_tpu_torch.workloads import distill_unet

        distill_unet.main(_sub_args(distill_unet, args))
    elif args.experiment == "dann":
        from multimodal_segmentation_project_tpu_torch.workloads import train_dann

        train_dann.main(_sub_args(train_dann, args))
    elif args.experiment == "transfer":
        print("Transfer learning not implemented yet.")
    elif args.experiment == "cyclegan":
        print("CycleGAN not implemented yet.")


if __name__ == "__main__":
    main()
