"""The training loop on one device, for all four workloads.

Port of ``multimodal_segmentation_project_tpu/engine/trainer.py``'s
``Trainer`` and ``DannTrainer``. The workloads differ only in their step,
their datasets and a few config fields:

* baseline  = Trainer(train step, augment, plateau scheduler);
* fine-tune = Trainer(train step, strict pretrained load, a freeze of the
  encoder and bottleneck, no augmentation, no scheduler);
* distill   = Trainer(distillation step, a frozen teacher model);
* DANN      = DannTrainer (a discriminator state beside the segmentation
  state, zipped source and target loaders).

The loop semantics are the JAX package's:

* epoch metrics = mean of the per-batch metrics; validation averages per
  volume (batch 1);
* with ``augment``, the five augment transforms on every train step
  (p = 0.3 each);
* with ``use_scheduler``, the plateau scheduler steps on val Dice;
* freeze ``freeze_prefixes`` at the start, or at epoch N and unfreeze at
  N + 1, each with a fresh optimizer;
* a checkpoint every ``checkpoint_every`` epochs and a best-by-val-Dice
  checkpoint, as reference-layout ``.pth`` files (``engine/checkpoint.py``);
* early stopping on val-Dice patience, and true resume (model, optimizer,
  scheduler, train state, epoch; DANN: the discriminator's too);
* the CSV columns, the epoch lines, ``experiments/<name>/{checkpoints,
  logs,plots}`` and ``config.txt``.

Device side: each batch is uploaded from pinned memory with a
non-blocking copy, so the copy overlaps the loader's next decode; the
step's metrics are summed on the device and read once per epoch (the NaN
guard reads one flag per step). ``logs/device_usage.log`` gets the CUDA
allocator's statistics at the start and after every epoch. The plots need
matplotlib; a failed plot warns and does not end the run.

The per-step generator is seeded from (seed, epoch, step), so a resumed
run draws the same augmentation and dropout as an uninterrupted one.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch

from multimodal_segmentation_project_tpu_torch import NUM_CLASSES
from multimodal_segmentation_project_tpu_torch.data import DataLoader
from multimodal_segmentation_project_tpu_torch.engine import checkpoint as ckpt
from multimodal_segmentation_project_tpu_torch.engine.schedule import ReduceLROnPlateau
from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
from multimodal_segmentation_project_tpu_torch.engine.steps import (
    make_dann_step,
    make_distill_step,
    make_eval_step,
    make_train_step,
)
from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator, UNet3D
from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn
from multimodal_segmentation_project_tpu_torch.utils.experiment import (
    ExperimentPaths,
    format_time,
    log_device_usage,
    write_config,
)
from multimodal_segmentation_project_tpu_torch.utils.plotting import plot_training_metrics

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@dataclass
class TrainerConfig:
    experiment_dir: str
    experiment_name: str
    epochs: int = 100
    batch_size: int = 1
    lr: float = 1e-3
    weight_decay: float = 0.01
    grad_accum: int = 1
    loss: str = "ce_tversky"
    dropout_rate: float = 0.1
    seed: int = 42
    augment: bool = False
    use_scheduler: bool = False
    freeze_encoder_epoch: int | None = None
    freeze_at_start: bool = False
    freeze_prefixes: tuple = ("enc",)
    early_stopping: bool = False
    patience: int = 10
    precision: str = "bf16"
    features: tuple = (16, 32, 64, 128)
    checkpoint_every: int = 25  # epochs
    log_name: str = "train_log.csv"
    ckpt_prefix: str = "checkpoint"
    best_prefix: str = "best_model"
    resume: str | None = None
    nan_guard: bool = True
    profile_first_epoch: bool = False
    pretrained_model: str | None = None
    pretrained_strict: bool = True
    num_workers: int = 2
    device: str = "cuda"
    plot_title: str = "Training Metrics"
    extra_config: dict = field(default_factory=dict)


def build_model(cfg: TrainerConfig) -> UNet3D:
    """UNet3D with weights drawn from a generator seeded by ``cfg.seed``."""
    return UNet3D(
        in_channels=1, out_channels=NUM_CLASSES, features=cfg.features,
        dropout_rate=cfg.dropout_rate, dtype=DTYPES[cfg.precision],
        generator=torch.Generator().manual_seed(cfg.seed),
    )


class Trainer:
    """The loop of the baseline, fine-tune and distillation workloads. With
    ``teacher`` (a ``UNet3D`` whose weights are loaded) and ``kd_loss_fn``
    the step is the distillation step."""

    CSV_COLUMNS = [
        "epoch", "time", "train_loss", "val_loss", "train_dice", "val_dice",
        "train_iou", "val_iou", "train_acc", "val_acc", "encoder_frozen",
    ]

    def __init__(self, cfg: TrainerConfig, train_dataset, val_dataset,
                 teacher: UNet3D | None = None, kd_loss_fn=None):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        self.paths = ExperimentPaths.create(cfg.experiment_dir, cfg.experiment_name)
        write_config(os.path.join(self.paths.root, "config.txt"),
                     {**cfg.__dict__, **cfg.extra_config})
        self.device_log = os.path.join(self.paths.logs, "device_usage.log")
        log_device_usage(self.device_log, self.device)

        self.train_loader = DataLoader(train_dataset, batch_size=cfg.batch_size, shuffle=True,
                                       seed=cfg.seed, num_workers=cfg.num_workers)
        self.val_loader = DataLoader(val_dataset, batch_size=1, shuffle=False,
                                     num_workers=cfg.num_workers)

        model = build_model(cfg)
        if cfg.pretrained_model:
            self._load_pretrained(model, cfg.pretrained_model, cfg.pretrained_strict)
        self.state = TrainState(model.to(self.device), cfg.lr, cfg.weight_decay, cfg.grad_accum)
        self.encoder_frozen = False
        if cfg.freeze_at_start:
            self._freeze(cfg.freeze_prefixes)

        self.loss_fn = get_loss_fn(cfg.loss)
        self.teacher = None
        if teacher is not None:
            if kd_loss_fn is None:
                raise ValueError("a teacher needs kd_loss_fn")
            self.teacher = teacher.to(self.device).eval().requires_grad_(False)
            self.train_step = make_distill_step(kd_loss_fn, augment=cfg.augment,
                                                nan_guard=cfg.nan_guard)
        else:
            self.train_step = make_train_step(self.loss_fn, augment=cfg.augment,
                                              nan_guard=cfg.nan_guard)
        self.eval_step = make_eval_step(self.loss_fn)
        self.scheduler = (ReduceLROnPlateau(cfg.lr, mode="max", patience=10, factor=0.1,
                                            min_lr=1e-6) if cfg.use_scheduler else None)
        self.log_file = os.path.join(self.paths.logs, cfg.log_name)
        self.best_val_dice = 0.0
        self.start_epoch = 0
        if cfg.resume:
            self._resume(cfg.resume)
        # a resumed run lands in a fresh experiment dir: its log starts empty too
        if not cfg.resume or not os.path.exists(self.log_file):
            with open(self.log_file, "w") as f:
                f.write(",".join(self.CSV_COLUMNS) + "\n")

    # ---------- helpers ----------

    @staticmethod
    def _load_pretrained(model: UNet3D, path: str, strict: bool) -> None:
        """Initialise from a reference-layout ``.pth``: strictly, or as the
        JAX package's non-strict load (a missing or shape-mismatched key
        keeps the model's value)."""
        if strict:
            ckpt.load_pth(model, path)
            print(f"[PRETRAINED] loaded {path} (strict)")
        else:
            kept = ckpt.load_pth_nonstrict(model, path)
            print(f"[PRETRAINED] loaded {path} (non-strict; {len(kept)} tensors kept their "
                  f"initial values{': ' + ', '.join(kept) if kept else ''})")

    def _freeze(self, prefixes):
        self.state.with_mask(prefixes)
        self.encoder_frozen = bool(prefixes)
        if prefixes:
            frozen = sum(p.numel() for n, p in self.state.model.named_parameters()
                         if not self.state.trainable(n))
            total = sum(p.numel() for p in self.state.model.parameters())
            print(f"[FREEZE] frozen={frozen:,} ({frozen / total * 100:.1f}%) "
                  f"trainable={total - frozen:,} ({(total - frozen) / total * 100:.1f}%)")

    def _upload(self, *arrays):
        """numpy batch -> device tensors, through pinned memory, non-blocking."""
        out = []
        for a in arrays:
            t = torch.from_numpy(a)
            if self.device.type == "cuda":
                t = t.pin_memory()
            out.append(t.to(self.device, non_blocking=True))
        return out

    def _step_generator(self, epoch: int, step: int) -> torch.Generator:
        return torch.Generator().manual_seed(((self.cfg.seed + 1) * 1_000_003 + epoch)
                                             * 1_000_003 + step)

    @staticmethod
    def _accumulate(total, metrics):
        if total is None:
            return dict(metrics)
        return {k: total[k] + metrics[k] for k in total}

    @staticmethod
    def _finalize(total, n):
        """One host read per epoch."""
        if total is None or n == 0:
            return {}
        return {k: float(v) / n for k, v in total.items()}

    def _apply_freeze_schedule(self, epoch: int):
        fe = self.cfg.freeze_encoder_epoch
        if fe is None:
            return
        if epoch == fe and not self.encoder_frozen:
            print(f"[INFO] freezing {self.cfg.freeze_prefixes} at epoch {epoch + 1}")
            self._freeze(self.cfg.freeze_prefixes)
        elif epoch == fe + 1 and self.encoder_frozen:
            print(f"[INFO] unfreezing at epoch {epoch + 1}")
            self._freeze(())

    # ---------- epochs ----------

    def train_epoch(self, epoch: int) -> dict:
        total, n = None, 0
        for step_idx, (images, labels) in enumerate(self.train_loader):
            images, labels = self._upload(images, labels)
            gen = self._step_generator(epoch, step_idx)
            if self.teacher is not None:
                metrics = self.train_step(self.state, self.teacher, images, labels, gen)
            else:
                metrics = self.train_step(self.state, images, labels, gen)
            total = self._accumulate(total, metrics)
            n += 1
        return self._finalize(total, n)

    def eval_epoch(self) -> dict:
        total, n = None, 0
        for images, labels in self.val_loader:
            images, labels = self._upload(images, labels)
            total = self._accumulate(total, self.eval_step(self.state, images, labels))
            n += 1
        return self._finalize(total, n)

    # ---------- checkpoints ----------

    def _ckpt_extra(self, train_metrics, val_metrics) -> dict:
        """Entries a subclass adds to its checkpoints."""
        return {}

    def save_checkpoint(self, path, epoch, train_metrics, val_metrics):
        ckpt.save_train_checkpoint(
            path, self.state, epoch + 1, self.best_val_dice, self.scheduler,
            train_metrics, val_metrics, self.encoder_frozen,
            extra=self._ckpt_extra(train_metrics, val_metrics),
        )

    def _resume(self, path: str) -> dict:
        saved = ckpt.load_train_checkpoint(path)
        self.state.model.load_state_dict(saved["model_state_dict"], strict=True)
        self.state.load_state_dict(saved["train_state"], saved["optimizer_state_dict"])
        self.start_epoch = int(saved["epoch"])
        self.best_val_dice = float(saved["best_val_dice"])
        if self.scheduler is not None and saved.get("scheduler_state_dict"):
            self.scheduler.load_state_dict(saved["scheduler_state_dict"])
        self.encoder_frozen = bool(saved.get("encoder_frozen", False))
        print(f"[RESUME] from {path} at epoch {self.start_epoch}")
        return saved

    # ---------- the loop ----------

    def _profiled_train_epoch(self, epoch: int) -> dict:
        """The epoch under torch.profiler: a Chrome trace and a kernel table
        by device time in logs/profile/."""
        from torch.profiler import ProfilerActivity, profile

        profile_dir = os.path.join(self.paths.logs, "profile")
        os.makedirs(profile_dir, exist_ok=True)
        print(f"[PROFILE] tracing epoch {epoch + 1} -> {profile_dir}")
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            metrics = self.train_epoch(epoch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        sort = "cuda_time_total" if self.device.type == "cuda" else "cpu_time_total"
        with open(os.path.join(profile_dir, "kernels.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=60))
        return metrics

    def run(self) -> dict:
        cfg = self.cfg
        patience_counter = 0
        run_start = time.time()
        summary = {}
        for epoch in range(self.start_epoch, cfg.epochs):
            epoch_start = time.time()
            self._apply_freeze_schedule(epoch)
            if cfg.profile_first_epoch and epoch == self.start_epoch:
                train_metrics = self._profiled_train_epoch(epoch)
            else:
                train_metrics = self.train_epoch(epoch)
            val_metrics = self.eval_epoch()
            if not val_metrics and epoch == self.start_epoch:
                print("[WARN] validation set is empty — scheduler, best-model "
                      "checkpointing and early stopping are disabled")
            if train_metrics.get("nonfinite", 0) > 0:
                print(f"[WARN] {train_metrics['nonfinite'] * 100:.1f}% of steps in epoch "
                      f"{epoch + 1} had non-finite gradients (skipped)")

            if self.scheduler is not None and "dice" in val_metrics:
                self.state.lr = self.scheduler.step(val_metrics["dice"])
                print(f"[LR] learning rate after epoch {epoch + 1}: {self.state.lr}")

            epoch_time = time.time() - epoch_start
            self._log_epoch(epoch, epoch_time, train_metrics, val_metrics)
            log_device_usage(self.device_log, self.device, tag=f"epoch={epoch + 1}")

            if (epoch + 1) % cfg.checkpoint_every == 0:
                name = f"{cfg.ckpt_prefix}_epoch{epoch + 1}_{cfg.experiment_name}.pth"
                self.save_checkpoint(os.path.join(self.paths.checkpoints, name), epoch,
                                     train_metrics, val_metrics)

            if val_metrics.get("dice", -1.0) > self.best_val_dice:
                self.best_val_dice = val_metrics["dice"]
                patience_counter = 0
                name = f"{cfg.best_prefix}_{cfg.experiment_name}.pth"
                self.save_checkpoint(os.path.join(self.paths.checkpoints, name), epoch,
                                     train_metrics, val_metrics)
            elif cfg.early_stopping:
                patience_counter += 1
                if patience_counter >= cfg.patience:
                    print(f"[EARLY STOPPING] no val-dice improvement for {cfg.patience} "
                          f"epochs; stopping at epoch {epoch + 1}")
                    break
            summary = {"train": train_metrics, "val": val_metrics, "epoch": epoch + 1}

        try:
            plot_training_metrics(self.log_file, self.paths.plots, title=cfg.plot_title)
        except Exception as e:  # plotting must never kill a finished run
            print(f"[WARN] plotting failed: {e}")
        print(f"[END] training completed in {format_time(time.time() - run_start)}; "
              f"best val dice {self.best_val_dice:.4f}")
        summary["best_val_dice"] = self.best_val_dice
        return summary

    def _log_epoch(self, epoch, epoch_time, tm, vm):
        if not vm:  # empty validation loader: NaN columns, keep the schema
            vm = {k: float("nan") for k in ("loss", "dice", "iou", "acc")}
        print(
            f"[EPOCH] {epoch + 1}/{self.cfg.epochs} - {format_time(epoch_time)} | "
            f"Train Loss: {tm['loss']:.4f} | Val Loss: {vm['loss']:.4f} | "
            f"Train Dice: {tm['dice']:.4f} | Val Dice: {vm['dice']:.4f} | "
            f"Train IoU: {tm['iou']:.4f} | Val IoU: {vm['iou']:.4f} | "
            f"Train Acc: {tm['acc']:.4f} | Val Acc: {vm['acc']:.4f} | "
            f"Frozen: {self.encoder_frozen}"
        )
        row = [epoch + 1, epoch_time, tm["loss"], vm["loss"], tm["dice"], vm["dice"],
               tm["iou"], vm["iou"], tm["acc"], vm["acc"], self.encoder_frozen]
        with open(self.log_file, "a") as f:
            f.write(",".join(str(v) for v in row) + "\n")


class DannTrainer(Trainer):
    """DANN: zipped source and target loaders, a segmentation state and a
    discriminator state. An epoch is as long as the shorter loader; the
    metrics are the source batches'; validation runs on the target
    modality's val split. The target loader shuffles with seed + 1000."""

    CSV_COLUMNS = [
        "epoch", "time", "train_loss", "task_loss", "domain_loss", "val_loss",
        "train_dice", "val_dice", "train_iou", "val_iou", "train_acc", "val_acc",
        "encoder_frozen",
    ]

    def __init__(self, cfg: TrainerConfig, source_dataset, target_dataset, val_dataset,
                 lambda_domain: float = 0.1):
        self.lambda_domain = lambda_domain
        # built before Trainer.__init__, which may resume into it
        disc = DomainDiscriminator(2 * cfg.features[-1],
                                   generator=torch.Generator().manual_seed(cfg.seed + 7))
        self.disc_state = TrainState(disc.to(torch.device(cfg.device)), cfg.lr,
                                     cfg.weight_decay, cfg.grad_accum)
        super().__init__(cfg, source_dataset, val_dataset)
        self.target_loader = DataLoader(target_dataset, batch_size=cfg.batch_size, shuffle=True,
                                        seed=cfg.seed + 1000, num_workers=cfg.num_workers)
        self.dann_step = make_dann_step(self.loss_fn, lambda_domain, nan_guard=cfg.nan_guard)

    def train_epoch(self, epoch: int) -> dict:
        total, n = None, 0
        for step_idx, ((src_img, src_lbl), (tgt_img, _)) in enumerate(
                zip(self.train_loader, self.target_loader)):
            src_img, src_lbl = self._upload(src_img, src_lbl)
            (tgt_img,) = self._upload(tgt_img)
            metrics = self.dann_step(self.state, self.disc_state, src_img, src_lbl, tgt_img,
                                     self._step_generator(epoch, step_idx))
            total = self._accumulate(total, metrics)
            n += 1
        return self._finalize(total, n)

    def _ckpt_extra(self, train_metrics, val_metrics) -> dict:
        """The discriminator beside the reference-layout ``model_state_dict``
        (which the eval CLI loads unchanged)."""
        return {
            "discriminator_state_dict": self.disc_state.model.state_dict(),
            "discriminator_optimizer_state_dict": self.disc_state.optimizer.state_dict(),
            "discriminator_train_state": self.disc_state.state_dict(),
            "task_loss": train_metrics.get("task_loss"),
            "domain_loss": train_metrics.get("domain_loss"),
            "lambda_domain": self.lambda_domain,
        }

    def _resume(self, path: str) -> dict:
        saved = super()._resume(path)
        self.disc_state.model.load_state_dict(saved["discriminator_state_dict"], strict=True)
        self.disc_state.load_state_dict(saved["discriminator_train_state"],
                                        saved["discriminator_optimizer_state_dict"])
        return saved

    def _log_epoch(self, epoch, epoch_time, tm, vm):
        if not vm:
            vm = {k: float("nan") for k in ("loss", "dice", "iou", "acc")}
        train_total = tm["task_loss"] + self.lambda_domain * tm["domain_loss"]
        print(
            f"[EPOCH] {epoch + 1}/{self.cfg.epochs} - {format_time(epoch_time)} | "
            f"Train Loss: {train_total:.4f} | Task: {tm['task_loss']:.4f} | "
            f"Domain: {tm['domain_loss']:.4f} | Val Loss: {vm['loss']:.4f} | "
            f"Train Dice: {tm['dice']:.4f} | Val Dice: {vm['dice']:.4f}"
        )
        row = [epoch + 1, epoch_time, train_total, tm["task_loss"], tm["domain_loss"],
               vm["loss"], tm["dice"], vm["dice"], tm["iou"], vm["iou"], tm["acc"], vm["acc"],
               self.encoder_frozen]
        with open(self.log_file, "a") as f:
            f.write(",".join(str(v) for v in row) + "\n")
