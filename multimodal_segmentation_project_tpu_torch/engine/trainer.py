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
  checkpoint under the JAX package's names and layout,
  ``{ckpt_prefix}_epoch{N}_{name}.msgpack`` and
  ``{best_prefix}_{name}.msgpack``, each with its JSON sidecar
  (``engine/checkpoint.py``), so that the JAX package resumes and serves
  them; :meth:`Trainer.save_checkpoint` writes a reference-layout ``.pth``
  instead for a path with that suffix;
* early stopping on val-Dice patience, and true resume (model, optimizer,
  scheduler, train state, epoch; DANN: the discriminator's too) from the
  port's ``.pth`` or from a JAX ``.msgpack`` train checkpoint and its JSON
  sidecar (the scheduler and the freeze flag); a pretrained model or a
  teacher loads from either format;
* the CSV columns, the epoch lines, ``experiments/<name>/{checkpoints,
  logs,plots}`` and ``config.txt``.

Device side: each batch is uploaded from pinned memory with a
non-blocking copy, so the copy overlaps the loader's next decode; the
step's metrics are summed on the device and read once per epoch (the NaN
guard reads one flag per step). ``logs/device_usage.log`` gets the CUDA
allocator's statistics at the start and after every epoch. The plots need
matplotlib; a failed plot warns and does not end the run.

Under ``torch.profiler`` (the CLIs' ``--profile`` traces the first epoch to
``logs/profile/trace.json``) a train epoch's host time lies in flat named
spans (``utils/spans.py``): ``data.wait`` and ``data.upload`` in
``data/pipeline.py``, ``step.augment``, ``step.forward``, ``step.backward``,
``step.update``, ``step.sync`` and, where the step replays as a CUDA graph,
``step.replay`` in the step (``engine/steps.py``). Each
carries its step's id, ``"<epoch>:<step>"``, in the Chrome trace's
``args``; with no profiler on they cost a flag read each. A step does not
capture a CUDA graph while a profiler records, so the ``--profile`` epoch's
steps run eagerly, and the steps replay from the next epoch on.

Several GPUs (one process per GPU, ``torch.distributed`` initialised by the
CLI, ``workloads/common.py``): the trainer picks the mesh as the JAX
trainer does (:func:`parallel.mesh.choose_mesh`: the largest data axis
that divides the global batch, then the spatial axis raised to fill the
idle ranks, the ``[MESH]`` line; a warning where ranks stay idle) and
activates it. Every rank loads the same global batches (the same shuffle),
takes its slice on upload (a step with augmentation augments the whole
batch on every rank first: ``engine/steps.py``), with ``drop_last`` when the
data axis has more than one rank, and validates ``n_data`` distinct
volumes a step (``make_sharded_eval_step``: a ragged last batch is padded
by its first volume with weight 0). Every rank reads ``--resume`` and
``--pretrained_model``, and the trainer checks once that every rank starts
from the same parameters. Only rank 0 writes: ``config.txt``, the logs,
the CSV, the plots and the checkpoints; the others print nothing but
errors.

The per-step generator is seeded from (seed, epoch, step), and each
epoch's shuffle from (seed, epoch), so a resumed run draws the same batches,
augmentation and dropout as an uninterrupted one.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from multimodal_segmentation_project_tpu_torch import NUM_CLASSES
from multimodal_segmentation_project_tpu_torch.data import DataLoader
from multimodal_segmentation_project_tpu_torch.data.pipeline import upload
from multimodal_segmentation_project_tpu_torch.engine import checkpoint as ckpt
from multimodal_segmentation_project_tpu_torch.engine.interop import (
    state_dict_to_discriminator_params,
)
from multimodal_segmentation_project_tpu_torch.engine.schedule import ReduceLROnPlateau
from multimodal_segmentation_project_tpu_torch.engine.state import create_train_state
from multimodal_segmentation_project_tpu_torch.engine.steps import (
    make_dann_step,
    make_distill_step,
    make_sharded_eval_step,
    make_train_step,
)
from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator, UNet3D
from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn
from multimodal_segmentation_project_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    broadcast_,
    choose_mesh,
    rank,
    set_active_mesh,
    world_size,
)
from multimodal_segmentation_project_tpu_torch.utils.experiment import (
    ExperimentPaths,
    format_time,
    log_device_usage,
    write_config,
)
from multimodal_segmentation_project_tpu_torch.utils.plotting import plot_training_metrics
from multimodal_segmentation_project_tpu_torch.utils.spans import numbered

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
    n_spatial: int = 1
    # when the global batch cannot fill the ranks, raise n_spatial (the
    # volume's D split over ranks) to use the idle ones
    auto_spatial: bool = True
    n_data: int | None = None  # the data axis (None: the largest that divides the batch)
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
        # every write is rank 0's: the other ranks hold the same state
        self.is_main = rank() == 0
        self.paths = ExperimentPaths.create(cfg.experiment_dir, cfg.experiment_name,
                                            make_dirs=self.is_main)
        self.device_log = os.path.join(self.paths.logs, "device_usage.log")
        if self.is_main:
            write_config(os.path.join(self.paths.root, "config.txt"),
                         {**cfg.__dict__, **cfg.extra_config})
            log_device_usage(self.device_log, self.device)

        self.mesh = self._make_mesh(train_dataset)
        set_active_mesh(self.mesh)
        data_par = self.mesh.n_data
        self.train_loader = DataLoader(train_dataset, batch_size=cfg.batch_size, shuffle=True,
                                       seed=cfg.seed, num_workers=cfg.num_workers,
                                       drop_last=data_par > 1)
        # validation: n_data distinct volumes a step, one per data rank
        self.val_loader = DataLoader(val_dataset, batch_size=data_par, shuffle=False,
                                     num_workers=cfg.num_workers)

        model = build_model(cfg)
        if cfg.pretrained_model:
            self._load_pretrained(model, cfg.pretrained_model, cfg.pretrained_strict)
        self.state = create_train_state(model.to(self.device), cfg.lr, cfg.weight_decay,
                                        cfg.grad_accum)
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
        self.eval_step = make_sharded_eval_step(self.loss_fn)
        self.scheduler = (ReduceLROnPlateau(cfg.lr, mode="max", patience=10, factor=0.1,
                                            min_lr=1e-6) if cfg.use_scheduler else None)
        self.log_file = os.path.join(self.paths.logs, cfg.log_name)
        self.best_val_dice = 0.0
        self.start_epoch = 0
        if cfg.resume:
            self._resume(cfg.resume)
        self._check_replicas()
        # a resumed run lands in a fresh experiment dir: its log starts empty too
        if self.is_main and (not cfg.resume or not os.path.exists(self.log_file)):
            with open(self.log_file, "w") as f:
                f.write(",".join(self.CSV_COLUMNS) + "\n")

    # ---------- the mesh ----------

    def _make_mesh(self, train_dataset) -> Mesh:
        """The JAX trainer's mesh over this world's ranks (a 1x1 mesh, the
        single-device path, in a world of one)."""
        cfg, world = self.cfg, world_size()
        depth = train_dataset[0][0].shape[1] if world > 1 else 1
        choice = choose_mesh(world, cfg.batch_size, cfg.n_spatial, cfg.n_data, cfg.auto_spatial,
                             depth, len(cfg.features))
        if choice.auto_spatial:
            self._print(f"[MESH] global batch {cfg.batch_size} fills only {choice.n_data}/{world} "
                        f"ranks with data parallelism — auto-raising spatial sharding to "
                        f"n_spatial={choice.n_spatial} ({choice.n_data}x{choice.n_spatial} mesh, "
                        f"volume D split across ranks)")
        used = choice.n_data * choice.n_spatial
        if world > 1:
            self._print(f"[MESH] {choice.n_data}x{choice.n_spatial} mesh (data x spatial) over "
                        f"{used} of {world} ranks")
        if used < world:
            self._print("=" * 72 + f"\n[WARN] the {used}-rank mesh uses only {used} of {world} "
                        f"ranks — {world - used} sit IDLE every step. batch_size here is the "
                        f"GLOBAL batch (the reference's --batch_size is per-device); raise "
                        f"batch_size, or n_spatial, so n_data * n_spatial = {world}.\n" + "=" * 72)
        return Mesh(choice.n_data, choice.n_spatial)

    def _replicas(self) -> list:
        """The modules every rank must hold alike."""
        return [self.state.model]

    def _check_replicas(self) -> None:
        """Once, on a mesh: every rank starts from rank 0's parameters and
        BatchNorm statistics, bit for bit."""
        group = self.mesh.group
        if group is None or not self.mesh.member:
            return
        mine = torch.cat([t.detach().reshape(-1).double() for m in self._replicas()
                          for t in m.state_dict().values()])
        ref = broadcast_(mine.clone(), 0, group)
        differ = all_reduce_(torch.tensor([float(not torch.equal(mine, ref))],
                                          device=mine.device), group)
        if differ.item():
            raise RuntimeError(f"{int(differ.item())} rank(s) start from other parameters than "
                               f"rank 0: every rank must build and load the same model")

    # ---------- helpers ----------

    def _print(self, *args) -> None:
        if self.is_main:
            print(*args, flush=True)

    def _load_pretrained(self, model: UNet3D, path: str, strict: bool) -> None:
        """Initialise from a reference-layout ``.pth`` or a JAX ``.msgpack``:
        strictly, or as the JAX package's non-strict load (a missing or
        shape-mismatched key keeps the model's value)."""
        kept = ckpt.load_params_any(model, path, strict=strict)
        if strict:
            self._print(f"[PRETRAINED] loaded {path} (strict)")
        else:
            self._print(f"[PRETRAINED] loaded {path} (non-strict; {len(kept)} tensors kept their "
                        f"initial values{': ' + ', '.join(kept) if kept else ''})")

    def _freeze(self, prefixes):
        self.state.with_mask(prefixes)
        self.encoder_frozen = bool(prefixes)
        if prefixes:
            frozen = sum(p.numel() for n, p in self.state.model.named_parameters()
                         if not self.state.trainable(n))
            total = sum(p.numel() for p in self.state.model.parameters())
            self._print(f"[FREEZE] frozen={frozen:,} ({frozen / total * 100:.1f}%) "
                        f"trainable={total - frozen:,} ({(total - frozen) / total * 100:.1f}%)")

    def _upload(self, *arrays, whole: bool = False):
        """numpy batch -> device tensors, through pinned memory, non-blocking:
        this rank's slice on a mesh, unless ``whole`` (a step that augments
        takes the global batch)."""
        return upload(arrays, self.device, None if whole or self.mesh.size == 1 else self.mesh)

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
            self._print(f"[INFO] freezing {self.cfg.freeze_prefixes} at epoch {epoch + 1}")
            self._freeze(self.cfg.freeze_prefixes)
        elif epoch == fe + 1 and self.encoder_frozen:
            self._print(f"[INFO] unfreezing at epoch {epoch + 1}")
            self._freeze(())

    # ---------- epochs ----------

    def train_epoch(self, epoch: int) -> dict:
        total, n = None, 0
        self.train_loader.set_epoch(epoch)
        for step_idx, (images, labels) in numbered(epoch, self.train_loader):
            images, labels = self._upload(images, labels, whole=self.cfg.augment)
            gen = self._step_generator(epoch, step_idx)
            if self.teacher is not None:
                metrics = self.train_step(self.state, self.teacher, images, labels, gen)
            else:
                metrics = self.train_step(self.state, images, labels, gen)
            total = self._accumulate(total, metrics)
            n += 1
        return self._finalize(total, n)

    def eval_epoch(self) -> dict:
        """Validation over distinct volumes, ``n_data`` a step: the mean of
        the per-volume metrics. A ragged last batch is padded by repeating
        its first volume, with weight 0."""
        data_par = self.mesh.n_data
        total = None
        for images, labels in self.val_loader:
            b = images.shape[0]
            weights = np.ones((b,), np.float32)
            if b < data_par:
                pad = data_par - b
                images = np.concatenate([images, np.repeat(images[:1], pad, 0)], 0)
                labels = np.concatenate([labels, np.repeat(labels[:1], pad, 0)], 0)
                weights = np.concatenate([weights, np.zeros((pad,), np.float32)])
            images, labels, weights = self._upload(images, labels, weights)
            total = self._accumulate(total, self.eval_step(self.state, images, labels, weights))
        if total is None:
            return {}
        n = max(float(total.pop("n")), 1.0)
        return {k: float(v) / n for k, v in total.items()}

    # ---------- checkpoints ----------

    def _ckpt_extra(self, train_metrics, val_metrics) -> dict:
        """Entries a subclass adds to its checkpoints."""
        return {}

    def _jax_extra(self) -> dict:
        """Entries a subclass adds to the JAX layout's tree."""
        return {}

    def _metadata(self, epoch, train_metrics, val_metrics) -> dict:
        """The JAX layout's JSON sidecar (``engine/trainer.py:_metadata``)."""
        return {
            "epoch": epoch + 1,
            "train_loss": train_metrics.get("loss"),
            "val_loss": val_metrics.get("loss"),
            "train_dice": train_metrics.get("dice"),
            "val_dice": val_metrics.get("dice"),
            "encoder_frozen": self.encoder_frozen,
            "scheduler": self.scheduler.state_dict() if self.scheduler else None,
        }

    def save_checkpoint(self, path, epoch, train_metrics, val_metrics):
        """After epoch ``epoch`` (0-based): a ``.msgpack`` path gets the JAX
        package's train checkpoint and sidecar, any other a ``.pth``. Rank 0
        writes; the other ranks hold the same state."""
        if not self.is_main:
            return
        if str(path).endswith(".msgpack"):
            extra = {"epoch": np.asarray(epoch + 1, np.int32),
                     "best_val_dice": np.asarray(self.best_val_dice, np.float32),
                     **self._jax_extra()}
            ckpt.save_checkpoint(path, ckpt.state_checkpoint_tree(self.state, extra),
                                 metadata=self._metadata(epoch, train_metrics, val_metrics))
            return
        ckpt.save_train_checkpoint(
            path, self.state, epoch + 1, self.best_val_dice, self.scheduler,
            train_metrics, val_metrics, self.encoder_frozen,
            extra=self._ckpt_extra(train_metrics, val_metrics),
        )

    def _resume(self, path: str) -> dict:
        if str(path).endswith(".msgpack"):
            return self._resume_msgpack(path)
        saved = ckpt.load_train_checkpoint(path)
        self.state.model.load_state_dict(saved["model_state_dict"], strict=True)
        self.state.load_state_dict(saved["train_state"], saved["optimizer_state_dict"])
        self.start_epoch = int(saved["epoch"])
        self.best_val_dice = float(saved["best_val_dice"])
        if self.scheduler is not None and saved.get("scheduler_state_dict"):
            self.scheduler.load_state_dict(saved["scheduler_state_dict"])
        self.encoder_frozen = bool(saved.get("encoder_frozen", False))
        self._print(f"[RESUME] from {path} at epoch {self.start_epoch}")
        return saved

    def _resume_msgpack(self, path: str) -> dict:
        """Resume from the JAX package's train checkpoint
        (``engine/trainer.py:_resume``): the model, batch statistics,
        optimizer, accumulator, step, LR and freeze mask, the epoch and the
        best val Dice; the scheduler and the freeze flag from the sidecar."""
        tree = ckpt.load_checkpoint(path)
        missing = [k for k in ("epoch", "best_val_dice") if k not in tree]
        if missing:
            raise KeyError(f"{path} is not a train checkpoint of the JAX package: it lacks "
                           f"{missing}")
        ckpt.restore_train_state(self.state, tree)
        self.start_epoch = int(tree["epoch"])
        self.best_val_dice = float(tree["best_val_dice"])
        meta = ckpt.load_metadata(path)
        if self.scheduler is not None and meta.get("scheduler"):
            self.scheduler.load_state_dict(meta["scheduler"])
        self.encoder_frozen = bool(meta.get("encoder_frozen", False))
        # The file holds the LR as float32. The run's LR is the scheduler's
        # or the configured one (Python floats); where one of them rounds to
        # the stored value, it is the LR the run stepped with.
        lr = np.float32(tree["lr"])
        candidates = [self.scheduler.lr] if self.scheduler is not None else []
        self.state.lr = next((c for c in (*candidates, self.cfg.lr) if np.float32(c) == lr),
                             float(lr))
        self._print(f"[RESUME] from {path} at epoch {self.start_epoch}")
        return tree

    # ---------- the loop ----------

    def _profiled_train_epoch(self, epoch: int) -> dict:
        """The epoch under torch.profiler: a Chrome trace and a kernel table
        by device time in logs/profile/ (rank 0's). The profiler records
        inputs, so that each span of the trace carries its step's id."""
        from torch.profiler import ProfilerActivity, profile

        if not self.is_main:
            return self.train_epoch(epoch)
        profile_dir = os.path.join(self.paths.logs, "profile")
        os.makedirs(profile_dir, exist_ok=True)
        self._print(f"[PROFILE] tracing epoch {epoch + 1} -> {profile_dir}")
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities, record_shapes=True) as prof:
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
        if not self.mesh.member:
            print(f"[MESH] rank {self.mesh.rank} is outside the {self.mesh.n_data}x"
                  f"{self.mesh.n_spatial} mesh: idle", flush=True)
            return {}
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
                self._print("[WARN] validation set is empty — scheduler, best-model "
                            "checkpointing and early stopping are disabled")
            if train_metrics.get("nonfinite", 0) > 0:
                self._print(f"[WARN] {train_metrics['nonfinite'] * 100:.1f}% of steps in epoch "
                            f"{epoch + 1} had non-finite gradients (skipped)")

            if self.scheduler is not None and "dice" in val_metrics:
                self.state.lr = self.scheduler.step(val_metrics["dice"])
                self._print(f"[LR] learning rate after epoch {epoch + 1}: {self.state.lr}")

            epoch_time = time.time() - epoch_start
            self._log_epoch(epoch, epoch_time, train_metrics, val_metrics)
            if self.is_main:
                log_device_usage(self.device_log, self.device, tag=f"epoch={epoch + 1}")

            if (epoch + 1) % cfg.checkpoint_every == 0:
                name = f"{cfg.ckpt_prefix}_epoch{epoch + 1}_{cfg.experiment_name}.msgpack"
                self.save_checkpoint(os.path.join(self.paths.checkpoints, name), epoch,
                                     train_metrics, val_metrics)

            if val_metrics.get("dice", -1.0) > self.best_val_dice:
                self.best_val_dice = val_metrics["dice"]
                patience_counter = 0
                name = f"{cfg.best_prefix}_{cfg.experiment_name}.msgpack"
                self.save_checkpoint(os.path.join(self.paths.checkpoints, name), epoch,
                                     train_metrics, val_metrics)
            elif cfg.early_stopping:
                patience_counter += 1
                if patience_counter >= cfg.patience:
                    self._print(f"[EARLY STOPPING] no val-dice improvement for {cfg.patience} "
                                f"epochs; stopping at epoch {epoch + 1}")
                    break
            summary = {"train": train_metrics, "val": val_metrics, "epoch": epoch + 1}

        if self.is_main:
            try:
                plot_training_metrics(self.log_file, self.paths.plots, title=cfg.plot_title)
            except Exception as e:  # plotting must never kill a finished run
                print(f"[WARN] plotting failed: {e}")
        self._print(f"[END] training completed in {format_time(time.time() - run_start)}; "
                    f"best val dice {self.best_val_dice:.4f}")
        summary["best_val_dice"] = self.best_val_dice
        return summary

    def _log_epoch(self, epoch, epoch_time, tm, vm):
        if not vm:  # empty validation loader: NaN columns, keep the schema
            vm = {k: float("nan") for k in ("loss", "dice", "iou", "acc")}
        self._print(
            f"[EPOCH] {epoch + 1}/{self.cfg.epochs} - {format_time(epoch_time)} | "
            f"Train Loss: {tm['loss']:.4f} | Val Loss: {vm['loss']:.4f} | "
            f"Train Dice: {tm['dice']:.4f} | Val Dice: {vm['dice']:.4f} | "
            f"Train IoU: {tm['iou']:.4f} | Val IoU: {vm['iou']:.4f} | "
            f"Train Acc: {tm['acc']:.4f} | Val Acc: {vm['acc']:.4f} | "
            f"Frozen: {self.encoder_frozen}"
        )
        self._append_csv([epoch + 1, epoch_time, tm["loss"], vm["loss"], tm["dice"], vm["dice"],
                          tm["iou"], vm["iou"], tm["acc"], vm["acc"], self.encoder_frozen])

    def _append_csv(self, row) -> None:
        if self.is_main:
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
        self.disc_state = create_train_state(disc.to(torch.device(cfg.device)), cfg.lr,
                                             cfg.weight_decay, cfg.grad_accum)
        super().__init__(cfg, source_dataset, val_dataset)
        self.target_loader = DataLoader(target_dataset, batch_size=cfg.batch_size, shuffle=True,
                                        seed=cfg.seed + 1000, num_workers=cfg.num_workers,
                                        drop_last=self.mesh.n_data > 1)
        self.dann_step = make_dann_step(self.loss_fn, lambda_domain, nan_guard=cfg.nan_guard)

    def train_epoch(self, epoch: int) -> dict:
        total, n = None, 0
        self.train_loader.set_epoch(epoch)
        self.target_loader.set_epoch(epoch)
        for step_idx, ((src_img, src_lbl), (tgt_img, _)) in numbered(
                epoch, zip(self.train_loader, self.target_loader)):
            src_img, src_lbl = self._upload(src_img, src_lbl)
            (tgt_img,) = self._upload(tgt_img)
            metrics = self.dann_step(self.state, self.disc_state, src_img, src_lbl, tgt_img,
                                     self._step_generator(epoch, step_idx))
            total = self._accumulate(total, metrics)
            n += 1
        return self._finalize(total, n)

    def _replicas(self) -> list:
        return [self.state.model, self.disc_state.model]

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

    def _jax_extra(self) -> dict:
        """The discriminator's params and optimizer, as the JAX DannTrainer
        writes them (its step, LR and mask are not written)."""
        return {"disc_params": state_dict_to_discriminator_params(
                    self.disc_state.model.state_dict()),
                "disc_opt_state": self.disc_state.optax_state()}

    def _metadata(self, epoch, train_metrics, val_metrics) -> dict:
        return {**super()._metadata(epoch, train_metrics, val_metrics),
                "task_loss": train_metrics.get("task_loss"),
                "domain_loss": train_metrics.get("domain_loss"),
                "lambda_domain": self.lambda_domain}

    def _resume(self, path: str) -> dict:
        saved = super()._resume(path)
        if str(path).endswith(".msgpack"):
            for key in ("disc_params", "disc_opt_state"):
                if key not in saved:
                    raise KeyError(f"{path} is not a DANN checkpoint: it lacks '{key}'")
            ckpt.load_tree_into(self.disc_state.model, saved["disc_params"], None, strict=True)
            self.disc_state.load_optax_state(saved["disc_opt_state"])
            # the two states step together; the JAX checkpoint keeps only one step
            self.disc_state.step = self.state.step
            return saved
        self.disc_state.model.load_state_dict(saved["discriminator_state_dict"], strict=True)
        self.disc_state.load_state_dict(saved["discriminator_train_state"],
                                        saved["discriminator_optimizer_state_dict"])
        return saved

    def _log_epoch(self, epoch, epoch_time, tm, vm):
        if not vm:
            vm = {k: float("nan") for k in ("loss", "dice", "iou", "acc")}
        train_total = tm["task_loss"] + self.lambda_domain * tm["domain_loss"]
        self._print(
            f"[EPOCH] {epoch + 1}/{self.cfg.epochs} - {format_time(epoch_time)} | "
            f"Train Loss: {train_total:.4f} | Task: {tm['task_loss']:.4f} | "
            f"Domain: {tm['domain_loss']:.4f} | Val Loss: {vm['loss']:.4f} | "
            f"Train Dice: {tm['dice']:.4f} | Val Dice: {vm['dice']:.4f}"
        )
        self._append_csv([epoch + 1, epoch_time, train_total, tm["task_loss"], tm["domain_loss"],
                          vm["loss"], tm["dice"], vm["dice"], tm["iou"], vm["iou"], tm["acc"],
                          vm["acc"], self.encoder_frozen])
