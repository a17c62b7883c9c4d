"""What the traffic loops share: the inputs, the capture of the program's first
steps, the measured window and the device's description.
"""

from __future__ import annotations

import gc
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gpubench import common, flops, trace
from gpubench.volumes import make_volume

say = common.say
PEAKS = common.load_json(Path(__file__).resolve().parent / "peaks.json")


def trainer_config(config: dict, device: str, exp_dir: str):
    """The train CLI's ``TrainerConfig`` for the configuration. Its ``seed``
    is the recipe's (``--seed 42`` in every recipe), so every run draws the
    same data order, augmentation and dropout: the same work, whatever the
    inputs and weights that ``--seed`` makes."""
    from multimodal_segmentation_project_tpu_torch.engine.trainer import TrainerConfig

    return TrainerConfig(
        experiment_dir=exp_dir, experiment_name="gpubench", epochs=1 << 30,
        batch_size=config["batch_size"], lr=config["lr"], weight_decay=config["weight_decay"],
        grad_accum=config["grad_accum"], loss=config["loss"], dropout_rate=config["dropout_rate"],
        seed=config["seed"], augment=config["augment"],
        use_scheduler=config["use_scheduler"], early_stopping=True, patience=10,
        precision=config["precision"], features=tuple(config["features"]),
        num_workers=config["num_workers"], device=device)


def recipe(config: dict) -> dict:
    return {k: config[k] for k in ("features", "dropout_rate", "lr", "weight_decay",
                                   "grad_accum", "augment")}


def host_volumes(n: int, modalities, size: int, seed: int, device) -> list:
    """``n`` (image (1, S, S, S) fp32, labels (S, S, S) int32) numpy pairs,
    made on ``device`` from ``seed``, the modalities in turn."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for i in range(n):
        image, labels = make_volume(gen, size, modalities[i % len(modalities)], device)
        out.append((image.cpu().numpy(), labels.cpu().numpy()))
    return out


def stack(volumes: list, device):
    """Host pairs -> device tensors (n, 1, S, S, S) and (n, S, S, S)."""
    images = torch.from_numpy(np.stack([v[0] for v in volumes])).to(device)
    labels = torch.from_numpy(np.stack([v[1] for v in volumes])).to(device)
    return images, labels


def experiment_dir() -> str:
    """A fresh directory under TMPDIR for the trainer's experiment files."""
    return tempfile.mkdtemp(prefix="gpubench_exp_", dir=tempfile.gettempdir())


def _leaf_norms(tensors: dict, prefix: str) -> dict:
    return {prefix + k: float(t.detach().double().norm()) for k, t in tensors.items()}


class Capture:
    """Records what the reference compares from the program's first steps:
    each step's loss and logits, the first gradient as each state's optimizer holds it
    after one step (the accumulator's mean, or AdamW's first moment over
    1 - beta1 without accumulation), and each leaf's change after the first
    update. ``states`` maps a leaf prefix to a ``TrainState``; ``initial``
    holds the weights the run started from, by the same prefixes."""

    def __init__(self, states: dict, initial: dict, accum: int):
        self.states, self.initial, self.accum = states, initial, accum
        self.losses, self.first_grad, self.update, self.logits = [], None, None, []
        self._hook = states["seg"].model.register_forward_hook(self._keep_logits)

    def _keep_logits(self, module, args, output):
        """The step's first forward's logits (a DANN step's source forward),
        on the host, for the reference to judge."""
        if len(self.logits) == len(self.losses) < self.accum:
            logits = output[0] if isinstance(output, tuple) else output
            self.logits.append(logits.detach().float().cpu())

    def wrap(self, step_fn):
        def step(*args, **kw):
            metrics = step_fn(*args, **kw)
            self.after_step(metrics)
            return metrics
        return step

    def after_step(self, metrics: dict) -> None:
        self.losses.append(metrics["loss"].detach().clone())
        n = len(self.losses)
        if n == 1:
            self.first_grad = {}
            for tag, st in self.states.items():
                if st.grad_accum_steps > 1:
                    grads = st.acc_grads
                else:
                    b1 = st.betas[0]
                    grads = {name: st.optimizer.state[p]["exp_avg"] / (1 - b1)
                             for name, p in st.model.named_parameters() if p in st.optimizer.state}
                self.first_grad.update(_leaf_norms(grads, tag + "."))
        if n == self.accum:
            self._hook.remove()
            self.update = {}
            for tag, st in self.states.items():
                delta = {k: p.detach() - self.initial[tag][k].to(p.device)
                         for k, p in st.model.named_parameters()}
                self.update.update(_leaf_norms(delta, tag + "."))

    def record(self) -> dict:
        return {"losses": [float(x) for x in self.losses[:self.accum]],
                "first_grad": self.first_grad or {}, "update": self.update or {},
                "logits": self.logits}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(do_unit, seconds: float, device, trace_units: int = 0) -> dict:
    """Run ``do_unit()`` -> (attempted, failed) until ``seconds`` have passed.
    With ``trace_units`` the first that many units run first, under the
    profiler, and the rest of the window untraced. Every untraced unit's
    seconds go to standard error, in order, so that a slow stretch inside
    a run shows."""
    out = {"attempted": 0, "failed": 0, "summary": None, "spans": None, "traced_units": 0}
    times = []

    def timed():
        t = time.perf_counter()
        a, f = do_unit()
        times.append(time.perf_counter() - t)
        out["attempted"] += a
        out["failed"] += f

    start = time.perf_counter()
    if trace_units:
        _, out["summary"], out["spans"] = trace.traced(
            lambda: [timed() for _ in range(trace_units)], lambda: sync(device),
            torch.device(device).type)
        out["traced_units"] = out["attempted"]
    times.clear()
    while time.perf_counter() - start < seconds:
        timed()
    sync(device)
    out["start"] = start
    out["window_s"] = time.perf_counter() - start
    if times:
        q = sorted(times)
        say(f"gpubench: {len(times)} untraced units, seconds min {q[0]:.4f} median "
            f"{q[len(q) // 2]:.4f} max {q[-1]:.4f}; in order {[round(x, 3) for x in times]}")
    return out


def drive_trainer(trainer, step_attr: str, capture: "Capture", seconds: float, device, t0: float,
                  trace_units: int = 0) -> dict:
    """Set-up's epoch 0 through the trainer's own ``train_epoch`` with
    ``capture`` round its step (``trainer.<step_attr>``), then the window of
    epochs 1, 2, ... Returns the program's record, ``setup_s``, the set-up's
    and the window's allocator peaks and the window."""
    step_fn = getattr(trainer, step_attr)
    setattr(trainer, step_attr, capture.wrap(step_fn))
    t_epoch0 = time.perf_counter()
    trainer.train_epoch(0)
    setattr(trainer, step_attr, step_fn)
    sync(device)
    epoch = [1]
    per_epoch = min(len(loader) for loader in (trainer.train_loader,
                                               getattr(trainer, "target_loader", trainer.train_loader)))

    def one_epoch():
        m = trainer.train_epoch(epoch[0])
        epoch[0] += 1
        return per_epoch, round(m.get("nonfinite", 0.0) * per_epoch)

    setup_peak = peak_bytes(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    say(f"gpubench: set-up {setup_s:.2f} s, of which epoch 0 {time.perf_counter() - t_epoch0:.2f}")
    win = window(one_epoch, seconds, device, trace_units)
    return {"program": capture.record(), "setup_s": setup_s, "setup_peak": setup_peak,
            "window": win, "window_peak": peak_bytes(device)}


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0


def device_info(device, chips: int, memory_peak: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": memory_peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": memory_peak}


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def layer(kind: str, config: dict, win: dict, step: str, chips: int, window_peak: int) -> dict:
    """What the per-layer metric readers read."""
    dtype_peak = PEAKS["flops_per_s"][config["precision"]]
    return {"kind": kind, "trace": win["summary"], "units": win["traced_units"],
            "work": flops.step_work(config, step), "chips": chips,
            "peak_flops": dtype_peak, "hbm_bytes_per_s": PEAKS["hbm_bytes_per_s"],
            "window_peak_bytes": window_peak,
            "classes": common.load_json(trace.CLASSES_FILE)}


def breakdown(win: dict) -> dict | None:
    s = win["summary"]
    if s is None:
        return None
    return {"device_ops": s.top_ops(10), "idle_gaps": s.gaps(win["spans"], 10)}


def remove_tree(path: str) -> None:
    import shutil

    if path and os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
