"""Closed-loop training: the port's ``Trainer.train_epoch``, epochs back to back.

The mix's ``volumes`` distinct seeded volumes (with their labels, the
modalities in turn) sit in host memory as the decoded cache holds them,
fp32 images and int32 labels; the trainer's own loader threads stack them
and its pinned upload moves them. The trainer is built from a
``TrainerConfig`` with the train CLI's settings for the configuration, and
its weights are replaced by the benchmark's, made on the device from the
seed.

Set-up runs epoch 0 through the same ``train_epoch``, which warms every
shape up and drives the program from the seed through the first
``grad_accum`` steps (one AdamW update); what those steps produced is
captured and, after the window, compared with the reference following the
same steps. The window then runs epochs 1, 2, ... until ``seconds`` have
passed and counts every step as one sample of the batch.
"""

from __future__ import annotations

import time

import torch

from gpubench import compare, harness
from gpubench.reference.train import Logits, follow_train
from gpubench.weights import load_into, make_weights, unet3d_layout


def inputs(config, mix, seed, dev):
    """The mix's host volumes and the seeded weights (on ``dev``)."""
    volumes = harness.host_volumes(mix["volumes"], mix["modalities"], config["volume_size"],
                                   seed, dev)
    weights = make_weights(unet3d_layout(config["features"], config["in_channels"],
                                         config["classes"]), seed + 1, dev)
    return volumes, weights


def reference(config, seed, dev, volumes, weights, precision="fp32", logits=None):
    images, labels = harness.stack(volumes, dev)
    return follow_train({k: v.to(dev) for k, v in weights.items()}, images, labels,
                        harness.recipe(config), config["seed"], precision, logits)


def control(config, mix, seed, device, precision="fp8"):
    """The numbers of the reference computed in ``precision`` put in the
    program's place, on this run's inputs."""
    dev = torch.device(device)
    volumes, weights = inputs(config, mix, seed, dev)
    low = reference(config, seed, dev, volumes, weights, precision, Logits(keep=True))
    return compare.train_numbers(low, reference(config, seed, dev, volumes, weights,
                                                logits=Logits(low["logits"])))


def run(workload, config, mix, cell, seed, seconds, trace, device, t0, **_):
    from multimodal_segmentation_project_tpu_torch.engine.trainer import Trainer

    if mix["volumes"] < config["grad_accum"]:
        raise ValueError("set-up's epoch 0 must reach the first update: volumes >= grad_accum")
    dev = torch.device(device)
    volumes, weights = inputs(config, mix, seed, dev)
    exp_dir = harness.experiment_dir()
    try:
        trainer = Trainer(harness.trainer_config(config, device, exp_dir), volumes, volumes[:1])
        load_into(trainer.state.model, weights)
        weights = {k: v.cpu() for k, v in weights.items()}  # off the device for the window
        capture = harness.Capture({"seg": trainer.state}, {"seg": weights}, config["grad_accum"])
        run_ = harness.drive_trainer(trainer, "train_step", capture, seconds, dev, t0,
                                     mix["traced_epochs"] if trace else 0)
        del trainer, capture
    finally:
        harness.remove_tree(exp_dir)
    harness.free(dev)
    t = time.perf_counter()
    prog, win = run_["program"], run_["window"]
    numbers = compare.train_numbers(prog, reference(config, seed, dev, volumes, weights,
                                                    logits=Logits(prog["logits"])))
    harness.say(f"gpubench: the reference took {time.perf_counter() - t:.1f} s")
    steps = win["attempted"]
    return {
        "e2e": {"train_samples_per_s": steps * config["batch_size"] / win["window_s"],
                "setup_s": run_["setup_s"]},
        "attempted": steps, "failed": win["failed"],
        "numbers": numbers, "checks": compare.checks(numbers, cell["limits"]),
        "device": harness.device_info(dev, workload["chips"],
                                      max(run_["setup_peak"], run_["window_peak"])),
        "layer": harness.layer("train", config, win, "train", workload["chips"],
                               run_["window_peak"]),
        "breakdown": harness.breakdown(win),
    }
