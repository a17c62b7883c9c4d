"""Closed-loop DANN training: the port's ``DannTrainer.train_epoch``, epochs back to back.

The mix's source volumes (the configuration's source modality, with labels)
and target volumes (its target modality) sit in host memory; the trainer's
two loaders zip them, one source and one target volume a step. Everything
else is as ``trainer_epochs``: the trainer built from the DANN CLI's
settings, the benchmark's weights for the UNet3D and the discriminator, a
set-up epoch 0 whose first ``grad_accum`` steps (one update of each AdamW)
the reference follows, then epochs until ``seconds`` have passed. A step is
one sample: one source volume with its target volume.
"""

from __future__ import annotations

import time

import torch

from gpubench import compare, harness
from gpubench.reference.train import Logits, follow_dann
from gpubench.weights import discriminator_layout, load_into, make_weights, unet3d_layout


def inputs(config, mix, seed, dev):
    """Source and target host volumes, the UNet3D's and the discriminator's weights."""
    size = config["volume_size"]
    source = harness.host_volumes(mix["source_volumes"], [config["source_modality"]], size, seed,
                                  dev)
    target = harness.host_volumes(mix["target_volumes"], [config["target_modality"]], size,
                                  seed + 3, dev)
    weights = make_weights(unet3d_layout(config["features"], config["in_channels"],
                                         config["classes"]), seed + 1, dev)
    disc_weights = make_weights(discriminator_layout(2 * config["features"][-1]), seed + 2, dev)
    return source, target, weights, disc_weights


def reference(config, seed, dev, source, target, weights, disc_weights, precision="fp32",
              logits=None):
    src_images, src_labels = harness.stack(source, dev)
    tgt_images, _ = harness.stack(target, dev)
    return follow_dann({k: v.to(dev) for k, v in weights.items()},
                       {k: v.to(dev) for k, v in disc_weights.items()}, src_images, src_labels,
                       tgt_images, {**harness.recipe(config),
                                    "lambda_domain": config["lambda_domain"]},
                       config["seed"], precision, logits)


def control(config, mix, seed, device, precision="fp8"):
    """The numbers of the reference computed in ``precision`` put in the
    program's place, on this run's inputs."""
    dev = torch.device(device)
    data = inputs(config, mix, seed, dev)
    low = reference(config, seed, dev, *data, precision=precision, logits=Logits(keep=True))
    return compare.train_numbers(low, reference(config, seed, dev, *data,
                                                logits=Logits(low["logits"])))


def run(workload, config, mix, cell, seed, seconds, trace, device, t0, **_):
    from multimodal_segmentation_project_tpu_torch.engine.trainer import DannTrainer

    accum = config["grad_accum"]
    if min(mix["source_volumes"], mix["target_volumes"]) < accum:
        raise ValueError("set-up's epoch 0 must reach the first update: volumes >= grad_accum")
    dev = torch.device(device)
    source, target, weights, disc_weights = inputs(config, mix, seed, dev)
    exp_dir = harness.experiment_dir()
    try:
        trainer = DannTrainer(harness.trainer_config(config, device, exp_dir), source, target,
                              target[:1], lambda_domain=config["lambda_domain"])
        load_into(trainer.state.model, weights)
        load_into(trainer.disc_state.model, disc_weights)
        weights = {k: v.cpu() for k, v in weights.items()}  # off the device for the window
        disc_weights = {k: v.cpu() for k, v in disc_weights.items()}
        capture = harness.Capture({"seg": trainer.state, "disc": trainer.disc_state},
                                  {"seg": weights, "disc": disc_weights}, accum)
        run_ = harness.drive_trainer(trainer, "dann_step", capture, seconds, dev, t0,
                                     mix["traced_epochs"] if trace else 0)
        del trainer, capture
    finally:
        harness.remove_tree(exp_dir)
    harness.free(dev)
    t = time.perf_counter()
    prog, win = run_["program"], run_["window"]
    ref = reference(config, seed, dev, source, target, weights, disc_weights,
                    logits=Logits(prog["logits"]))
    numbers = compare.train_numbers(prog, ref)
    harness.say(f"gpubench: the reference took {time.perf_counter() - t:.1f} s")
    steps = win["attempted"]
    return {
        "e2e": {"train_samples_per_s": steps * config["batch_size"] / win["window_s"],
                "setup_s": run_["setup_s"]},
        "attempted": steps, "failed": win["failed"],
        "numbers": numbers, "checks": compare.checks(numbers, cell["limits"]),
        "device": harness.device_info(dev, workload["chips"],
                                      max(run_["setup_peak"], run_["window_peak"])),
        "layer": harness.layer("train", config, win, "dann", workload["chips"],
                               run_["window_peak"]),
        "breakdown": harness.breakdown(win),
    }
