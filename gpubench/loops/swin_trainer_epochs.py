"""Closed-loop training of SwinUNETR: the port's ``Trainer.train_epoch``, epochs back to back.

As ``trainer_epochs.py`` drives the UNet3D recipe, with the trainer built
for ``model="swin_unetr"``: the mix's ``volumes`` distinct seeded volumes
(with their labels, the modalities in turn) sit in host memory as the
decoded cache holds them; the trainer's own loader threads stack them and
its pinned upload moves them. The weights are the benchmark's, made on the
device from the seed in SwinUNETR's own layout (MONAI's names; below), and
loaded into the program's model.

Set-up runs epoch 0 through the same ``train_epoch`` (the first two steps
eager, the third captured as a CUDA graph, the rest replayed), which warms
every shape up, compiles the window-attention kernels and drives the
program from the seed through the first ``grad_accum`` steps (one AdamW
update); those steps are captured and, after the window, compared with
``reference/swin_unetr.py`` following the same steps. The window then runs
epochs 1, 2, ... until ``seconds`` have passed and counts every step as one
sample of the batch. The per-layer metrics read ``flops_swin.py``'s work.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from gpubench import common, compare, flops_swin, harness, trace
from gpubench.reference.swin_unetr import follow_swin_train
from gpubench.reference.train import Logits
from gpubench.weights import load_into


def swin_layout(config: dict) -> list:
    """[(name, shape, kind, fan_in)] of SwinUNETR's parameters, MONAI's names."""
    fs, cin, classes = config["feature_size"], config["in_channels"], config["classes"]
    p, win, ratio = config["patch_size"], config["window_size"], config["mlp_ratio"]
    table = (2 * win - 1) ** 3
    out = [("swinViT.patch_embed.proj.weight", (fs, cin, p, p, p), "he", cin * p ** 3),
           ("swinViT.patch_embed.proj.bias", (fs,), "bias", 0)]

    def linear(name, i, o, bias=True):
        return [(f"{name}.weight", (o, i), "trunc", i)] + ([(f"{name}.bias", (o,), "bias", 0)]
                                                           if bias else [])

    def norm(name, c):
        return [(f"{name}.weight", (c,), "ln_scale", 0), (f"{name}.bias", (c,), "ln_shift", 0)]

    for i, (depth, heads) in enumerate(zip(config["depths"], config["num_heads"])):
        c, layer = fs * 2 ** i, f"swinViT.layers{i + 1}.0"
        for j in range(depth):
            blk = f"{layer}.blocks.{j}"
            out += norm(f"{blk}.norm1", c)
            out.append((f"{blk}.attn.relative_position_bias_table", (table, heads), "trunc", 0))
            out += linear(f"{blk}.attn.qkv", c, 3 * c) + linear(f"{blk}.attn.proj", c, c)
            out += norm(f"{blk}.norm2", c)
            out += linear(f"{blk}.mlp.linear1", c, ratio * c)
            out += linear(f"{blk}.mlp.linear2", ratio * c, c)
        out += linear(f"{layer}.downsample.reduction", 8 * c, 2 * c, bias=False)
        out += norm(f"{layer}.downsample.norm", 8 * c)

    def res(name, a, b):
        out_ = [(f"{name}.conv1.conv.weight", (b, a, 3, 3, 3), "he", a * 27),
                (f"{name}.conv2.conv.weight", (b, b, 3, 3, 3), "he", b * 27)]
        if a != b:
            out_.append((f"{name}.conv3.conv.weight", (b, a, 1, 1, 1), "he", a))
        return out_

    out += res("encoder1.layer", cin, fs)
    for name, c in (("encoder2", fs), ("encoder3", 2 * fs), ("encoder4", 4 * fs),
                    ("encoder10", 16 * fs)):
        out += res(f"{name}.layer", c, c)
    for k, (a, b) in enumerate(((16 * fs, 8 * fs), (8 * fs, 4 * fs), (4 * fs, 2 * fs),
                                (2 * fs, fs), (fs, fs))):
        name = f"decoder{5 - k}"
        out.append((f"{name}.transp_conv.conv.weight", (a, b, 2, 2, 2), "he", a * 8))
        out += res(f"{name}.conv_block", 2 * b, b)
    out += [("out.conv.conv.weight", (classes, fs, 1, 1, 1), "lecun", fs),
            ("out.conv.conv.bias", (classes,), "bias", 0)]
    return out


def make_swin_weights(layout: list, seed: int, device) -> dict:
    """{name: fp32 tensor on ``device``} from one normal draw, scaled per
    kind: "trunc" 0.02 fmod(z, 2) (a normal cut at two sigma), "he" and
    "lecun" normal over the fan-in, "bias" 0.05 z, "ln_scale" 1 + 0.1 z,
    "ln_shift" 0.1 z."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(math.prod(shape) for _, shape, _, _ in layout), generator=gen,
                       device=device)
    out, offset = {}, 0
    for name, shape, kind, fan_in in layout:
        z = flat[offset:offset + math.prod(shape)].view(shape)
        offset += z.numel()
        t = {"trunc": lambda: 0.02 * torch.fmod(z, 2.0),
             "he": lambda: z * math.sqrt(2.0 / fan_in),
             "lecun": lambda: z * math.sqrt(1.0 / fan_in),
             "bias": lambda: 0.05 * z,
             "ln_scale": lambda: 1.0 + 0.1 * z,
             "ln_shift": lambda: 0.1 * z}[kind]()
        out[name] = t.contiguous()
    return out


def inputs(config, mix, seed, dev):
    """The mix's host volumes and the seeded weights (on ``dev``)."""
    volumes = harness.host_volumes(mix["volumes"], mix["modalities"], config["volume_size"],
                                   seed, dev)
    return volumes, make_swin_weights(swin_layout(config), seed + 1, dev)


def reference(config, seed, dev, volumes, weights, precision="fp32", logits=None):
    images, labels = harness.stack(volumes, dev)
    return follow_swin_train({k: v.to(dev) for k, v in weights.items()}, images, labels,
                             harness.recipe(config), config["seed"], precision, logits)


def control(config, mix, seed, device, precision="fp8"):
    """The numbers of the reference computed in ``precision`` put in the
    program's place, on this run's inputs."""
    dev = torch.device(device)
    volumes, weights = inputs(config, mix, seed, dev)
    low = reference(config, seed, dev, volumes, weights, precision, Logits(keep=True))
    return compare.train_numbers(low, reference(config, seed, dev, volumes, weights,
                                                logits=Logits(low["logits"])))


def layer(config: dict, win: dict, chips: int, window_peak: int) -> dict:
    """What the per-layer metric readers read, with SwinUNETR's work."""
    return {"kind": "train", "trace": win["summary"], "units": win["traced_units"],
            "work": flops_swin.step_work(config), "chips": chips,
            "peak_flops": harness.PEAKS["flops_per_s"][config["precision"]],
            "hbm_bytes_per_s": harness.PEAKS["hbm_bytes_per_s"],
            "window_peak_bytes": window_peak,
            "classes": common.load_json(trace.CLASSES_FILE)}


def run(workload, config, mix, cell, seed, seconds, trace, device, t0, **_):
    from multimodal_segmentation_project_tpu_torch.engine.trainer import Trainer

    if mix["volumes"] < config["grad_accum"]:
        raise ValueError("set-up's epoch 0 must reach the first update: volumes >= grad_accum")
    dev = torch.device(device)
    volumes, weights = inputs(config, mix, seed, dev)
    exp_dir = harness.experiment_dir()
    try:
        cfg = dataclasses.replace(harness.trainer_config(config, device, exp_dir),
                                  model="swin_unetr")
        trainer = Trainer(cfg, volumes, volumes[:1])
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
        "layer": layer(config, win, workload["chips"], run_["window_peak"]),
        "breakdown": harness.breakdown(win),
    }
