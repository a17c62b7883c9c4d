"""The reference follows the first steps of the training recipes.

What the program derives from the seed, the reference works out again here
with frozen copies of the recipes' rules, and nothing of the program:

* the epoch's order of the volumes: numpy's ``default_rng(seed + epoch)``
  shuffle of ``arange(n)``, batches of one (the DANN target loader's seed is
  ``seed + 1000``);
* the step generator: a CPU ``torch.Generator`` seeded with
  ``((seed + 1) * 1000003 + epoch) * 1000003 + step``; it draws the
  augmentation, then the dropout masks; a DANN step first draws three seeds
  from it, for the source forward's, the target forward's and the
  discriminator's masks;
* gradient accumulation as ``optax.MultiSteps``: the mean of ``accum``
  steps' gradients goes to AdamW every ``accum``-th step;
* AdamW, decoupled: p <- p (1 - lr wd) - lr m_hat / (sqrt(v_hat) + eps).

A record holds each step's loss, each leaf's norm of the first step's
gradient, each leaf's norm of its change after the first update, the norm
of the gradient that update applied (for the rule that leaves out leaves
whose gradient is nought to rounding), and each step's (source) logits'
relative error against another run's, or those logits themselves.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference.augment import augment_batch
from gpubench.reference.unet3d import Reference, ce_tversky, cross_entropy, full_fp32

PRIME = 1_000_003
DISC_DROPOUT = 0.2


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    idx = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(idx)
    return idx


def step_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed(((seed + 1) * PRIME + epoch) * PRIME + step)


def split_generator(gen: torch.Generator, n: int) -> list:
    seeds = torch.randint(0, 2**62, (n,), generator=gen, device=gen.device)
    return [torch.Generator(device=gen.device).manual_seed(int(s)) for s in seeds]


class AdamW:
    """AdamW over a dict of leaves, with the accumulation's mean."""

    def __init__(self, params: dict, lr: float, weight_decay: float, accum: int,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.wd, self.accum = params, lr, weight_decay, accum
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.sum = {k: torch.zeros_like(v) for k, v in params.items()}
        self.calls = 0
        self.t = 0
        self.applied = None

    def step(self, grads: dict) -> bool:
        """Fold one step's gradients in; returns whether AdamW ran."""
        self.calls += 1
        for k, g in grads.items():
            self.sum[k] += g
        if self.calls % self.accum:
            return False
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        self.applied = {}
        with torch.no_grad():
            for k, p in self.params.items():
                g = self.sum[k] / self.accum
                self.applied[k] = g
                self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
                self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
                p.mul_(1 - self.lr * self.wd)
                p.sub_(self.lr * (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + self.eps))
                self.sum[k] = torch.zeros_like(p)
        return True


def _norms(tensors: dict, prefix: str = "") -> dict:
    return {prefix + k: float(t.detach().double().norm()) for k, t in tensors.items()}


def _record(nets: dict, opts: dict, initial: dict, losses: list, first: dict,
            logits: list) -> dict:
    update, applied = {}, {}
    for tag, net in nets.items():
        update.update(_norms({k: p.detach() - initial[tag][k] for k, p in net.params.items()},
                             tag + "."))
        applied.update(_norms(opts[tag].applied, tag + "."))
    return {"losses": losses, "first_grad": first, "update": update, "applied_grad": applied,
            "logits": logits}


class Logits:
    """Each step's logits against another run's: with ``other`` (a list of
    host tensors, one a step) the relative L2 error of the other's over this
    run's; with ``keep`` this run's logits on the host."""

    def __init__(self, other=None, keep: bool = False):
        self.other, self.keep, self.out = other, keep, []

    def __call__(self, step: int, logits: torch.Tensor) -> None:
        if self.keep:
            self.out.append(logits.detach().float().cpu())
        elif self.other is not None:
            got = self.other[step].to(logits.device)
            ref = logits.detach().float()
            self.out.append(float((got.double() - ref.double()).norm() / ref.double().norm()))


def follow_train(weights: dict, images, labels, recipe: dict, seed: int,
                 precision: str = "fp32", logits: Logits | None = None) -> dict:
    """The supervised recipe's first ``accum`` steps (its first update) on
    ``images`` (n, 1, D, H, W) and ``labels`` (n, D, H, W), one volume a
    step, in the epoch's order."""
    net = Reference(weights, recipe["features"], recipe["dropout_rate"], precision)
    opt = AdamW(net.params, recipe["lr"], recipe["weight_decay"], recipe["grad_accum"])
    initial = {"seg": {k: p.detach().clone() for k, p in net.params.items()}}
    order = epoch_order(len(images), seed, 0)
    losses, first = [], None
    with full_fp32():
        for step in range(recipe["grad_accum"]):
            gen = step_generator(seed, 0, step)
            i = int(order[step % len(order)])
            x, y = images[i:i + 1], labels[i:i + 1]
            if recipe["augment"]:
                x, y = augment_batch(gen, x, y)
            out = net.forward(x, train=True, gen=gen)
            if logits is not None:
                logits(step, out)
            loss = ce_tversky(out, y)
            del out
            grads = dict(zip(net.params, torch.autograd.grad(loss, list(net.params.values()))))
            losses.append(float(loss.detach()))
            if first is None:
                first = _norms(grads, "seg.")
            opt.step(grads)
            del grads, loss
    return _record({"seg": net}, {"seg": opt}, initial, losses, first,
                   logits.out if logits is not None else [])


class Discriminator:
    """fc0 -> ReLU -> Dropout(0.2) -> fc1 -> ReLU -> Dropout(0.2) -> fc2 -> ReLU
    -> out, fp32, its masks from the generator as the UNet's are."""

    def __init__(self, weights: dict):
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in weights.items()}

    def forward(self, x, gen):
        x = x.float()
        for i, name in enumerate(("fc0", "fc1", "fc2")):
            x = torch.relu(F.linear(x, self.params[f"{name}.weight"], self.params[f"{name}.bias"]))
            if i < 2:
                keep = torch.rand(x.shape, generator=gen, device=gen.device) < 1.0 - DISC_DROPOUT
                x = x * keep.to(x.device).float() / (1.0 - DISC_DROPOUT)
        return F.linear(x, self.params["out.weight"], self.params["out.bias"])


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


def follow_dann(weights: dict, disc_weights: dict, src_images, src_labels, tgt_images,
                recipe: dict, seed: int, precision: str = "fp32",
                logits: Logits | None = None) -> dict:
    """The DANN recipe's first ``accum`` steps: source and target volumes
    zipped in their loaders' orders, the source loss plus lambda times the
    domain loss through the gradient reversal, two AdamW states."""
    lam = recipe["lambda_domain"]
    net = Reference(weights, recipe["features"], recipe["dropout_rate"], precision)
    disc = Discriminator(disc_weights)
    opts = {"seg": AdamW(net.params, recipe["lr"], recipe["weight_decay"], recipe["grad_accum"]),
            "disc": AdamW(disc.params, recipe["lr"], recipe["weight_decay"], recipe["grad_accum"])}
    initial = {"seg": {k: p.detach().clone() for k, p in net.params.items()},
               "disc": {k: p.detach().clone() for k, p in disc.params.items()}}
    src_order = epoch_order(len(src_images), seed, 0)
    tgt_order = epoch_order(len(tgt_images), seed + 1000, 0)
    losses, first = [], None
    leaves = {**{"seg." + k: p for k, p in net.params.items()},
              **{"disc." + k: p for k, p in disc.params.items()}}
    with full_fp32():
        for step in range(recipe["grad_accum"]):
            g_src, g_tgt, g_disc = split_generator(step_generator(seed, 0, step), 3)
            i, j = int(src_order[step % len(src_order)]), int(tgt_order[step % len(tgt_order)])
            out, f_src = net.forward(src_images[i:i + 1], True, g_src, return_features=True)
            if logits is not None:
                logits(step, out)
            task = ce_tversky(out, src_labels[i:i + 1])
            f_tgt = net.forward(tgt_images[j:j + 1], True, g_tgt, return_features=True)[1]
            del out
            feats = torch.cat([_Reverse.apply(f_src, lam), _Reverse.apply(f_tgt, lam)])
            domain = cross_entropy(disc.forward(feats, g_disc),
                                   torch.tensor([0, 1], device=feats.device))
            total = task + lam * domain
            grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
            losses.append(float(total.detach()))
            if first is None:
                first = _norms(grads)
            opts["seg"].step({k[4:]: g for k, g in grads.items() if k.startswith("seg.")})
            opts["disc"].step({k[5:]: g for k, g in grads.items() if k.startswith("disc.")})
            del grads, total
    return _record({"seg": net, "disc": disc}, opts, initial, losses, first,
                   logits.out if logits is not None else [])
