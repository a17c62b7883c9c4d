"""Train state: the model (params and BatchNorm statistics), AdamW, the
trainable mask, the learning rate, the step count and the gradient
accumulator.

Port of ``multimodal_segmentation_project_tpu/engine/state.py``. The JAX
package builds optax's AdamW with unit learning rate and multiplies the
state's LR (and the 0/1 trainable mask) onto its updates:
p -= lr * mask * (m_hat / (sqrt(v_hat) + eps) + wd * p). torch's decoupled
AdamW with the state's LR is the same algebra, so the port uses it (the
JAX package uses optax here, not a Pallas kernel), setting the LR on every
update. Frozen parameters get their gradient dropped before the update,
so they see neither a step nor weight decay; freezing or unfreezing starts
a fresh optimizer, as the reference does.

Gradient accumulation averages like ``optax.MultiSteps``: every step folds
its gradients into a running mean, acc += (g - acc) / (n + 1), and every
k-th step applies AdamW to the mean. The mean is kept until the next step
overwrites it: optax keeps 0 * mean there (zeros signed as the mean), which
:meth:`TrainState.optax_state` writes, so a JAX checkpoint goes through the
port byte for byte. ``step`` counts every call, as the JAX state's does.

Unlike the JAX package's immutable state, this one is updated in place.

:meth:`TrainState.optax_state` and :meth:`TrainState.load_optax_state`
carry AdamW and the accumulator to and from optax's layout, which the JAX
package's ``.msgpack`` checkpoints hold (``engine/checkpoint.py``):
``{"0": {count, mu, nu}, "1": {}, "2": {}}`` (adamw's chain), wrapped in
``{mini_step, gradient_step, inner_opt_state, acc_grads, skip_state}``
(``optax.MultiSteps``) when and only when ``grad_accum_steps > 1``. Each
moment and the accumulator take their param's layout transform
(``engine/interop.py``); ``count`` is torch's per-param ``step``;
``trainable_mask`` (float32 0/1 per param) is ``frozen_prefixes``.

The JAX module's functions have counterparts here: :func:`make_optimizer`
builds the AdamW (the only place the port builds one), :func:`freeze_mask`
the 0/1 value per parameter, :func:`create_train_state` the state of a
built module (a torch module is built, with its own generator, before its
state is, so it takes the module where the JAX one takes an rng and a
sample input) and :func:`param_count` counts its parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_segmentation_project_tpu_torch.engine.interop import (
    named_to_tree,
    tree_leaves,
    tree_to_named,
)


def jax_module_name(param_name: str) -> str:
    """The JAX param tree's top-level module of a reference-layout param
    name (``encoder.1...`` -> ``enc1``, ``upconvs.0``/``decoder.0`` ->
    ``dec0``), which the freeze prefixes match."""
    head, _, rest = param_name.partition(".")
    idx = rest.partition(".")[0]
    if head == "encoder":
        return f"enc{idx}"
    if head in ("decoder", "upconvs"):
        return f"dec{idx}"
    if head == "final_conv":
        return "head_kernel" if rest == "weight" else "head_bias"
    return head


def _frozen(param_name: str, frozen_prefixes: tuple[str, ...]) -> bool:
    return any(jax_module_name(param_name).startswith(p) for p in frozen_prefixes)


def make_optimizer(params, lr: float = 1.0, weight_decay: float = 0.01, b1: float = 0.9,
                   b2: float = 0.999, eps: float = 1e-8) -> torch.optim.AdamW:
    """torch's decoupled AdamW over ``params``, with the JAX ``make_optimizer``'s
    defaults. :class:`TrainState` sets its LR before every update and does
    the gradient accumulation itself."""
    return torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay)


def freeze_mask(model: torch.nn.Module, frozen_prefixes: tuple[str, ...]) -> dict:
    """{param name: fp32 0-d tensor}: 0 for the params under a JAX top-level
    module whose name starts with one of ``frozen_prefixes`` (``('enc',)``
    freezes the encoder, ``('enc', 'bottleneck')`` the encoder and the
    bottleneck), 1 for the others."""
    return {name: torch.tensor(0.0 if _frozen(name, frozen_prefixes) else 1.0)
            for name, _ in model.named_parameters()}


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


class TrainState:
    def __init__(self, model: torch.nn.Module, lr: float, weight_decay: float = 0.01,
                 grad_accum_steps: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.model = model
        self.lr = float(lr)
        self.weight_decay = weight_decay
        self.grad_accum_steps = max(int(grad_accum_steps), 1)
        self.betas, self.eps = (b1, b2), eps
        self.frozen_prefixes: tuple[str, ...] = ()
        self.step = 0
        self.reset_optimizer()

    def reset_optimizer(self) -> None:
        """A fresh AdamW (zero moments, step 0) and an empty accumulator."""
        self.optimizer = make_optimizer(self.model.parameters(), self.lr, self.weight_decay,
                                        *self.betas, self.eps)
        self.mini_step = 0
        self.acc_grads: dict[str, torch.Tensor] = {}

    def trainable(self, name: str) -> bool:
        return not _frozen(name, self.frozen_prefixes)

    def with_mask(self, frozen_prefixes: tuple[str, ...]) -> None:
        """Freeze the params under the JAX top-level modules whose names
        start with one of ``frozen_prefixes`` (``()`` unfreezes all), with a
        fresh optimizer."""
        self.frozen_prefixes = tuple(frozen_prefixes)
        self.reset_optimizer()

    def apply_gradients(self) -> None:
        """One step with the gradients in ``p.grad``. Afterwards ``p.grad``
        holds what AdamW was given (None for a frozen param, and for all on
        an accumulating step that applies nothing)."""
        self.step += 1
        grads = {n: p.grad for n, p in self.model.named_parameters() if p.grad is not None}
        if self.grad_accum_steps > 1:
            n = self.mini_step
            for name, g in grads.items():
                acc = self.acc_grads.get(name)
                self.acc_grads[name] = g.clone() if n == 0 or acc is None else acc + (g - acc) / (n + 1)
            self.mini_step = (n + 1) % self.grad_accum_steps
            grads = self.acc_grads if self.mini_step == 0 else {}
        for name, p in self.model.named_parameters():
            p.grad = grads.get(name) if self.trainable(name) else None
        if grads:
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr
            self.optimizer.step()

    # ---- checkpoints ----

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "lr": self.lr,
            "frozen_prefixes": list(self.frozen_prefixes),
            "mini_step": self.mini_step,
            # at mini_step 0 the accumulator holds the applied mean: not state
            "acc_grads": {k: v.cpu() for k, v in self.acc_grads.items()} if self.mini_step else {},
        }

    def load_state_dict(self, state: dict, optimizer_state: dict) -> None:
        self.step = int(state["step"])
        self.lr = float(state["lr"])
        self.frozen_prefixes = tuple(state["frozen_prefixes"])
        self.reset_optimizer()
        self.optimizer.load_state_dict(optimizer_state)
        dev = next(self.model.parameters()).device
        self.mini_step = int(state["mini_step"])
        self.acc_grads = {k: v.to(dev) for k, v in state["acc_grads"].items()}

    # ---- the JAX package's layout (optax) ----

    def trainable_mask(self) -> dict:
        """The JAX state's ``trainable_mask``: float32 1 or 0 per param."""
        return named_to_tree(freeze_mask(self.model, self.frozen_prefixes))

    def optax_state(self) -> dict:
        """AdamW and the accumulator as the JAX state's ``opt_state``."""
        mu, nu, steps = {}, {}, set()
        for name, p in self.model.named_parameters():
            st = self.optimizer.state.get(p)
            if st:
                steps.add(int(st["step"]))
                mu[name], nu[name] = st["exp_avg"], st["exp_avg_sq"]
            else:
                # A frozen param has no moments here. JAX updates its moments
                # behind the mask (engine/state.py:46-51), but nothing reads
                # them before the next mask change, which resets the optimizer
                # in both packages: zeros are exact.
                mu[name] = nu[name] = torch.zeros_like(p)
        if len(steps) > 1:
            raise ValueError(f"AdamW's params are at different steps {sorted(steps)}")
        count = np.asarray(steps.pop() if steps else 0, np.int32)
        inner = {"0": {"count": count, "mu": named_to_tree(mu), "nu": named_to_tree(nu)},
                 "1": {}, "2": {}}
        if self.grad_accum_steps == 1:
            return inner
        # after an update the accumulator holds the applied mean: optax keeps 0 * mean
        keep = 0 if self.mini_step == 0 else 1
        acc = {n: self.acc_grads[n] * keep if n in self.acc_grads else torch.zeros_like(p)
               for n, p in self.model.named_parameters()}
        # gradient_step counts the inner updates, as count does
        return {"mini_step": np.asarray(self.mini_step, np.int32), "gradient_step": count.copy(),
                "inner_opt_state": inner, "acc_grads": named_to_tree(acc), "skip_state": {}}

    def load_optax_state(self, opt_state: dict, trainable_mask: dict | None = None) -> None:
        """Restore AdamW and the accumulator from a JAX ``opt_state``, and the
        frozen prefixes from its ``trainable_mask`` (None: all trainable).
        The moments of frozen params are dropped (see :meth:`optax_state`)."""
        multi = "inner_opt_state" in opt_state
        if multi != (self.grad_accum_steps > 1):
            raise ValueError(
                f"the checkpoint's optimizer {'accumulates' if multi else 'does not accumulate'} "
                f"gradients (optax.MultiSteps), this run's grad_accum_steps is "
                f"{self.grad_accum_steps}")
        self.frozen_prefixes = frozen_prefixes_from_mask(trainable_mask or {})
        self.reset_optimizer()
        adam = (opt_state["inner_opt_state"] if multi else opt_state)["0"]
        count = int(adam["count"])
        if count:
            mu, nu = tree_to_named(adam["mu"]), tree_to_named(adam["nu"])
            sd = self.optimizer.state_dict()
            sd["state"] = {
                i: {"step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                for i, (name, _) in enumerate(self.model.named_parameters())
                if self.trainable(name)
            }
            self.optimizer.load_state_dict(sd)  # casts the moments to each param
        if multi:
            self.mini_step = int(opt_state["mini_step"])
            dev = next(self.model.parameters()).device
            self.acc_grads = {n: v.to(dev)
                              for n, v in tree_to_named(opt_state["acc_grads"]).items()}


def create_train_state(model: torch.nn.Module, lr: float, weight_decay: float = 0.01,
                       grad_accum_steps: int = 1) -> TrainState:
    """The train state of a built model (on its device): a fresh AdamW from
    :func:`make_optimizer`, step 0, every param trainable
    (:meth:`TrainState.with_mask` freezes)."""
    return TrainState(model, lr, weight_decay, grad_accum_steps)


def frozen_prefixes_from_mask(mask: dict) -> tuple[str, ...]:
    """The freeze prefixes of a JAX ``trainable_mask``: the top-level modules
    whose leaves are all 0, as ``enc`` where that takes in every ``enc{i}``
    and no module that is trainable. A module with mixed 0 and 1 is refused:
    the JAX package freezes whole top-level modules."""
    frozen = []
    for module, sub in mask.items():
        values = {float(v) for _, v in tree_leaves(sub)}
        if len(values) != 1 or not values <= {0.0, 1.0}:
            raise ValueError(f"trainable_mask of '{module}' holds {sorted(values)}: the port "
                             "freezes whole top-level modules")
        if values == {0.0}:
            frozen.append(module)
    prefixes = []
    for module in frozen:
        base = module.rstrip("0123456789")
        if all(m in frozen for m in mask if m.startswith(base)):
            module = base
        if module not in prefixes:
            prefixes.append(module)
    return tuple(prefixes)
