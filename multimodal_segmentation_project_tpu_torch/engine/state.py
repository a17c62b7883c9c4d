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
k-th step applies AdamW to the mean and clears it. ``step`` counts every
call, as the JAX state's does.

Unlike the JAX package's immutable state, this one is updated in place.
"""

from __future__ import annotations

import torch


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
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=self.lr, betas=self.betas, eps=self.eps,
            weight_decay=self.weight_decay,
        )
        self.mini_step = 0
        self.acc_grads: dict[str, torch.Tensor] = {}

    def trainable(self, name: str) -> bool:
        return not any(jax_module_name(name).startswith(p) for p in self.frozen_prefixes)

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
                self.acc_grads[name] = g.clone() if acc is None else acc + (g - acc) / (n + 1)
            self.mini_step = (n + 1) % self.grad_accum_steps
            grads = {}
            if self.mini_step == 0:
                grads, self.acc_grads = self.acc_grads, {}
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
            "acc_grads": {k: v.cpu() for k, v in self.acc_grads.items()},
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
