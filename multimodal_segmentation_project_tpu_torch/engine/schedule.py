"""Host-side LR schedulers.

ReduceLROnPlateau replicates torch.optim.lr_scheduler.ReduceLROnPlateau
semantics as configured by the reference (train_unet.py:381):
mode='max', patience=10, factor=0.1, min_lr=1e-6 and torch defaults
threshold=1e-4 (relative), cooldown=0. The scheduler runs on the host
between epochs and writes the new LR into the TrainState scalar — no
re-jit, no optimizer rebuild.
"""

from __future__ import annotations


class ReduceLROnPlateau:
    def __init__(
        self,
        lr: float,
        mode: str = "max",
        factor: float = 0.1,
        patience: int = 10,
        threshold: float = 1e-4,
        threshold_mode: str = "rel",
        cooldown: int = 0,
        min_lr: float = 1e-6,
    ):
        assert mode in ("max", "min") and threshold_mode in ("rel", "abs")
        self.lr = float(lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = float("-inf") if mode == "max" else float("inf")
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, value: float) -> bool:
        if self.mode == "max":
            if self.threshold_mode == "rel":
                return value > self.best * (1.0 + self.threshold)
            return value > self.best + self.threshold
        if self.threshold_mode == "rel":
            return value < self.best * (1.0 - self.threshold)
        return value < self.best - self.threshold

    def step(self, value: float) -> float:
        """Record this epoch's monitored value; return the (possibly
        reduced) learning rate."""
        if self._is_better(value):
            self.best = value
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)
