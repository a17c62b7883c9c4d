"""The DANN domain discriminator.

Port of ``multimodal_segmentation_project_tpu/models/discriminator.py``:
fc0 (in -> 256) -> ReLU -> Dropout(0.2) -> fc1 (256 -> 128) -> ReLU ->
Dropout(0.2) -> fc2 (128 -> 64) -> ReLU -> out (64 -> 2), in fp32 whatever
the segmentation net's compute dtype. Its input is the bottleneck's global
average, so ``in_features`` is the bottleneck width, 2 * features[-1]
(flax's ``nn.Dense`` infers it from its input). Plain torch on every device:
at (B, 256) the JAX package runs it as XLA, with no Pallas kernel.

The weights initialise as flax's default ``nn.Dense`` does: LeCun-normal
(a normal truncated at two standard deviations, with variance 1 / fan_in
after the truncation) and zero biases. The dropout masks come from an
explicit ``torch.Generator``, never from the global RNG.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from multimodal_segmentation_project_tpu_torch.models.unet3d import _keep_mask

# std of a standard normal truncated to [-2, 2] (jax.nn.initializers'
# truncated_normal divides by it so that the variance is the one asked for)
_TRUNC_STD = 0.87962566103423978
HIDDEN = (256, 128, 64)
NUM_DOMAINS = 2


class DomainDiscriminator(nn.Module):
    def __init__(self, in_features: int, dropout_rate: float = 0.2,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.fc0 = nn.Linear(in_features, HIDDEN[0])
        self.fc1 = nn.Linear(HIDDEN[0], HIDDEN[1])
        self.fc2 = nn.Linear(HIDDEN[1], HIDDEN[2])
        self.out = nn.Linear(HIDDEN[2], NUM_DOMAINS)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for layer in (self.fc0, self.fc1, self.fc2, self.out):
            std = (1.0 / layer.in_features) ** 0.5 / _TRUNC_STD
            w = torch.empty(layer.weight.shape)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
            layer.weight.copy_(w * std)
            layer.bias.zero_()

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                rows: tuple[int, torch.Tensor] | None = None) -> torch.Tensor:
        """Domain logits (B, 2) in fp32. In train mode the outputs of fc0 and
        fc1 take dropout, drawn from ``generator``; with ``rows`` = (global
        rows, the indices of x's rows among them) the masks are drawn for the
        global rows and x's taken (a data mesh's rank holds some rows)."""
        x = x.float()
        n_rows, index = rows if rows is not None else (x.shape[0], None)
        for i, layer in enumerate((self.fc0, self.fc1, self.fc2)):
            x = torch.relu(layer(x))
            if i < 2 and self.training and self.dropout_rate > 0.0:
                keep = _keep_mask((n_rows, x.shape[1]), self.dropout_rate, generator, x.device,
                                  index)
                x = torch.where(keep, x / (1.0 - self.dropout_rate),
                                torch.zeros((), dtype=x.dtype, device=x.device))
        return self.out(x)
