"""3D U-Net in PyTorch: the reference module layout, the JAX package's eval
and train-mode forwards.

Port of ``multimodal_segmentation_project_tpu/models/unet3d.py:UNet3D``.
The submodules carry the reference state-dict keys
(``encoder.{i}.double_conv.{0,1,4,5}``, ``bottleneck``, ``upconvs.{i}``,
``decoder.{i}``, ``final_conv``), so a reference ``.pth`` loads with
``load_state_dict(strict=True)`` and ``engine.interop`` carries weights to
and from the JAX package. Every op is routed by channel width alone:

* a 3x3x3 conv with Cin, Cout <= 64 -> ``ops.conv3`` (eval:
  ``conv3x3x3_cf_relu``, BN folded; train: ``conv3x3x3_cf``, whose
  backward runs the dx and dW kernels);
* every pool, at every width -> ``ops.pool.max_pool2x_cf`` (forward and
  backward kernels);
* an upconv with Cout <= 64 -> ``ops.upconv.upconv2x_cf``;
* the 1x1x1 head -> ``ops.head.head1x1_cf`` (its backward runs the dx kernel);
* everything wider is the deep region (enc3, the bottleneck, dec0 and
  dec1's 128->64 conv at the default widths), which runs as the library's
  conv and transpose conv in the working dtype, as the JAX package runs it
  as XLA.

Eval forward (``model.eval()``): each BatchNorm is folded per channel into
its conv's weights and bias, in fp32, as the JAX package folds at
``unet3d.py:427-440``; in the deep region too (flax applies it unfolded
there; in fp32 that moves the logits by rounding only). At 192^3 and
default widths this is 11 conv, 4 pool, 3 upconv and 1 head kernel launch
per forward on a GPU.

Train-mode forward (``model.train()``): the JAX package's unfused
DoubleConv, [conv -> BatchNorm with batch statistics -> ReLU -> Dropout3d]
x 2, which computes the same function as its fused Pallas DoubleConv (in
fp32; the fused form rounds the statistics' input to bf16 elsewhere). The
statistics are fp32 over the conv's output in the working dtype, the
variance is the biased max(E[y^2] - E[y]^2, 0), and the running statistics
update as flax's do (momentum 0.9 on the old value, the biased variance).
Dropout3d draws one keep mask per (batch, channel) from the ``generator``
passed to :meth:`UNet3D.forward`. A 192^3 train step at default widths
launches 11 conv forward, 10 dx (not the image's), 11 dW, 4 pool forward,
4 pool backward, 3 upconv, 1 head and 1 head-dx kernel on a GPU.

On the CPU the same ops run their plain versions. ``dtype`` is the compute
dtype (bf16 on the GPU, fp32 in the CPU tests); parameters stay fp32.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch.ops import conv3, head, pool, upconv


FLAX_MOMENTUM = 0.9  # weight of the old value in the running statistics


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm3d) -> torch.Tensor:
    """Train-mode BatchNorm as flax computes it: fp32 batch statistics over
    (B, D, H, W), the biased variance max(E[y^2] - E[y]^2, 0), output
    (y - mean) * scale / sqrt(var + eps) + bias in fp32. Updates the running
    statistics in place with flax's momentum and the biased variance."""
    yf = y.float()
    dims = (0, 2, 3, 4)
    mean = yf.mean(dims)
    var = torch.clamp(yf.square().mean(dims) - mean.square(), min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(FLAX_MOMENTUM * bn.running_mean + (1 - FLAX_MOMENTUM) * mean)
        bn.running_var.copy_(FLAX_MOMENTUM * bn.running_var + (1 - FLAX_MOMENTUM) * var)
        bn.num_batches_tracked += 1
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (yf - mean.reshape(1, -1, 1, 1, 1)) * mul.reshape(1, -1, 1, 1, 1) + bn.bias.reshape(
        1, -1, 1, 1, 1)


def dropout3d(z: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Channel dropout: one keep mask per (batch, channel), drawn on the
    generator's device, kept values scaled by 1 / (1 - rate)."""
    if rate <= 0.0:
        return z
    keep = 1.0 - rate
    dev = generator.device if generator is not None else torch.device("cpu")
    mask = torch.rand(z.shape[:2], generator=generator, device=dev) < keep
    mask = mask.to(z.device, non_blocking=True)[:, :, None, None, None]
    return torch.where(mask, z / keep, torch.zeros((), dtype=z.dtype, device=z.device))


class DoubleConv(nn.Module):
    """[Conv3d(3x3x3) -> BatchNorm3d -> ReLU -> Dropout3d] x 2."""

    def __init__(self, cin: int, cout: int, dropout_rate: float = 0.1):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv3d(cin, cout, kernel_size=3, padding=1),
            nn.BatchNorm3d(cout, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
            nn.Dropout3d(dropout_rate),
            nn.Conv3d(cout, cout, kernel_size=3, padding=1),
            nn.BatchNorm3d(cout, eps=1e-5, momentum=0.1),
            nn.ReLU(inplace=True),
            nn.Dropout3d(dropout_rate),
        )

    def folded(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Both convs with their eval BatchNorm folded in, in fp32:
        [(w (3, 3, 3, Cin, Cout), b (Cout,))], the JAX kernel layout."""
        out = []
        for ci, bi in ((0, 1), (4, 5)):
            conv, bn = self.double_conv[ci], self.double_conv[bi]
            scale = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            shift = bn.bias - bn.running_mean * scale
            w = (conv.weight * scale.reshape(-1, 1, 1, 1, 1)).permute(2, 3, 4, 1, 0)
            out.append((w, conv.bias * scale + shift))
        return out

    def forward_eval(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for w, b in self.folded():
            x = x.to(dtype)
            if conv3.supported(w.shape[3], w.shape[4]):
                x = conv3.conv3x3x3_cf_relu(x, w, b)
            else:  # deep region
                wt = w.permute(4, 3, 0, 1, 2).to(dtype)
                x = torch.relu(F.conv3d(x, wt, b.to(dtype), padding=1))
        return x

    def forward_train(self, x: torch.Tensor, dtype: torch.dtype,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        for ci, bi, di in ((0, 1, 3), (4, 5, 7)):
            conv, bn = self.double_conv[ci], self.double_conv[bi]
            x = x.to(dtype)
            if conv3.supported(conv.in_channels, conv.out_channels):
                y = conv3.conv3x3x3_cf(x, conv.weight.permute(2, 3, 4, 1, 0), conv.bias)
            else:  # deep region
                y = F.conv3d(x, conv.weight.to(dtype), conv.bias.to(dtype), padding=1)
            z = torch.relu(batch_norm_train(y, bn))
            x = dropout3d(z, self.double_conv[di].p, generator).to(dtype)
        return x

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.training:
            return self.forward_train(x, dtype, generator)
        return self.forward_eval(x, dtype)


class UNet3D(nn.Module):
    """(B, in_channels, D, H, W) -> fp32 logits (B, out_channels, D, H, W).

    ``features`` are the encoder widths; the bottleneck is twice the last.
    ``generator`` seeds the initialisation (He-normal convs and upconvs,
    LeCun-normal head, zero biases, identity BatchNorm).
    """

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 4,
        features: Sequence[int] = (16, 32, 64, 128),
        dropout_rate: float = 0.1,
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.features = tuple(features)
        self.dtype = dtype
        self.encoder = nn.ModuleList()
        cin = in_channels
        for f in self.features:
            self.encoder.append(DoubleConv(cin, f, dropout_rate))
            cin = f
        self.bottleneck = DoubleConv(self.features[-1], self.features[-1] * 2, dropout_rate)
        self.upconvs = nn.ModuleList()
        self.decoder = nn.ModuleList()
        for f in reversed(self.features):
            self.upconvs.append(nn.ConvTranspose3d(f * 2, f, kernel_size=2, stride=2))
            self.decoder.append(DoubleConv(f * 2, f, dropout_rate))
        self.final_conv = nn.Conv3d(self.features[0], out_channels, kernel_size=1)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                if m is self.final_conv:
                    fan_in = m.in_channels
                    std = (1.0 / fan_in) ** 0.5
                else:
                    fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1] * m.kernel_size[2]
                    std = (2.0 / fan_in) ** 0.5
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * std)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm3d):
                m.reset_parameters()

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: torch.Generator | None = None):
        """Logits (and the bottleneck's global-average feature vector with
        ``return_features``). In train mode ``generator`` draws the
        Dropout3d masks."""
        dt = self.dtype
        # the kernels take contiguous NCDHW; NIfTI volumes decode Fortran-ordered
        x = x.to(dt).contiguous()
        skips = []
        for enc in self.encoder:
            x = enc(x, dt, generator)
            skips.append(x)
            x = pool.max_pool2x_cf(x)
        x = self.bottleneck(x, dt, generator)
        feat = x.float().mean(dim=(2, 3, 4)) if return_features else None

        for up, dec, skip in zip(self.upconvs, self.decoder, reversed(skips)):
            k = up.weight.permute(2, 3, 4, 0, 1)  # (Cin, Cout, 2,2,2) -> (2,2,2,Cin,Cout)
            if upconv.supported(k.shape[4]):
                x = upconv.upconv2x_cf(x, k, up.bias)
            else:  # deep region
                x = F.conv_transpose3d(x, up.weight.to(dt), up.bias.to(dt), stride=2)
            if x.shape[2:] != skip.shape[2:]:
                # shape guard for odd input sizes, trilinear as jax.image.resize
                x = F.interpolate(
                    x.float(), size=skip.shape[2:], mode="trilinear", align_corners=False
                ).to(dt)
            x = dec(torch.cat([skip, x], dim=1), dt, generator)

        kernel = self.final_conv.weight[:, :, 0, 0, 0].t()  # (Cin, classes)
        logits = head.head1x1_cf(x, kernel, self.final_conv.bias)
        if return_features:
            return logits, feat
        return logits
