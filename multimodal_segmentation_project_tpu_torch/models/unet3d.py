"""3D U-Net in PyTorch: the reference module layout, the JAX package's eval
and train-mode forwards.

Port of ``multimodal_segmentation_project_tpu/models/unet3d.py:UNet3D``.
The submodules carry the reference state-dict keys
(``encoder.{i}.double_conv.{0,1,4,5}``, ``bottleneck``, ``upconvs.{i}``,
``decoder.{i}``, ``final_conv``), so a reference ``.pth`` loads with
``load_state_dict(strict=True)`` and ``engine.interop`` carries weights to
and from the JAX package. Every op is routed by channel width, and the
upconv by its dtype too, as the JAX package routes them:

* a 3x3x3 conv with Cin, Cout <= 64 -> ``ops.conv3`` (eval:
  ``conv3x3x3_cf_relu``, BN folded, in bf16 or fp32 (``conv3.eval_route``);
  train: ``conv3x3x3_cf``, whose backward runs the dx and dW kernels, in
  bf16 or fp32), and in train mode a DoubleConv whose two convs both are ->
  ``ops.conv3_fused`` (the fused block), except in fp32 on the card
  (``conv3.fuses``), whose fused instances are not written yet;
* every pool, at every width -> ``ops.pool.max_pool2x_cf`` (forward and
  backward kernels; the forward in bf16 or fp32);
* an upconv with Cout <= 64 -> ``ops.upconv.upconv2x_cf`` in bf16
  (``upconv.runs_op``); on the GPU in fp32 every upconv is the library's
  transpose conv, as the JAX package sends every non-bf16 upconv to an XLA
  einsum (on the CPU the op's plain version is that einsum);
* the 1x1x1 head -> ``ops.head.head1x1_cf`` (bf16 or fp32 features; its
  backward runs the dx and weight-gradient kernels);
* everything wider is the deep region (enc3, the bottleneck, dec0 and
  dec1's 128->64 conv at the default widths), which runs as the library's
  conv and transpose conv in the working dtype, as the JAX package runs it
  as XLA. In an fp32 forward the library runs in full fp32
  (:func:`library_precision`: cuDNN's TF32 is off), and the train steps'
  backward too (``engine.steps``).

Eval forward (``model.eval()``): each BatchNorm is folded per channel into
its conv's weights and bias, in fp32, as the JAX package folds at
``unet3d.py:427-440``; in the deep region too (flax applies it unfolded
there; in fp32 that moves the logits by rounding only). At 192^3 and
default widths this is 11 conv, 4 pool, 3 upconv and 1 head kernel launch
per forward on a GPU in bf16; in fp32, 11 fp32 conv, 4 fp32 pool and 1 fp32
head launches, 7 library convs and 4 library transpose convs.

Train-mode forward (``model.train()``): the JAX package's training
DoubleConv as it runs on its chip. A block whose two convs both have Cin,
Cout <= 64 (enc0-enc2, dec2, dec3 at the default widths) takes the fused
path (``unet3d.py:_fused_boundary_path``): conv0 emits its output y0 and
per-channel sums (``conv3x3x3_cf_stats``), BatchNorm0 reduces to a
per-channel affine (:func:`batch_norm_affine`), the Dropout3d keep mask
(scaled by 1 / keep) folds into it, and conv1 applies that affine and the
ReLU to its input tile (``conv3x3x3_cf_boundary_stats`` on the raw y0), so
the activation between the convs never exists in device memory; then
BatchNorm1's affine, ReLU and the second mask in fp32, one cast. Any other
block (dec1, whose conv0 is 128->64, and the deep region) runs the per-conv
chain [conv -> BatchNorm with batch statistics -> ReLU -> Dropout3d] x 2,
as the JAX package's per-conv loop does. Both compute the same function; the
fused one takes its statistics as sums of the conv's rounded output. The
variance is the biased max(E[y^2] - E[y]^2, 0), and the running statistics
update as flax's do (momentum 0.9 on the old value, the biased variance).
Dropout3d draws one keep mask per (batch, channel) from the ``generator``
passed to :meth:`UNet3D.forward`, in the same order on both paths. A 192^3
train step at default widths launches 5 conv+stats, 5 boundary conv+stats,
1 conv forward (dec1's conv1), 5 dx, 5 dx-epilogue, 6 dW, 5 prologue dW, 4
pool forward, 4 pool backward, 3 upconv, 1 head, 1 head-dx and 1
head-weight-gradient kernel on a GPU. In fp32 on a GPU every block runs
the per-conv chain (the JAX package runs that configuration only under a
data mesh; its fused block's fp32 instances are the port's next work): 11
conv, 10 dx and 11 dW launches of the fp32 bodies, 4 pool forward and 4
pool backward, 1 head, 1 head-dx and 1 head-weight-gradient, and the
library's 7 convs and 4 transpose convs forward.

On the CPU the same ops run their plain versions. ``dtype`` is the compute
dtype (bf16 or fp32); parameters stay fp32.
"""

from __future__ import annotations

import contextlib
from collections.abc import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch.ops import conv3, conv3_fused, head, pool, upconv


FLAX_MOMENTUM = 0.9  # weight of the old value in the running statistics


@contextlib.contextmanager
def library_precision(dtype: torch.dtype):
    """cuDNN in full fp32 around an fp32 forward's library calls (the deep
    region's convs, the fp32 upconvs): a float32 convolution goes through
    TF32 by default (``torch.backends.cudnn.allow_tf32`` is True), which
    errs by about 1e-3. The other cuDNN flags keep their values, and outside
    the forward nothing changes (a bf16 path, the DANN discriminator). A
    float32 matmul is full fp32 by default
    (``torch.backends.cuda.matmul.allow_tf32`` is False), and the port
    keeps it so."""
    if dtype != torch.float32:
        yield
        return
    c = torch.backends.cudnn
    with c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=c.deterministic,
                 allow_tf32=False):
        yield


def _update_running(bn: nn.BatchNorm3d, mean: torch.Tensor, var: torch.Tensor) -> None:
    """flax's running update: momentum on the old value, the biased variance."""
    with torch.no_grad():
        bn.running_mean.copy_(FLAX_MOMENTUM * bn.running_mean + (1 - FLAX_MOMENTUM) * mean)
        bn.running_var.copy_(FLAX_MOMENTUM * bn.running_var + (1 - FLAX_MOMENTUM) * var)
        bn.num_batches_tracked += 1


def batch_norm_train(y: torch.Tensor, bn: nn.BatchNorm3d) -> torch.Tensor:
    """Train-mode BatchNorm as flax computes it: fp32 batch statistics over
    (B, D, H, W), the biased variance max(E[y^2] - E[y]^2, 0), output
    (y - mean) * scale / sqrt(var + eps) + bias in fp32. Updates the running
    statistics in place with flax's momentum and the biased variance."""
    yf = y.float()
    dims = (0, 2, 3, 4)
    mean = yf.mean(dims)
    var = torch.clamp(yf.square().mean(dims) - mean.square(), min=0.0)
    _update_running(bn, mean, var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (yf - mean.reshape(1, -1, 1, 1, 1)) * mul.reshape(1, -1, 1, 1, 1) + bn.bias.reshape(
        1, -1, 1, 1, 1)


def batch_norm_affine(s1: torch.Tensor, s2: torch.Tensor, n: int,
                      bn: nn.BatchNorm3d) -> tuple[torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm from per-channel fp32 sums of y and y^2 over n
    values, as the JAX package's ``BatchNormCF(return_affine=True)``: mean
    s1 / n, the biased variance max(s2 / n - mean^2, 0), flax's running
    update, and the per-channel affine (a, t) with BN(y) = y a + t:
    a = scale * rsqrt(var + eps), t = bias - mean a."""
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    _update_running(bn, mean, var)
    a = bn.weight * torch.rsqrt(var + bn.eps)
    return a, bn.bias - mean * a


def _keep_mask(shape: tuple[int, int], rate: float, generator: torch.Generator | None,
               device: torch.device) -> torch.Tensor:
    """Dropout3d's keep mask per (batch, channel), drawn on the generator's
    device and moved to ``device``."""
    dev = generator.device if generator is not None else torch.device("cpu")
    mask = torch.rand(shape, generator=generator, device=dev) < 1.0 - rate
    return mask.to(device, non_blocking=True)


def dropout_scale(shape: tuple[int, int], rate: float, generator: torch.Generator | None,
                  device: torch.device) -> torch.Tensor | None:
    """The keep mask as fp32 mask / keep (B, C), the factor the fused block
    folds into its affine; None when the rate is 0."""
    if rate <= 0.0:
        return None
    return _keep_mask(shape, rate, generator, device).float() / (1.0 - rate)


def dropout3d(z: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Channel dropout: one keep mask per (batch, channel), kept values
    scaled by 1 / (1 - rate)."""
    if rate <= 0.0:
        return z
    mask = _keep_mask(tuple(z.shape[:2]), rate, generator, z.device)[:, :, None, None, None]
    return torch.where(mask, z / (1.0 - rate), torch.zeros((), dtype=z.dtype, device=z.device))


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
            if conv3.eval_route(dtype, w.shape[3], w.shape[4]) is not None:
                x = conv3.conv3x3x3_cf_relu(x, w, b)
            else:  # deep region
                wt = w.permute(4, 3, 0, 1, 2).to(dtype)
                x = torch.relu(F.conv3d(x, wt, b.to(dtype), padding=1))
        return x

    def fused(self, dtype: torch.dtype = torch.bfloat16, device_type: str = "cuda") -> bool:
        """Whether the train-mode forward in ``dtype`` on a ``device_type``
        device takes the fused path: both convs on the kernels, and a
        (dtype, device) whose fused instances exist (``conv3.fuses``)."""
        c0, c1 = self.double_conv[0], self.double_conv[4]
        return (conv3.fuses(dtype, device_type)
                and conv3.supported(c0.in_channels, c0.out_channels)
                and conv3.supported(c1.in_channels, c1.out_channels))

    def forward_train(self, x: torch.Tensor, dtype: torch.dtype,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        if self.fused(dtype, x.device.type):
            return self.forward_train_fused(x, dtype, generator)
        return self.forward_train_per_conv(x, dtype, generator)

    def forward_train_fused(self, x: torch.Tensor, dtype: torch.dtype,
                            generator: torch.Generator | None = None) -> torch.Tensor:
        """The fused block, step by step as ``unet3d.py:_fused_boundary_path``."""
        conv0, bn0, drop0, conv1, bn1, drop1 = (self.double_conv[i] for i in (0, 1, 3, 4, 5, 7))
        y0, s1, s2 = conv3_fused.conv3x3x3_cf_stats(
            x.to(dtype), conv0.weight.permute(2, 3, 4, 1, 0), conv0.bias)
        n = y0.numel() // y0.shape[1]
        bsz, c = y0.shape[:2]
        a, t = batch_norm_affine(s1, s2, n, bn0)
        a, t = a.expand(bsz, c), t.expand(bsz, c)
        m0 = dropout_scale((bsz, c), drop0.p, generator, y0.device)
        if m0 is not None:  # mask >= 0, so relu(y a m + t m) = relu(y a + t) m
            a, t = a * m0, t * m0
        y1, s1, s2 = conv3_fused.conv3x3x3_cf_boundary_stats(
            y0, conv1.weight.permute(2, 3, 4, 1, 0), conv1.bias, a, t)
        a, t = batch_norm_affine(s1, s2, n, bn1)
        z = torch.relu(y1.float() * a.reshape(1, -1, 1, 1, 1) + t.reshape(1, -1, 1, 1, 1))
        m1 = dropout_scale((bsz, c), drop1.p, generator, y1.device)
        if m1 is not None:
            z = z * m1[:, :, None, None, None]
        return z.to(dtype)

    def forward_train_per_conv(self, x: torch.Tensor, dtype: torch.dtype,
                               generator: torch.Generator | None = None) -> torch.Tensor:
        """[conv -> BatchNorm -> ReLU -> Dropout3d] x 2, one conv at a time."""
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
        with library_precision(self.dtype):
            return self._forward(x, return_features, generator)

    def _forward(self, x: torch.Tensor, return_features: bool,
                 generator: torch.Generator | None):
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
            if upconv.runs_op(x, k.shape[4]):
                x = upconv.upconv2x_cf(x, k, up.bias)
            else:  # deep region, and every fp32 upconv on the card
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
