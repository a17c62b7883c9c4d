"""3D U-Net in PyTorch: the reference module layout, the JAX package's eval
forward.

Port of ``multimodal_segmentation_project_tpu/models/unet3d.py:UNet3D``.
The submodules carry the reference state-dict keys
(``encoder.{i}.double_conv.{0,1,4,5}``, ``bottleneck``, ``upconvs.{i}``,
``decoder.{i}``, ``final_conv``), so a reference ``.pth`` loads with
``load_state_dict(strict=True)`` and ``engine.interop`` carries weights to
and from the JAX package.

Eval forward (the only forward of this slice): each BatchNorm is folded
per channel into its conv's weights and bias, in fp32, as the JAX package
folds at ``unet3d.py:427-440``; then every op is routed by channel width
alone:

* a 3x3x3 conv with Cin, Cout <= 64 -> ``ops.conv3.conv3x3x3_cf_relu``;
* a pool over C <= 64 channels -> ``ops.pool.max_pool2x_cf``;
* an upconv with Cout <= 64 -> ``ops.upconv.upconv2x_cf``;
* the 1x1x1 head -> ``ops.head.head1x1_cf``;
* everything wider is the deep region (enc3, the bottleneck, dec0 and
  dec1's 128->64 conv at the default widths), which runs as the library's
  conv, transpose conv and a plain max in the working dtype, as the JAX
  package runs it as XLA. Its BatchNorm is folded too (flax applies it
  unfolded there); in fp32 that moves the logits by rounding only.

At 192^3 and default widths this is 11 conv, 3 pool, 3 upconv and 1 head
kernel launch per forward on a GPU. On the CPU the same ops run their
plain PyTorch versions. ``dtype`` is the compute dtype (bf16 on the GPU,
fp32 in the CPU tests); parameters stay fp32.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch.ops import conv3, head, pool, upconv


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

    def forward(self, x: torch.Tensor, return_features: bool = False):
        if self.training:
            raise RuntimeError(
                "UNet3D has only its eval forward so far: call model.eval() first"
            )
        dt = self.dtype
        # the kernels take contiguous NCDHW; NIfTI volumes decode Fortran-ordered
        x = x.to(dt).contiguous()
        skips = []
        for enc in self.encoder:
            x = enc.forward_eval(x, dt)
            skips.append(x)
            x = pool.max_pool2x_cf(x) if pool.supported(x.shape[1]) else pool.max_pool2x_cf_reference(x)
        x = self.bottleneck.forward_eval(x, dt)
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
            x = dec.forward_eval(torch.cat([skip, x], dim=1), dt)

        kernel = self.final_conv.weight[:, :, 0, 0, 0].t()  # (Cin, classes)
        logits = head.head1x1_cf(x, kernel, self.final_conv.bias)
        if return_features:
            return logits, feat
        return logits
