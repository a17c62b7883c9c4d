"""SwinUNETR in PyTorch: MONAI's ``monai.networks.nets.SwinUNETR`` at its
published defaults, on the port's kernels.

Hatamizadeh et al., *Swin UNETR: Swin Transformers for Semantic
Segmentation of Brain Tumors in MRI Images* (arXiv:2201.01266); the
equations are MONAI's (``monai/networks/nets/swin_unetr.py``, with
``UnetrBasicBlock``, ``UnetrUpBlock``, ``UnetResBlock`` and
``UnetOutBlock``): feature size 48, patch 2, window 7^3, depths (2, 2, 2, 2),
heads (3, 6, 12, 24) (head dim 16 at every stage), MLP ratio 4, qkv bias,
no dropout and no drop path, instance norm, ``normalize=True``. The modules
carry MONAI's state-dict names (``swinViT.layers1.0.blocks.0.attn.qkv.weight``,
``encoder1.layer.conv1.conv.weight``, ``decoder5.transp_conv.conv.weight``,
``out.conv.conv.weight``, ...); ``relative_position_index`` is a
non-persistent buffer here, so it is not in the state dict.

Encoder (tokens in (B, D, H, W, C)): a 2x2x2 stride-2 conv with bias (no
patch norm), then four stages of two Swin blocks, the first unshifted and
the second shifted by 3, each followed by patch merging; ``hs_i`` is the
stage's input, or the last stage's output, through a LayerNorm over C with
no affine (``proj_out``). A Swin block is x + W-MSA(LN1(x)), then
x + Linear(GELU(Linear(LN2(x)))), with GELU's erf form; W-MSA is
``ops.window_attn.window_attention`` on the qkv Linear's output, then the
output Linear. Patch merging concatenates the eight 2x2x2 sub-grids in
``itertools.product(range(2), range(2), range(2))`` order over (d, h, w)
(MONAI's ``PatchMergingV2``), then LayerNorm(8C) and Linear(8C -> 2C, no
bias). **Departure:** MONAI's default ``downsample="merging"`` keeps
v0.9's slice order for old checkpoints; with seeded weights the order
changes no work, and a checkpoint trained with that order would need its
``reduction`` rows permuted.

Decoder (channel-first (B, C, D, H, W)): residual blocks Res(a -> b) =
LeakyReLU(IN(conv3(LeakyReLU(IN(conv3(x))))) + r), with bias-free 3x3x3
convs, InstanceNorm with no affine (instance statistics in train and eval,
biased variance, eps 1e-5), LeakyReLU 0.01, and r = IN(conv1x1(x)) where
a != b, else x. enc0 = Res(1 -> 48)(x), enc1..enc3 on hs0..hs2, dec4 on hs4;
each up block is a bias-free 2x2x2 stride-2 transpose conv, the
concatenation [up, skip] and Res(2c -> c); a 1x1x1 head with bias.

Routing, as the UNet3D's: a 3x3x3 conv of at most 64 channels in and out
-> ``ops.conv3.conv3x3x3_cf`` (a zero bias), wider ones the library's
conv; a transpose conv with at most 64 channels out -> ``ops.upconv``
(a zero bias) in bf16, else the library's; the head ->
``ops.head.head1x1_cf``; every InstanceNorm, with the LeakyReLU and the
residual add that follow it in a residual block, ->
``ops.instance_norm.instance_norm_act`` (a block is act(IN(conv1(x))),
then act(IN(conv2(.)) + r)); the patch embedding, the 1x1x1 residual
convs, the Linears, the LayerNorms and GELU are plain PyTorch in the
working dtype, but for encoder1's 1 -> 48 residual IN(conv1x1(x)), which
is its closed form on the one input channel, in fp32
(``UnetResBlock._residual``). At 192^3: the 48-channel convs at 192^3 and 96^3 take the
port's kernels, decoder1's 96 -> 48 conv at 192^3 cuDNN. On the CPU every
op runs its plain version. The model draws no dropout masks and holds no
running statistics; ``dtype`` is the compute dtype (bf16 or fp32, bf16
only on CUDA, where the window attention has a bf16 kernel alone);
parameters stay fp32.
"""

from __future__ import annotations

import itertools
from collections.abc import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch.ops import conv3, head, upconv
from multimodal_segmentation_project_tpu_torch.ops.instance_norm import instance_norm_act
from multimodal_segmentation_project_tpu_torch.ops.window_attn import (
    relative_position_index,
    window_attention,
)

FEATURE_SIZE = 48
DEPTHS = (2, 2, 2, 2)
NUM_HEADS = (3, 6, 12, 24)
WINDOW = 7
PATCH = 2
MLP_RATIO = 4
EPS = 1e-5
NEGATIVE_SLOPE = 0.01
DIVISOR = PATCH * 2 ** len(DEPTHS)  # each side a multiple of 32, as MONAI asks


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm | None, dt: torch.dtype) -> torch.Tensor:
    """LayerNorm over the last axis in the working dtype; no affine without ``norm``."""
    if norm is None:
        return F.layer_norm(x, (x.shape[-1],), eps=EPS)
    return F.layer_norm(x, (x.shape[-1],), norm.weight.to(dt), norm.bias.to(dt), EPS)


def _linear(x: torch.Tensor, layer: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x, layer.weight.to(dt), bias)


class _Conv(nn.Module):
    """MONAI's ``Convolution``: the layer under ``.conv``."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        self.conv = conv


def conv3x3x3(x: torch.Tensor, weight: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A bias-free SAME 3x3x3 conv, routed by width."""
    cout, cin = weight.shape[:2]
    if conv3.supported(cin, cout):
        return conv3.conv3x3x3_cf(x, weight.permute(2, 3, 4, 1, 0), weight.new_zeros(cout))
    return F.conv3d(x, weight.to(dt), padding=1)


def up2x(x: torch.Tensor, weight: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A bias-free 2x2x2 stride-2 transpose conv, weight (Cin, Cout, 2, 2, 2),
    routed as the UNet3D's upconvs."""
    cout = weight.shape[1]
    if upconv.runs_op(x, cout):
        return upconv.upconv2x_cf(x, weight.permute(2, 3, 4, 0, 1), weight.new_zeros(cout))
    return F.conv_transpose3d(x, weight.to(dt), stride=2)


class UnetResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _Conv(nn.Conv3d(cin, cout, 3, padding=1, bias=False))
        self.conv2 = _Conv(nn.Conv3d(cout, cout, 3, padding=1, bias=False))
        if cin != cout:
            self.conv3 = _Conv(nn.Conv3d(cin, cout, 1, bias=False))

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        y = instance_norm_act(conv3x3x3(x, self.conv1.conv.weight, dt), slope=NEGATIVE_SLOPE)
        y = conv3x3x3(y, self.conv2.conv.weight, dt)
        r = self._residual(x, dt) if hasattr(self, "conv3") else x
        return instance_norm_act(y, residual=r, slope=NEGATIVE_SLOPE)

    def _residual(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """IN(conv1x1(x)). With one input channel (encoder1) it is the closed
        form IN(w_c x) = w_c (x - mean) / sqrt(w_c^2 var + eps): one centred
        volume scaled per channel, the statistics and the scale in fp32. The
        composition's gradient in w_c is eps-sized, left after IN's backward
        cancels sums over the whole volume, and in bf16 that cancellation
        leaves round-off tens of times the gradient; the closed form's has
        no cancellation."""
        w = self.conv3.conv.weight
        if x.shape[1] != 1:
            return instance_norm_act(F.conv3d(x, w.to(dt)))
        z = x.float()
        z = z - z.mean((2, 3, 4), keepdim=True)
        var = z.square().mean((2, 3, 4), keepdim=True)
        scale = w.view(1, -1, 1, 1, 1) * torch.rsqrt(w.view(1, -1, 1, 1, 1).square() * var + EPS)
        return z.to(dt) * scale.to(dt)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return self.layer(x, dt)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.transp_conv = _Conv(nn.ConvTranspose3d(cin, cout, 2, stride=2, bias=False))
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        up = up2x(x, self.transp_conv.conv.weight, dt)
        return self.conv_block(torch.cat([up, skip], dim=1), dt)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int = WINDOW):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 3, heads))
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, shift: int, dt: torch.dtype) -> torch.Tensor:
        """x (B, D, H, W, C) after LN1 -> the block's attention branch."""
        qkv = _linear(x, self.qkv, dt)
        out = window_attention(qkv, self.qkv.bias, self.relative_position_bias_table,
                               self.relative_position_index, self.heads, self.window, shift)
        return _linear(out, self.proj, dt)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.linear1, dt)), self.linear2, dt)


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, shift: int):
        super().__init__()
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, MLP_RATIO * dim)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        x = x + self.attn(_layer_norm(x, self.norm1, dt), self.shift, dt)
        return x + self.mlp(_layer_norm(x, self.norm2, dt), dt)


class PatchMerging(nn.Module):
    """MONAI's ``PatchMergingV2``."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(8 * dim)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        _, d, h, w, _ = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2, :]
                       for i, j, k in itertools.product(range(2), range(2), range(2))], -1)
        return _linear(_layer_norm(x, self.norm, dt), self.reduction, dt)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int):
        super().__init__()
        self.blocks = nn.ModuleList(SwinTransformerBlock(dim, heads, 0 if i % 2 == 0 else WINDOW // 2)
                                    for i in range(depth))
        self.downsample = PatchMerging(dim)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x, dt)
        return self.downsample(x, dt)


class PatchEmbed(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.proj = nn.Conv3d(cin, dim, PATCH, stride=PATCH)


def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3).contiguous()


class SwinTransformer(nn.Module):
    def __init__(self, cin: int, dim: int, depths: Sequence[int], heads: Sequence[int]):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, dim)
        for i, (depth, h) in enumerate(zip(depths, heads)):
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(dim * 2 ** i, depth, h)]))
        self.num_layers = len(depths)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> list[torch.Tensor]:
        """x (B, Cin, D, H, W) -> [hs0, ..., hs4], channel-first, each through
        ``proj_out`` (LayerNorm over C, no affine)."""
        proj = self.patch_embed.proj
        t = F.conv3d(x, proj.weight.to(dt), proj.bias.to(dt), stride=PATCH)
        t = t.permute(0, 2, 3, 4, 1).contiguous()
        out = [_channels_first(_layer_norm(t, None, dt))]
        for i in range(self.num_layers):
            t = getattr(self, f"layers{i + 1}")[0](t, dt)
            out.append(_channels_first(_layer_norm(t, None, dt)))
        return out


class SwinUNETR(nn.Module):
    """(B, in_channels, D, H, W) -> fp32 logits (B, out_channels, D, H, W),
    each side a multiple of 32. ``generator`` seeds the initialisation:
    truncated-normal (0.02) Linears and bias tables, He-normal convs and
    transpose convs, LeCun-normal head, zero biases, identity LayerNorms."""

    def __init__(self, in_channels: int = 1, out_channels: int = 4,
                 dtype: torch.dtype = torch.bfloat16, generator: torch.Generator | None = None):
        super().__init__()
        fs = FEATURE_SIZE
        self.dtype = dtype
        self.swinViT = SwinTransformer(in_channels, fs, DEPTHS, NUM_HEADS)
        self.encoder1 = UnetrBasicBlock(in_channels, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = _Conv(_Conv(nn.Conv3d(fs, out_channels, 1)))  # MONAI's UnetOutBlock
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-0.04, b=0.04, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, a=-0.04, b=0.04,
                                      generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                k = m.kernel_size[0] * m.kernel_size[1] * m.kernel_size[2]
                fan_in = m.in_channels * (1 if m is self.out.conv.conv else k)
                gain = 1.0 if m is self.out.conv.conv else 2.0
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * (gain / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, x: torch.Tensor, return_features: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits. ``generator`` is taken for the train step's sake and
        unused: the model draws no masks. It has no bottleneck features for
        DANN (``return_features``)."""
        if return_features:
            raise ValueError("SwinUNETR has no bottleneck feature vector: DANN runs on UNet3D")
        if any(s % DIVISOR for s in x.shape[2:]):
            raise ValueError(f"SwinUNETR takes volumes whose sides are multiples of {DIVISOR}, "
                             f"got {tuple(x.shape[2:])}")
        dt = self.dtype
        x = x.to(dt).contiguous()
        hs = self.swinViT(x, dt)
        enc0 = self.encoder1(x, dt)
        enc1 = self.encoder2(hs[0], dt)
        enc2 = self.encoder3(hs[1], dt)
        enc3 = self.encoder4(hs[2], dt)
        dec4 = self.encoder10(hs[4], dt)
        dec3 = self.decoder5(dec4, hs[3], dt)
        dec2 = self.decoder4(dec3, enc3, dt)
        dec1 = self.decoder3(dec2, enc2, dt)
        dec0 = self.decoder2(dec1, enc1, dt)
        out = self.decoder1(dec0, enc0, dt)
        conv = self.out.conv.conv
        return head.head1x1_cf(out, conv.weight[:, :, 0, 0, 0].t(), conv.bias)
