"""The plain reference of SwinUNETR for the CPU tests: fp32 PyTorch, no kernels.

Written from MONAI's ``monai.networks.nets.SwinUNETR`` (with its
``SwinTransformer``, ``BasicLayer``, ``SwinTransformerBlock``,
``WindowAttention``, ``compute_mask``, ``get_window_size``,
``window_partition``/``window_reverse``, ``PatchMergingV2``,
``UnetrBasicBlock``, ``UnetrUpBlock``, ``UnetResBlock`` and
``UnetOutBlock``) at its published defaults: feature size 48, patch 2,
window 7, depths (2, 2, 2, 2), heads (3, 6, 12, 24), MLP ratio 4, qkv bias,
no dropout, instance norm, ``normalize=True``. The attention is MONAI's
composition: the LayerNorm's output padded with zeros, rolled, cut into
windows, the qkv Linear on every token of a window (the padded ones'
qkv is the bias), q scaled, q k^T, the table's bias through
``relative_position_index[:n, :n]``, the mask of ``compute_mask`` where the
block is shifted, softmax, times v, the output Linear, put back, rolled back
and cropped. It reads the weights by MONAI's state-dict names and imports
nothing of the port.

Departures, each stated where it is made: patch merging in
``PatchMergingV2``'s order (MONAI's default ``"merging"`` keeps v0.9's slice
order for old checkpoints); InstanceNorm written out (mean and biased
variance per sample and channel, eps 1e-5), which also normalises a 1^3
volume to 0 where ``nn.InstanceNorm3d`` refuses one in training.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

WINDOW = 7
EPS = 1e-5
SLOPE = 0.01
HEADS = (3, 6, 12, 24)


def window_size(size, window=WINDOW, shift=WINDOW // 2):
    """MONAI's ``get_window_size``."""
    win, sft = list((window,) * 3), list((shift,) * 3)
    for i, s in enumerate(size):
        if s <= window:
            win[i], sft[i] = s, 0
    return tuple(win), tuple(sft)


def window_partition(x, win):
    b, d, h, w, c = x.shape
    x = x.view(b, d // win[0], win[0], h // win[1], win[1], w // win[2], win[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, win[0] * win[1] * win[2], c)


def window_reverse(windows, win, dims):
    b, d, h, w = dims
    x = windows.view(b, d // win[0], h // win[1], w // win[2], win[0], win[1], win[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def compute_mask(dims, win, sft, device, dtype=torch.float32):
    """MONAI's ``compute_mask``: region ids by its slices, -100 between regions."""
    img = torch.zeros((1, *dims, 1), device=device, dtype=dtype)
    cnt = 0
    for d in (slice(-win[0]), slice(-win[0], -sft[0]), slice(-sft[0], None)):
        for h in (slice(-win[1]), slice(-win[1], -sft[1]), slice(-sft[1], None)):
            for w in (slice(-win[2]), slice(-win[2], -sft[2]), slice(-sft[2], None)):
                img[:, d, h, w, :] = cnt
                cnt += 1
    ids = window_partition(img, win).squeeze(-1)
    mask = ids.unsqueeze(1) - ids.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def relative_position_index(window=WINDOW):
    coords = torch.stack(torch.meshgrid(*[torch.arange(window)] * 3, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel += window - 1
    rel[:, :, 0] *= (2 * window - 1) ** 2
    rel[:, :, 1] *= 2 * window - 1
    return rel.sum(-1)


def instance_norm(x):
    mean = x.mean((2, 3, 4), keepdim=True)
    var = (x - mean).square().mean((2, 3, 4), keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS)


class SwinUNETRReference:
    """SwinUNETR on ``weights`` (MONAI's names) in ``dtype`` (fp32, or fp64
    where a test wants the exact function): ``params`` are leaves of that
    dtype that take gradients."""

    def __init__(self, weights: dict, dtype: torch.dtype = torch.float32):
        self.dtype = dtype
        self.params = {k: v.detach().clone().to(dtype).requires_grad_(True)
                       for k, v in weights.items()}
        self.index = relative_position_index()

    def _p(self, name):
        return self.params[name]

    def _linear(self, x, name, bias=True):
        return F.linear(x, self._p(f"{name}.weight"), self._p(f"{name}.bias") if bias else None)

    def _ln(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self._p(f"{name}.weight"), self._p(f"{name}.bias"),
                            EPS)

    def _attention(self, x, name, heads, mask):
        b, n, c = x.shape
        qkv = self._linear(x, f"{name}.qkv").reshape(b, n, 3, heads, c // heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = (q * (c // heads) ** -0.5) @ k.transpose(-2, -1)
        table = self._p(f"{name}.relative_position_bias_table")
        bias = table[self.index.to(x.device)[:n, :n].reshape(-1)].reshape(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.view(b // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0))
            attn = attn.view(-1, heads, n, n)
        x = (attn.softmax(-1) @ v).transpose(1, 2).reshape(b, n, c)
        return self._linear(x, f"{name}.proj")

    def _block(self, x, name, heads, shift, mask):
        b, d, h, w, c = x.shape
        win, sft = window_size((d, h, w), shift=shift)
        y = self._ln(x, f"{name}.norm1")
        pads = [(win[i] - s % win[i]) % win[i] for i, s in enumerate((d, h, w))]
        y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        dims = (b, *y.shape[1:4])
        shifted = any(s > 0 for s in sft)
        if shifted:
            y = torch.roll(y, tuple(-s for s in sft), (1, 2, 3))
        y = self._attention(window_partition(y, win), f"{name}.attn", heads,
                            mask if shifted else None)
        y = window_reverse(y.view(-1, *win, c), win, dims)
        if shifted:
            y = torch.roll(y, sft, (1, 2, 3))
        x = x + y[:, :d, :h, :w].contiguous()
        z = self._ln(x, f"{name}.norm2")
        z = self._linear(F.gelu(self._linear(z, f"{name}.mlp.linear1")), f"{name}.mlp.linear2")
        return x + z

    def _merge(self, x, name):
        _, d, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        # PatchMergingV2's order (departure from MONAI's default "merging")
        x = torch.cat([x[:, i::2, j::2, k::2, :]
                       for i, j, k in itertools.product(range(2), range(2), range(2))], -1)
        return self._linear(self._ln(x, f"{name}.norm"), f"{name}.reduction", bias=False)

    def _layer(self, x, i):
        """BasicLayer ``layers{i+1}``: x (B, C, D, H, W) -> (B, 2C, D/2, H/2, W/2)."""
        name = f"swinViT.layers{i + 1}.0"
        b, c, d, h, w = x.shape
        win, sft = window_size((d, h, w))
        dims = [-(-s // ws) * ws for s, ws in zip((d, h, w), win)]
        mask = compute_mask(dims, win, sft, x.device, x.dtype)
        x = x.permute(0, 2, 3, 4, 1)
        for j in range(2):
            x = self._block(x, f"{name}.blocks.{j}", HEADS[i], 0 if j % 2 == 0 else WINDOW // 2,
                            mask)
        return self._merge(x.reshape(b, d, h, w, -1), f"{name}.downsample").permute(0, 4, 1, 2, 3)

    @staticmethod
    def _proj_out(x):
        x = x.permute(0, 2, 3, 4, 1)
        return F.layer_norm(x, (x.shape[-1],), eps=EPS).permute(0, 4, 1, 2, 3)

    def _res(self, x, name):
        y = F.conv3d(x, self._p(f"{name}.conv1.conv.weight"), padding=1)
        y = F.leaky_relu(instance_norm(y), SLOPE)
        y = instance_norm(F.conv3d(y, self._p(f"{name}.conv2.conv.weight"), padding=1))
        if f"{name}.conv3.conv.weight" in self.params:
            x = instance_norm(F.conv3d(x, self._p(f"{name}.conv3.conv.weight")))
        return F.leaky_relu(y + x, SLOPE)

    def _up(self, x, skip, name):
        up = F.conv_transpose3d(x, self._p(f"{name}.transp_conv.conv.weight"), stride=2)
        return self._res(torch.cat([up, skip], 1), f"{name}.conv_block")

    def forward(self, x):
        """Logits (B, 4, D, H, W) in the reference's dtype."""
        x = x.to(self.dtype)
        t = F.conv3d(x, self._p("swinViT.patch_embed.proj.weight"),
                     self._p("swinViT.patch_embed.proj.bias"), stride=2)
        hs = [self._proj_out(t)]
        for i in range(4):
            t = self._layer(t, i)
            hs.append(self._proj_out(t))
        enc0 = self._res(x, "encoder1.layer")
        enc1 = self._res(hs[0], "encoder2.layer")
        enc2 = self._res(hs[1], "encoder3.layer")
        enc3 = self._res(hs[2], "encoder4.layer")
        dec4 = self._res(hs[4], "encoder10.layer")
        dec3 = self._up(dec4, hs[3], "decoder5")
        dec2 = self._up(dec3, enc3, "decoder4")
        dec1 = self._up(dec2, enc2, "decoder3")
        dec0 = self._up(dec1, enc1, "decoder2")
        out = self._up(dec0, enc0, "decoder1")
        return F.conv3d(out, self._p("out.conv.conv.weight"), self._p("out.conv.conv.bias"))
