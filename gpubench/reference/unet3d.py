"""The plain reference of the UNet3D recipes: fp32 PyTorch, no kernels.

Written from the published layer equations of the reference repository's
UNet3D (``fransiskusbudi/multimodal_segmentation_project``), with the
conventions of the JAX package that the port follows:

* DoubleConv = [Conv3d 3x3x3 SAME -> BatchNorm3d -> ReLU -> Dropout3d] x 2;
  four encoder levels with 2x max pooling, a bottleneck twice the last
  width, four 2x2x2 stride-2 transpose convs each followed by a DoubleConv
  on [skip, up], a 1x1x1 head;
* train-mode BatchNorm takes the batch's biased variance, and the running
  statistics update as flax's, momentum 0.9 on the old value;
* Dropout3d draws one keep mask per (batch, channel) as
  ``torch.rand((B, C), generator) < 1 - rate`` on the step generator's
  device, block by block, conv0's mask before conv1's;
* the eval forward applies BatchNorm with its running statistics;
* the loss ``ce_tversky`` is 0.3 CE + 0.7 Tversky(alpha = beta = 0.5) over
  the foreground classes, every sum global over the batch and the volume.

It imports nothing of the program. ``precision`` is "fp32" (the reference,
TF32 off) or "fp8", the control: every conv's, transpose conv's and the
head's input and weight rounded to float8 e4m3 and the gradient of its
output to e5m2, each with a per-tensor scale, as fp8 training computes,
with fp32 sums.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS_BN = 1e-5
MOMENTUM = 0.9


@contextlib.contextmanager
def full_fp32():
    """cuDNN and cuBLAS without TF32 (the reference's precision)."""
    c, m = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (c.allow_tf32, m.allow_tf32)
    c.allow_tf32, m.allow_tf32 = False, False
    try:
        yield
    finally:
        c.allow_tf32, m.allow_tf32 = old


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    amax = t.detach().abs().max().float()
    if not torch.isfinite(amax) or amax == 0:
        return t
    scale = torch.finfo(dtype).max / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _QuantIn(torch.autograd.Function):
    """Forward: e4m3 rounding. Backward: the cotangent as it comes."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _QuantGrad(torch.autograd.Function):
    """Forward: identity. Backward: e5m2 rounding of the cotangent."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def _op(fn, x, w, b, precision, **kw):
    if precision == "fp32":
        return fn(x, w, b, **kw)
    return _QuantGrad.apply(fn(_QuantIn.apply(x), _QuantIn.apply(w), b, **kw))


class Reference:
    """The UNet3D on ``weights`` (the reference layout's names): ``params``
    are fp32 leaves that take gradients, ``stats`` the BatchNorm running
    statistics."""

    def __init__(self, weights: dict, features, dropout_rate: float, precision: str = "fp32"):
        self.features = tuple(features)
        self.rate = dropout_rate
        self.precision = precision
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in weights.items() if not k.endswith(("running_mean",
                                                                       "running_var"))}
        self.stats = {k: v.detach().clone().float() for k, v in weights.items()
                      if k.endswith(("running_mean", "running_var"))}

    # ---- layers ----

    def _conv(self, x, name):
        return _op(F.conv3d, x, self.params[f"{name}.weight"], self.params[f"{name}.bias"],
                   self.precision, padding=1)

    def _bn(self, y, name, train):
        w, b = self.params[f"{name}.weight"], self.params[f"{name}.bias"]
        rm, rv = self.stats[f"{name}.running_mean"], self.stats[f"{name}.running_var"]
        if train:
            dims = (0, 2, 3, 4)
            mean = y.mean(dims)
            var = (y - mean.view(1, -1, 1, 1, 1)).square().mean(dims)
            with torch.no_grad():
                rm.mul_(MOMENTUM).add_((1 - MOMENTUM) * mean)
                rv.mul_(MOMENTUM).add_((1 - MOMENTUM) * var)
        else:
            mean, var = rm, rv
        return ((y - mean.view(1, -1, 1, 1, 1)) * torch.rsqrt(var + EPS_BN).view(1, -1, 1, 1, 1)
                * w.view(1, -1, 1, 1, 1) + b.view(1, -1, 1, 1, 1))

    def _dropout(self, z, gen):
        keep = torch.rand(z.shape[:2], generator=gen, device=gen.device) < 1.0 - self.rate
        return z * keep.to(z.device)[:, :, None, None, None].float() / (1.0 - self.rate)

    def _block(self, x, prefix, train, gen):
        for conv, bn in ((0, 1), (4, 5)):
            z = torch.relu(self._bn(self._conv(x, f"{prefix}.double_conv.{conv}"),
                                    f"{prefix}.double_conv.{bn}", train))
            x = self._dropout(z, gen) if train and self.rate > 0 else z
        return x

    def forward(self, x, train: bool, gen=None, return_features: bool = False):
        """fp32 logits (B, classes, D, H, W); in train mode the dropout masks
        come from ``gen``; with ``return_features`` also the bottleneck's
        global average (B, 2 * features[-1])."""
        x = x.float()
        skips = []
        for i in range(len(self.features)):
            x = self._block(x, f"encoder.{i}", train, gen)
            skips.append(x)
            x = F.max_pool3d(x, 2)
        x = self._block(x, "bottleneck", train, gen)
        feat = x.mean(dim=(2, 3, 4))
        for i, skip in enumerate(reversed(skips)):
            x = _op(F.conv_transpose3d, x, self.params[f"upconvs.{i}.weight"],
                    self.params[f"upconvs.{i}.bias"], self.precision, stride=2)
            x = self._block(torch.cat([skip, x], dim=1), f"decoder.{i}", train, gen)
        logits = _op(F.conv3d, x, self.params["final_conv.weight"],
                     self.params["final_conv.bias"], self.precision)
        return (logits, feat) if return_features else logits


def ce_tversky(logits, labels, alpha=0.5, beta=0.5, eps=1e-6):
    """0.3 mean CE + 0.7 mean over foreground classes of 1 - Tversky."""
    logits = logits.float()
    labels = labels.long()
    ce = -torch.log_softmax(logits, 1).gather(1, labels[:, None]).mean()
    p = torch.softmax(logits, 1)
    losses = []
    for c in range(1, logits.shape[1]):
        pc, tc = p[:, c], (labels == c).float()
        tp = (pc * tc).sum()
        fp, fn = pc.sum() - tp, tc.sum() - tp
        losses.append(1.0 - (tp + eps) / (tp + alpha * fp + beta * fn + eps))
    return 0.3 * ce + 0.7 * torch.stack(losses).mean()


def cross_entropy(logits, labels):
    return -torch.log_softmax(logits.float(), 1).gather(1, labels.long()[:, None]).mean()

