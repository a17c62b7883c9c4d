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
  ``ops.conv3_fused`` (the fused block, in bf16 or fp32);
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
passed to :meth:`UNet3D.forward`, in the same order on both paths (or takes
it from a :class:`MaskSource` passed in its place, which a CUDA graph of the
train step replays from masks drawn ahead by the host). A 192^3
train step at default widths launches 5 conv+stats, 5 boundary conv+stats,
1 conv forward (dec1's conv1), 5 dx, 5 dx-epilogue, 6 dW, 5 prologue dW, 4
pool forward, 4 pool backward, 3 upconv, 1 head, 1 head-dx and 1
head-weight-gradient kernel on a GPU. In fp32 the same blocks take the
same paths, on the fp32 instances of the same kernels (as the JAX package
runs its fused block on one device in either dtype; it runs the per-conv
chain everywhere only under a data mesh), except the upconvs: 5
conv+stats, 5 boundary conv+stats, 1 conv, 5 dx, 5 dx-epilogue, 6 dW, 5
prologue dW, 4 pool forward and 4 pool backward, 1 head, 1 head-dx and 1
head-weight-gradient launch, and the library's 7 convs and 4 transpose
convs forward.

On a multi-device mesh (``parallel/mesh.py``, one process per GPU) each
rank runs its shard of the global batch, as the JAX package's model runs
under its mesh: every DoubleConv takes the per-conv chain (the fused block
is single-device, ``unet3d.py:_fused_boundary_path``); its BatchNorm takes
the global batch's statistics (fp32 sums of y and y^2 all-reduced over the
mesh, over the global count); under a spatial axis every 3x3x3 conv, the
kernels' and the deep region's, in train and eval, runs on this rank's
haloed slab of D (``ops/halo.py``); the Dropout3d masks are drawn for the
global batch from the step's generator, the same on every rank, and each
rank takes its rows; the bottleneck's feature mean is the slabs' sums
all-reduced over the spatial group. Pools, upconvs and the head stay on
their kernels, on each rank's slab. A mesh of one device, or none, is the
single-device path.

On the CPU the same ops run their plain versions. ``dtype`` is the compute
dtype (bf16 or fp32); parameters stay fp32.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch.ops import conv3, conv3_fused, head, pool, upconv
from multimodal_segmentation_project_tpu_torch.ops.halo import halo_conv3
from multimodal_segmentation_project_tpu_torch.parallel.mesh import (
    SPATIAL_AXIS,
    active_multi_mesh,
    active_spatial_mesh,
    data_rows,
    reduce_count,
    reduce_sum,
)


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
    statistics in place with flax's momentum and the biased variance. On a
    multi-device mesh the statistics are the global batch's: fp32 sums of y
    and y^2, all-reduced over the mesh in one buffer, over the global count
    (sync BatchNorm, as the JAX package's BatchNorm of a sharded batch)."""
    yf = y.float()
    dims = (0, 2, 3, 4)
    if active_multi_mesh() is None:
        mean = yf.mean(dims)
        var = torch.clamp(yf.square().mean(dims) - mean.square(), min=0.0)
    else:
        n = reduce_count(yf.numel() // yf.shape[1])
        s1, s2 = reduce_sum(torch.stack([yf.sum(dims), yf.square().sum(dims)]))
        mean = s1 / n
        var = torch.clamp(s2 / n - mean.square(), min=0.0)
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


def _draw_keep(shape: tuple[int, ...], rate: float,
               generator: torch.Generator | None) -> torch.Tensor:
    """A keep mask of ``shape`` drawn on the generator's device (the CPU's
    default generator for None)."""
    dev = generator.device if generator is not None else torch.device("cpu")
    return torch.rand(shape, generator=generator, device=dev) < 1.0 - rate


def _keep_mask(shape: tuple[int, int], rate: float, generator, device: torch.device,
               rows=None) -> torch.Tensor:
    """Dropout3d's keep mask per (batch, channel), drawn on the generator's
    device and moved to ``device``; with ``rows``, the mask of the global
    rows ``shape[0]`` is drawn and those rows are taken (every rank draws
    the same mask from the step's generator). A :class:`MaskSource` in the
    generator's place hands the mask out."""
    if isinstance(generator, MaskSource):
        return generator.keep(shape, rate, device, rows)
    mask = _draw_keep(shape, rate, generator)
    if rows is not None:
        mask = mask[rows]
    return mask.to(device, non_blocking=True)


class MaskSource:
    """A train-mode forward's Dropout keep masks, passed in place of its
    ``generator``.

    ``MaskSource(generator)`` draws each mask inline, exactly as
    ``generator`` itself would, and notes its (shape, rate) in ``plan``: the
    sequence one forward asks for. ``MaskSource(buffer=..., plan=...)`` hands
    the plan's masks out as views of ``buffer``, a flat bool tensor on the
    forward's device that :func:`draw_masks` filled ahead from the same
    generator: the same masks, with no draw and no host copy inside the
    forward, so that a CUDA graph can capture it."""

    def __init__(self, generator: torch.Generator | None = None,
                 buffer: torch.Tensor | None = None, plan: list | None = None):
        self.generator, self.buffer = generator, buffer
        self.plan = [] if plan is None else plan
        self._next = self._offset = 0

    def keep(self, shape, rate: float, device: torch.device, rows=None) -> torch.Tensor:
        shape = tuple(shape)
        if self.buffer is None:
            self.plan.append((shape, rate))
            return _keep_mask(shape, rate, self.generator, device, rows)
        if self._next == len(self.plan) or self.plan[self._next] != (shape, rate):
            raise RuntimeError(f"the forward asks for mask {self._next} of shape {shape} at rate "
                               f"{rate}; the masks drawn ahead follow the plan {self.plan}")
        n = math.prod(shape)
        mask = self.buffer[self._offset:self._offset + n].view(shape)
        self._next += 1
        self._offset += n
        return mask if rows is None else mask[rows]

    def exhausted(self) -> bool:
        """Whether the forward took every mask of the plan."""
        return self._next == len(self.plan)


def draw_masks(plan: list, generator: torch.Generator | None) -> torch.Tensor:
    """The plan's keep masks drawn from ``generator`` in its order, flat:
    what a forward given ``generator`` would draw inline."""
    return torch.cat([_draw_keep(shape, rate, generator).reshape(-1) for shape, rate in plan]
                     or [torch.zeros(0, dtype=torch.bool)])


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
    n_rows, rows = data_rows(z.shape[0])
    mask = _keep_mask((n_rows, z.shape[1]), rate, generator, z.device,
                      rows)[:, :, None, None, None]
    return torch.where(mask, z / (1.0 - rate), torch.zeros((), dtype=z.dtype, device=z.device))


def _library_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The deep region's SAME conv, w (Cout, Cin, 3, 3, 3) in x's dtype."""
    return F.conv3d(x, w, b, padding=1)


def _library_conv_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.relu(F.conv3d(x, w, b, padding=1))


def _conv(conv_fn, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``conv_fn(x, w, b)``, on a haloed slab of the volume's D axis under a
    spatial mesh (``ops/halo.py``), as the JAX package runs every conv there
    in a halo-exchange island."""
    mesh = active_spatial_mesh()
    return conv_fn(x, w, b) if mesh is None else halo_conv3(conv_fn, x, w, b, mesh)


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
                x = _conv(conv3.conv3x3x3_cf_relu, x, w, b)
            else:  # deep region
                x = _conv(_library_conv_relu, x, w.permute(4, 3, 0, 1, 2).to(dtype), b.to(dtype))
        return x.contiguous()  # a haloed slab's interior is a view

    def fused(self) -> bool:
        """Whether the train-mode forward takes the fused path: both convs
        on the kernels, in either dtype, on any device, and no multi-device
        mesh (the JAX package's fused block is single-device only,
        ``unet3d.py:_fused_boundary_path``)."""
        c0, c1 = self.double_conv[0], self.double_conv[4]
        return (conv3.supported(c0.in_channels, c0.out_channels)
                and conv3.supported(c1.in_channels, c1.out_channels)
                and active_multi_mesh() is None)

    def forward_train(self, x: torch.Tensor, dtype: torch.dtype,
                      generator: torch.Generator | None = None) -> torch.Tensor:
        if self.fused():
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
                y = _conv(conv3.conv3x3x3_cf, x, conv.weight.permute(2, 3, 4, 1, 0), conv.bias)
            else:  # deep region
                y = _conv(_library_conv, x, conv.weight.to(dtype), conv.bias.to(dtype))
            z = torch.relu(batch_norm_train(y, bn))
            x = dropout3d(z, self.double_conv[di].p, generator).to(dtype)
        return x

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if self.training:
            return self.forward_train(x, dtype, generator)
        return self.forward_eval(x, dtype)


def _global_average(x: torch.Tensor) -> torch.Tensor:
    """(B, C) fp32 mean over (D, H, W); under a spatial mesh the slabs' sums
    all-reduced over the spatial group, over the volume's voxel count."""
    if active_spatial_mesh() is None:
        return x.float().mean(dim=(2, 3, 4))
    voxels = reduce_count(x[0, 0].numel(), SPATIAL_AXIS)
    return reduce_sum(x.float().sum(dim=(2, 3, 4)), SPATIAL_AXIS) / voxels


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
        Dropout3d masks (a :class:`MaskSource` in its place hands them
        out)."""
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
        feat = _global_average(x) if return_features else None

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
