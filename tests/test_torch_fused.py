"""The port's fused training DoubleConv (plain versions, on the CPU) against
the JAX package's fused block composed from its public ops, with the same
weights and the same Dropout3d keep masks.

The JAX side is ``unet3d.py:_fused_boundary_path`` written out with
``conv3x3x3_cf_stats`` and ``conv3x3x3_cf_boundary_stats`` (Pallas,
interpret mode) and ``BatchNormCF(return_affine=True)``; its masks are
the ones the port draws, taken from a clone of the port's generator, since
the two frameworks draw different bits. Dropout is on, with dropped and
kept channels in both masks, so the mask fold into BatchNorm0's affine and
its way back to bn0's gradients are exercised. fp32 throughout: the output,
the input gradient, the running statistics and every parameter gradient
within 2e-5 of max |jax| (the same function, sums in other orders); a conv
bias that feeds a BatchNorm has a true gradient of 0, and both sides must
give less than 1e-5 of the largest gradient there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_segmentation_project_tpu.models.unet3d import BatchNormCF
from multimodal_segmentation_project_tpu.ops import pallas_conv as jconv
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.engine.interop import trees_to_state_dict
from multimodal_segmentation_project_tpu_torch.models import UNet3D
from multimodal_segmentation_project_tpu_torch.models.unet3d import DoubleConv
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

TOL = 2e-5
RATE = 0.5  # high enough that 2 x 8 channels drop some and keep some


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_OPS, 0)


def _close(got, want, tol=TOL, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: max err {err} > {tol} * {scale}"


def _state_dict(params, stats) -> dict:
    """One JAX DoubleConv's (params, batch_stats) -> the port block's state dict."""
    full = trees_to_state_dict({"bottleneck": params, "head_kernel": np.zeros((1, 1)),
                                "head_bias": np.zeros(1)}, {"bottleneck": stats})
    return {k.removeprefix("bottleneck."): v for k, v in full.items()
            if k.startswith("bottleneck.")}


def _jax_block(p, stats, x, m0, m1):
    """The JAX package's fused DoubleConv from its public ops, given masks
    (B, C) already scaled by 1 / keep."""
    bn = BatchNormCF()

    def affine(y, s1, s2, i):
        return bn.apply({"params": p[f"bn{i}"], "batch_stats": stats[f"bn{i}"]}, y, s1, s2,
                        return_affine=True, mutable=["batch_stats"])

    y0, s1, s2 = jconv.conv3x3x3_cf_stats(x, p["conv0"]["kernel"], p["conv0"]["bias"])
    (a0, t0), upd0 = affine(y0, s1, s2, 0)
    y1, s1, s2 = jconv.conv3x3x3_cf_boundary_stats(
        y0, p["conv1"]["kernel"], p["conv1"]["bias"], a0[None] * m0, t0[None] * m0)
    (a1, t1), upd1 = affine(y1, s1, s2, 1)
    z = jnp.maximum(y1 * a1.reshape(1, -1, 1, 1, 1) + t1.reshape(1, -1, 1, 1, 1), 0.0)
    new_stats = {"bn0": upd0["batch_stats"], "bn1": upd1["batch_stats"]}
    return z * m1[:, :, None, None, None], new_stats


def test_fused_doubleconv_with_dropout_matches_the_jax_fused_ops():
    rng = np.random.default_rng(0)
    cin, feats, shape = 4, 8, (2, 4, 8, 8)
    x = rng.normal(size=(shape[0], cin) + shape[1:]).astype(np.float32)
    g = rng.normal(size=(shape[0], feats) + shape[1:]).astype(np.float32)
    params, stats = {}, {}
    for i, c in ((0, cin), (1, feats)):
        params[f"conv{i}"] = {
            "kernel": (rng.normal(size=(3, 3, 3, c, feats)) * (2 / (27 * c)) ** 0.5
                       ).astype(np.float32),
            "bias": rng.normal(0, 0.1, feats).astype(np.float32)}
        params[f"bn{i}"] = {"scale": rng.uniform(0.5, 1.5, feats).astype(np.float32),
                            "bias": rng.normal(0, 0.3, feats).astype(np.float32)}
        stats[f"bn{i}"] = {"mean": rng.normal(0, 0.1, feats).astype(np.float32),
                           "var": rng.uniform(0.5, 1.5, feats).astype(np.float32)}

    block = DoubleConv(cin, feats, dropout_rate=RATE)
    block.load_state_dict(_state_dict(params, stats))
    block.train()
    assert block.fused()
    gen = torch.Generator().manual_seed(5)
    clone = torch.Generator()
    clone.set_state(gen.get_state())
    masks = [((torch.rand((shape[0], feats), generator=clone) < 1 - RATE).float() / (1 - RATE))
             .numpy() for _ in range(2)]
    for m in masks:
        assert (m == 0).any() and (m > 0).any()

    xt = torch.from_numpy(x).requires_grad_(True)
    got = block(xt, torch.float32, gen)
    got.backward(torch.from_numpy(g))

    def run(p, xx):
        return _jax_block(p, stats, xx, *map(jnp.asarray, masks))

    (want, new_stats), pullback = jax.vjp(run, params, jnp.asarray(x))
    zero_stats = jax.tree_util.tree_map(jnp.zeros_like, new_stats)
    gp, gx = pullback((jnp.asarray(g), zero_stats))

    _close(got.detach(), want, name="y")
    _close(xt.grad, gx, name="dx")
    want_sd = _state_dict(jax.tree_util.tree_map(np.array, gp),
                          jax.tree_util.tree_map(np.array, new_stats))
    for k, v in block.state_dict().items():
        if "running" in k:
            _close(v, want_sd[k], name=k)
    grads = {n: p.grad.numpy() for n, p in block.named_parameters()}
    largest = max(float(np.abs(want_sd[n].numpy()).max()) for n in grads)
    for n, got_g in grads.items():
        want_g = want_sd[n].numpy()
        if n.endswith(("double_conv.0.bias", "double_conv.4.bias")):  # BN-fed: true 0
            for side in (got_g, want_g):
                assert float(np.abs(side).max()) < 1e-5 * largest, n
        else:
            _close(got_g, want_g, name=n)


def test_train_mode_routes_blocks_by_the_width_of_both_convs():
    """At the default widths enc0-enc2, dec2 and dec3 take the fused path;
    enc3, the bottleneck, dec0 and dec1 (its conv0 is 128 -> 64) do not."""
    model = UNet3D(features=(16, 32, 64, 128))
    fused = [b.fused() for b in (*model.encoder, model.bottleneck, *model.decoder)]
    assert fused == [True, True, True, False, False, False, False, True, True]
