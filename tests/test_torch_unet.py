"""The port's UNet3D eval forward against the JAX package's UNet3D, with the
same weights carried across by ``engine.interop.trees_to_state_dict``.

Tolerance: max |port - jax| <= 2e-5 * max |jax| on fp32 logits. The two
stacks differ by summation order and by where the eval BatchNorm is folded
(the port folds every conv; the JAX package applies flax BatchNorm unfolded
in its XLA convs), which moves fp32 results by rounding only.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_segmentation_project_tpu.engine.interop import torch_state_dict_to_trees
from multimodal_segmentation_project_tpu.models import UNet3D as JaxUNet3D
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.engine.interop import trees_to_state_dict
from multimodal_segmentation_project_tpu_torch.models import UNet3D

FEATURES = (4, 8)
TOL = 2e-5


def _numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jax.device_get(tree))


@functools.cache
def _jitted_init():
    """One compiled init for every test: the param tree depends on neither
    conv_impl nor the volume size (eager init compiles op by op, ~30 s)."""
    model = JaxUNet3D(out_channels=4, features=FEATURES, dropout_rate=0.1,
                      dtype=jnp.float32, conv_impl="xla")
    return jax.jit(model.init)


def _jax_weights(conv_impl, seed=0):
    """Initialised JAX UNet3D, with its BatchNorm made non-trivial so that
    folding it is tested: scale, bias, running mean and variance drawn
    from a seeded numpy generator."""
    model = JaxUNet3D(out_channels=4, features=FEATURES, dropout_rate=0.1,
                      dtype=jnp.float32, conv_impl=conv_impl)
    variables = _jitted_init()(jax.random.key(seed), jnp.zeros((1, 1, 8, 8, 8)))
    params = _numpy_tree(variables["params"])
    stats = _numpy_tree(variables["batch_stats"])
    rng = np.random.default_rng(seed)

    def perturb(tree, leaf_fn):
        return {k: perturb(v, leaf_fn) if isinstance(v, dict) else leaf_fn(k, v)
                for k, v in tree.items()}

    def bn_params(tree):
        out = {}
        for k, v in tree.items():
            if k.startswith("bn"):
                out[k] = {"scale": np.abs(rng.normal(1.0, 0.2, v["scale"].shape)).astype(np.float32),
                          "bias": rng.normal(0, 0.1, v["bias"].shape).astype(np.float32)}
            elif isinstance(v, dict):
                out[k] = bn_params(v)
            else:
                out[k] = v
        return out

    params = bn_params(params)
    stats = perturb(stats, lambda k, v: (
        rng.normal(0, 0.1, v.shape) if k == "mean" else rng.uniform(0.5, 1.5, v.shape)
    ).astype(np.float32))
    return model, params, stats


def _port(params, stats):
    model = UNet3D(in_channels=1, out_channels=4, features=FEATURES, dropout_rate=0.1,
                   dtype=torch.float32)
    model.load_state_dict(trees_to_state_dict(params, stats), strict=True)
    return model.eval()


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=TOL, rtol=0)


@pytest.mark.parametrize("conv_impl,size", [("xla", 18), ("pallas", 16)])
def test_eval_logits_match_jax(conv_impl, size):
    """16^3 through the JAX Pallas kernels (interpret mode); 18^3 through
    XLA, where the odd 9^3 level makes the decoder's trilinear resize
    guard fire."""
    jmodel, params, stats = _jax_weights(conv_impl)
    x = np.random.default_rng(1).normal(size=(1, 1, size, size, size)).astype(np.float32)
    want = jmodel.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = _port(params, stats)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)
    assert sum(ops.launch_counts().values()) == 0  # the CPU runs the plain versions


def test_return_features_match_jax():
    jmodel, params, stats = _jax_weights("xla", seed=3)
    x = np.random.default_rng(2).normal(size=(2, 1, 16, 16, 16)).astype(np.float32)
    want_logits, want_feat = jmodel.apply({"params": params, "batch_stats": stats},
                                          jnp.asarray(x), train=False, return_features=True)
    with torch.inference_mode():
        logits, feat = _port(params, stats)(torch.from_numpy(x), return_features=True)
    assert feat.shape == (2, 2 * FEATURES[-1]) and feat.dtype == torch.float32
    _close(feat.numpy(), want_feat)
    _close(logits.numpy(), want_logits)


def test_trees_state_dict_round_trip_is_exact():
    _, params, stats = _jax_weights("xla", seed=5)
    sd = trees_to_state_dict(params, stats)
    # the reference layout: every key of the port's module, nothing else
    assert set(sd) == set(UNet3D(features=FEATURES).state_dict())
    back_p, back_s = torch_state_dict_to_trees(sd, num_levels=len(FEATURES))
    for want, got in ((params, back_p), (stats, back_s)):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, a), (_, b) in zip(flat_w, flat_g):
            assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_train_mode_forward_matches_jax():
    """Train mode, dropout 0, at 18^3 through XLA (the resize guard fires):
    logits, bottleneck features and the updated BatchNorm running
    statistics (flax's momentum and biased variance)."""
    _, params, stats = _jax_weights("xla", seed=7)
    jmodel = JaxUNet3D(out_channels=4, features=FEATURES, dropout_rate=0.0, dtype=jnp.float32,
                       conv_impl="xla")
    x = np.random.default_rng(8).normal(size=(2, 1, 18, 18, 18)).astype(np.float32)
    (want, want_feat), upd = jmodel.apply({"params": params, "batch_stats": stats},
                                          jnp.asarray(x), train=True, return_features=True,
                                          mutable=["batch_stats"])
    model = UNet3D(in_channels=1, out_channels=4, features=FEATURES, dropout_rate=0.0,
                   dtype=torch.float32)
    model.load_state_dict(trees_to_state_dict(params, stats), strict=True)
    model.train()
    ops.reset_launch_counts()
    with torch.no_grad():
        logits, feat = model(torch.from_numpy(x), return_features=True)
    assert sum(ops.launch_counts().values()) == 0
    _close(logits.numpy(), want)
    _close(feat.numpy(), want_feat)
    want_sd = trees_to_state_dict(params, _numpy_tree(upd["batch_stats"]))
    for name, value in model.state_dict().items():
        if "running" in name:
            _close(value.numpy(), want_sd[name].numpy())
