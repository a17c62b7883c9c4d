"""The port's public API against the JAX package's, on the CPU.

* the metrics (``ops/metrics.py``) on seeded numpy logits and labels, with
  a class absent from the target and a batch of 2: within 1e-6 absolute,
  the legacy binary trio exactly;
* the state functions (``engine/state.py``): ``freeze_mask`` per parameter
  through ``engine/interop.py``'s names, ``param_count`` of the JAX model,
  and two AdamW updates from ``make_optimizer`` through ``TrainState``
  against optax's ``make_optimizer`` through the JAX ``TrainState``, with
  gradient accumulation 1 and 2, within 1e-6 of each parameter's largest
  magnitude;
* the exports: each port subpackage's ``__all__`` covers the JAX one's,
  but for what needs several devices.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_segmentation_project_tpu.engine import state as jstate
from multimodal_segmentation_project_tpu.models.unet3d import UNet3D as JaxUNet3D
from multimodal_segmentation_project_tpu.ops import metrics as jmetrics
from multimodal_segmentation_project_tpu_torch.engine import state
from multimodal_segmentation_project_tpu_torch.engine.interop import named_to_tree, tree_leaves
from multimodal_segmentation_project_tpu_torch.models import UNet3D
from multimodal_segmentation_project_tpu_torch.ops import metrics
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

FEATURES = (4, 8)
METRIC_TOL = 1e-6
ADAMW_TOL = 1e-6


def _model() -> UNet3D:
    return UNet3D(features=FEATURES, dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))


def _logits_labels(case: str):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 4, 6, 7, 5)).astype(np.float32)
    labels = rng.integers(0, 3, size=(2, 6, 7, 5)).astype(np.int32)  # class 3 absent
    if case == "one volume all background":
        labels[1] = 0
    return logits, labels


@pytest.mark.parametrize("case", ["class 3 absent", "one volume all background"])
def test_multiclass_metrics_match_jax(case):
    logits, labels = _logits_labels(case)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    for name in ("calculate_dice", "calculate_iou", "calculate_accuracy"):
        want = np.asarray(getattr(jmetrics, name)(jl, jy))
        got = getattr(metrics, name)(tl, ty)
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=METRIC_TOL, err_msg=name)
    for eps in (1e-3,):  # a caller's epsilon reaches the sums
        for name in ("calculate_dice", "calculate_iou"):
            np.testing.assert_allclose(getattr(metrics, name)(tl, ty, epsilon=eps).numpy(),
                                       np.asarray(getattr(jmetrics, name)(jl, jy, epsilon=eps)),
                                       rtol=0, atol=METRIC_TOL, err_msg=f"{name} eps {eps}")
    for name in ("segmentation_metrics", "segmentation_metrics_per_sample"):
        want = getattr(jmetrics, name)(jl, jy)
        got = getattr(metrics, name)(tl, ty)
        assert set(got) == set(want)
        for key in want:
            assert tuple(got[key].shape) == want[key].shape, (name, key)
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                       atol=METRIC_TOL, err_msg=f"{name}[{key}]")
    per_sample = metrics.segmentation_metrics_per_sample(tl, ty)
    if case == "one volume all background":
        assert float(per_sample["dice"][1]) == 0.0  # no foreground class present


def test_binary_metrics_match_jax_exactly():
    """Exact where both sides divide exactly: the voxel count is a power of
    two (XLA divides a mean by multiplying with the rounded reciprocal)."""
    rng = np.random.default_rng(1)
    pred = rng.uniform(size=(2, 1, 4, 8, 8)).astype(np.float32)
    pred[0, 0, 0, 0, :2] = 0.5  # on the threshold: not foreground
    target = (rng.uniform(size=(2, 1, 4, 8, 8)) > 0.6).astype(np.float32)
    for name in ("dice_score", "iou_score", "accuracy_score"):
        want = np.asarray(getattr(jmetrics, name)(jnp.asarray(pred), jnp.asarray(target)))
        got = getattr(metrics, name)(torch.from_numpy(pred), torch.from_numpy(target))
        assert got.dtype == torch.float32
        assert got.numpy() == want, f"{name}: {got.item()} vs {float(want)}"


def _params_tree(model) -> dict:
    return named_to_tree({n: p.detach() for n, p in model.named_parameters()})


@pytest.mark.parametrize("prefixes", [("enc",), ("enc", "bottleneck")])
def test_freeze_mask_matches_jax(prefixes):
    model = _model()
    want = dict(tree_leaves(jstate.freeze_mask(_params_tree(model), prefixes)))
    mask = state.freeze_mask(model, prefixes)
    assert set(mask) == {n for n, _ in model.named_parameters()}
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in mask.values())
    got = dict(tree_leaves(named_to_tree(mask)))
    assert got.keys() == want.keys()
    for path, value in want.items():
        assert float(got[path]) == float(value), path
    assert 0.0 in {float(v) for v in got.values()} and 1.0 in {float(v) for v in got.values()}
    # the state frozen as the trainer freezes it carries the same mask
    built = state.create_train_state(model, 1e-3)
    built.with_mask(prefixes)
    assert dict(tree_leaves(built.trainable_mask())).keys() == want.keys()
    for path, value in tree_leaves(built.trainable_mask()):
        assert float(value) == float(want[path]), path


def test_param_count_matches_jax():
    shapes = jax.eval_shape(JaxUNet3D(features=FEATURES).init, jax.random.key(0),
                            jnp.zeros((1, 1, 8, 8, 8), jnp.float32))
    want = jstate.param_count(shapes["params"])
    assert state.param_count(_model()) == want > 0


@pytest.mark.parametrize("accum", [1, 2])
def test_two_adamw_updates_match_optax(accum):
    """2 * accum steps with distinct seeded gradients: two AdamW updates on
    each side, the port's from make_optimizer through TrainState, the JAX
    package's from optax through its TrainState. The parameters start at
    seeded non-zero values: optax computes AdamW's bias corrections in fp32
    (1 - 0.999 is 1.3e-5 off there), torch in float64, so an update differs
    by up to about 1e-5 of itself, which a zero-initialised bias would read
    as that much of its value."""
    lr, wd = 1e-2, 1e-4
    model = _model()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(2)
    grads = [{n: rng.normal(size=p.shape).astype(np.float32) * 0.1
              for n, p in model.named_parameters()} for _ in range(2 * accum)]
    params = jax.tree.map(jnp.asarray, _params_tree(model))
    tx = jstate.make_optimizer(weight_decay=wd, grad_accum_steps=accum)
    jax_state = jstate.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats={}, opt_state=tx.init(params),
        trainable_mask=jstate.ones_mask(params), lr=jnp.asarray(lr, jnp.float32),
        apply_fn=None, tx=tx)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))

    ts = state.create_train_state(model, lr, weight_decay=wd, grad_accum_steps=accum)
    assert isinstance(ts.optimizer, torch.optim.AdamW)
    group = ts.optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, wd)
    for g in grads:
        jax_state = apply(jax_state, jax.tree.map(jnp.asarray, named_to_tree(g)))
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        ts.apply_gradients()
    assert ts.step == int(jax_state.step) == 2 * accum
    want = dict(tree_leaves(jax.tree.map(np.asarray, jax_state.params)))
    got = dict(tree_leaves(_params_tree(model)))
    start = dict(tree_leaves(named_to_tree(start)))
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[path] - w).max())
        assert err <= ADAMW_TOL * scale, f"{'/'.join(path)}: {err} > {ADAMW_TOL} * {scale}"
        assert not np.array_equal(w, start[path]), f"{'/'.join(path)} did not move"


# the JAX names the port leaves for multi-device work: none (the sharded eval
# step and the mesh package are the port's too)
MULTI_DEVICE: dict = {}
MULTI_DEVICE_PACKAGES: set = set()


def test_exports_cover_the_jax_packages():
    import pkgutil

    import multimodal_segmentation_project_tpu as jpkg
    import multimodal_segmentation_project_tpu_torch as tpkg

    jsubs = {m.name for m in pkgutil.iter_modules(jpkg.__path__) if m.ispkg}
    tsubs = {m.name for m in pkgutil.iter_modules(tpkg.__path__) if m.ispkg}
    assert jsubs - tsubs == MULTI_DEVICE_PACKAGES
    for sub in sorted(jsubs - MULTI_DEVICE_PACKAGES):
        jmod = importlib.import_module(f"{jpkg.__name__}.{sub}")
        tmod = importlib.import_module(f"{tpkg.__name__}.{sub}")
        jall = set(getattr(jmod, "__all__", ()))
        tall = set(getattr(tmod, "__all__", ()))
        assert jall - tall == MULTI_DEVICE.get(sub, set()), sub
        assert all(hasattr(tmod, name) for name in tall), sub
    for name in ("NUM_CLASSES", "CLASS_NAMES", "ORGAN_NAMES"):
        assert getattr(tpkg, name) == getattr(jpkg, name)
