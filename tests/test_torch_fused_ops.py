"""The fused DoubleConv's ops of the port (plain versions, on the CPU)
against the JAX package's Pallas ops in interpret mode, as the JAX
package's own tests run them, on the same numpy inputs.

* fp32: forward and the full VJP (cotangents on y, s1 and s2; the gradients
  of x, w, b, a and t) of ``conv3x3x3_cf_stats``,
  ``conv3x3x3_cf_boundary_stats`` and ``conv3x3x3_cf_boundary``, each
  within 2e-5 of max |jax| of the compared array (the same fp32 products
  summed in other orders). The boundary ops run non-square (Cin != Cout,
  both ways) with t > 0 on some channels, so a prologue that leaked into
  the SAME halo (relu(t) != 0) or swapped the dx epilogue's channels would
  show.
* bf16, one forward per op: y within one bf16 ulp per element of JAX's
  (both round once from fp32 sums taken in other orders); the boundary
  op's y, rounded twice (the cast, then the bias in bf16), within one ulp
  of the fp32 conv plus one of the output; s1 and s2 within the sum of
  |y - y_jax| (resp. |y^2 - y_jax^2|) over the elements plus 1e-5 of
  sum |y| (resp. sum y^2): what one-ulp differences in y can move, plus
  fp32 sum-order noise.
On the CPU no kernel launches: every launch counter stays 0.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_segmentation_project_tpu.ops import pallas_conv as jconv
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.ops import conv3, conv3_fused
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

TOL = 2e-5


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


def _ulp(m):
    return np.ldexp(np.ones_like(m), np.frexp(m)[1] - 8)


def _bf16(a):
    """numpy fp32 -> bf16-valued fp32, so both frameworks start from the same values."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _inputs(seed, shape, cout, boundary):
    """x, w, b and, for the boundary ops, a, t with t > 0 on the even
    channels and < 0 on the odd ones."""
    rng = np.random.default_rng(seed)
    bsz, cin = shape[:2]
    args = [rng.normal(size=shape).astype(np.float32),
            (rng.normal(size=(3, 3, 3, cin, cout)) * 0.1).astype(np.float32),
            (rng.normal(size=(cout,)) * 0.5).astype(np.float32)]
    if boundary:
        args.append((rng.normal(size=(bsz, cin)) + 1.0).astype(np.float32))
        args.append((np.abs(rng.normal(size=(bsz, cin))) * np.where(
            np.arange(cin) % 2 == 0, 1.0, -1.0)).astype(np.float32))
        assert (args[4] > 0).any() and (args[4] < 0).any()
    return args, rng


CASES = {  # op name -> (JAX op, port op, x shape, Cout, boundary, with stats)
    "stats": (jconv.conv3x3x3_cf_stats, conv3_fused.conv3x3x3_cf_stats,
              (1, 4, 4, 8, 16), 8, False, True),
    "boundary_stats": (jconv.conv3x3x3_cf_boundary_stats, conv3_fused.conv3x3x3_cf_boundary_stats,
                       (2, 4, 4, 8, 8), 8, True, True),
    "boundary": (jconv.conv3x3x3_cf_boundary, conv3_fused.conv3x3x3_cf_boundary,
                 (1, 8, 4, 8, 8), 4, True, False),
}


@pytest.mark.parametrize("op", list(CASES))
def test_fused_op_vjp_matches_jax_fp32(op):
    jop, top, shape, cout, boundary, stats = CASES[op]
    args, rng = _inputs(10 + list(CASES).index(op), shape, cout, boundary)
    want, vjp = jax.vjp(jop, *map(jnp.asarray, args))
    g = rng.normal(size=(shape[0], cout) + shape[2:]).astype(np.float32)
    cts = (g, (rng.normal(size=cout) * 0.1).astype(np.float32),
           (rng.normal(size=cout) * 0.01).astype(np.float32)) if stats else (g,)
    want_grads = vjp(tuple(map(jnp.asarray, cts)) if stats else jnp.asarray(g))

    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = top(*targs)
    outs = got if stats else (got,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cts])
    for name, o, r in zip(("y", "s1", "s2"), outs, want if stats else (want,)):
        _close(o.detach(), r, name=name)
    for name, a, r in zip(("dx", "dw", "db", "da", "dt"), targs, want_grads):
        _close(a.grad, r, name=f"{op} {name}")


@pytest.mark.parametrize("op", list(CASES))
def test_fused_op_bf16_forward_matches_jax(op):
    jop, top, shape, cout, boundary, stats = CASES[op]
    args, _ = _inputs(30 + list(CASES).index(op), shape, cout, boundary)
    args[0] = _bf16(args[0])
    want = jop(jnp.asarray(args[0], jnp.bfloat16), *map(jnp.asarray, args[1:]))
    got = top(torch.from_numpy(args[0]).bfloat16(), *map(torch.from_numpy, args[1:]))
    y, wy = (got[0], want[0]) if stats else (got, want)
    assert y.dtype == torch.bfloat16 and wy.dtype == jnp.bfloat16
    y, wy = y.float().numpy(), np.asarray(wy.astype(jnp.float32))
    allowed = _ulp(np.maximum(np.abs(y), np.abs(wy)))
    if not stats:  # rounded twice: one more ulp of the fp32 conv before the bias
        z = conv3_fused.prologue_reference(torch.from_numpy(args[0]).bfloat16(),
                                           *map(torch.from_numpy, args[3:]))
        c = np.abs(conv3.conv_fp32(z, torch.from_numpy(args[1])).numpy())
        allowed = allowed + _ulp(c)
    assert np.all(np.abs(y - wy) <= allowed), op
    if stats:
        for name, o, r, terms, ref_terms in (
                ("s1", got[1], want[1], y, wy), ("s2", got[2], want[2], y * y, wy * wy)):
            bound = np.abs(terms - ref_terms).sum() + 1e-5 * np.abs(ref_terms).sum()
            err = abs(o.numpy().astype(np.float64) - np.asarray(r, np.float64)).max()
            assert err <= bound, f"{op} {name}: {err} > {bound}"


def test_boundary_halo_stays_zero_where_t_is_positive():
    """x = 0 and a = 0 everywhere, t = 1: the prologue gives 1 inside the
    volume and must leave the halo 0, so a ones-kernel conv counts the
    in-volume neighbours: 8 at a corner, 27 inside."""
    x = torch.zeros(1, 1, 4, 8, 8)
    w = torch.ones(3, 3, 3, 1, 1)
    y = conv3_fused.conv3x3x3_cf_boundary(x, w, torch.zeros(1), torch.zeros(1, 1),
                                          torch.ones(1, 1))
    assert float(y[0, 0, 0, 0, 0]) == 8.0 and float(y[0, 0, 1, 1, 1]) == 27.0
