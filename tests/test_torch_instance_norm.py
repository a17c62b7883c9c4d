"""``ops/instance_norm.py``'s plain version: act(IN(x) + residual) with its
per-chunk partials merged by Chan's formula and its closed-form backward,
against an fp64 composition (``torch.group_norm``, ``+ residual``,
``F.leaky_relu``) that autograd differentiates. The kernels run this
algorithm on the card, where ``tests/test_torch_instance_norm_card.py``
holds them against this version."""

import pytest
import torch
import torch.nn.functional as F

import _torch_threads  # noqa: F401
from multimodal_segmentation_project_tpu_torch.ops import instance_norm as inorm

SLOPE = 0.01
TAILS = {"none": (False, None), "act": (False, SLOPE), "res_act": (True, SLOPE)}


def _composition(x, residual, slope):
    z = torch.group_norm(x, x.shape[1], None, None, inorm.EPS)
    if residual is not None:
        z = z + residual
    return z if slope is None else F.leaky_relu(z, slope)


def _both(x, residual, slope, dy):
    """(output, dx, dresidual) of the plain version on x's dtype and of the
    fp64 composition on the same values."""
    out = []
    for fn, dtype in ((inorm.instance_norm_act, x.dtype), (_composition, torch.float64)):
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in (x, residual)
                  if t is not None]
        y = fn(leaves[0], leaves[1] if residual is not None else None, slope)
        grads = torch.autograd.grad(y, leaves, dy.to(dtype))
        out.append((y.detach().double(), *(g.double() for g in grads)))
    return out


def _close(got, want, tol):
    for a, b in zip(got, want):
        err = float((a - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max())), err


@pytest.mark.parametrize("tail", TAILS)
def test_plain_matches_fp64_composition(tail, monkeypatch):
    """Rows cut into chunks that do not divide S (5 x 7 x 9 = 315 in
    chunks of 64: a last chunk of 59) and into one chunk, in fp64 to the
    composition's rounding; then large-mean fp32 input (mean 1e3, std 1),
    where a raw sum of squares would lose the variance to cancellation, to
    fp32's resolution of the data (ulp(1e3) = 6e-5)."""
    has_res, slope = TAILS[tail]
    gen = torch.Generator().manual_seed(3)
    for min_chunk, max_chunk in ((16, 64), (256, 8192)):
        monkeypatch.setattr(inorm, "MIN_CHUNK", min_chunk)
        monkeypatch.setattr(inorm, "MAX_CHUNK", max_chunk)
        x = torch.randn(2, 3, 5, 7, 9, generator=gen, dtype=torch.float64) * 2 + 0.5
        res = torch.randn(x.shape, generator=gen, dtype=torch.float64) if has_res else None
        dy = torch.randn(x.shape, generator=gen, dtype=torch.float64)
        got, want = _both(x, res, slope, dy)
        _close(got, want, 1e-12)
    x = (1e3 + torch.randn(1, 2, 16, 16, 16, generator=gen, dtype=torch.float64)).float()
    res = torch.randn(x.shape, generator=gen) if has_res else None
    dy = torch.randn(x.shape, generator=gen)
    got, want = _both(x, res, slope, dy)
    _close(got, want, 2e-3)
    stats = inorm.plain_stats(x)
    var = x.double().reshape(2, -1).var(1, unbiased=False)
    assert torch.allclose(stats[:, 1].double(), torch.rsqrt(var + inorm.EPS), rtol=1e-4)


def test_degenerate_volumes():
    """For each tail: a 1^3 volume normalises to 0, the tail acts on the
    residual alone, and the gradient in x is 0; a constant channel
    normalises to 0 beside a varying one."""
    gen = torch.Generator().manual_seed(4)
    for has_res, slope in TAILS.values():
        x = torch.randn(2, 4, 1, 1, 1, generator=gen, dtype=torch.float64)
        res = torch.randn(x.shape, generator=gen, dtype=torch.float64) if has_res else None
        (y, dx, *dres), want = _both(x, res, slope, torch.randn(x.shape, generator=gen,
                                                                  dtype=torch.float64))
        base = torch.zeros_like(x) if res is None else res
        assert torch.equal(y, base if slope is None else F.leaky_relu(base, slope))
        assert torch.equal(dx, torch.zeros_like(x))
        _close((y, dx, *dres), want, 1e-12)
        x = torch.randn(1, 2, 6, 6, 6, generator=gen)
        x[0, 0] = 0.1
        res = torch.randn(x.shape, generator=gen) if has_res else None
        got, want = _both(x, res, slope, torch.randn(x.shape, generator=gen))
        _close(got, want, 1e-5)
        assert float(inorm.instance_norm_act(x)[0, 0].abs().max()) < 1e-4


def test_chunking_follows_the_volume():
    """One chunk a row at SwinUNETR's deep levels, many at 192^3."""
    assert inorm.chunking(6 ** 3) == (256, 1)
    assert inorm.chunking(12 ** 3) == (2048, 1)
    assert inorm.chunking(1) == (inorm.MIN_CHUNK, 1)
    chunk, n = inorm.chunking(192 ** 3)
    assert chunk == inorm.MAX_CHUNK and (n - 1) * chunk < 192 ** 3 <= n * chunk
    assert 48 * n > 132 * 100  # programs a pass over 48 channels: the card's SMs many times over


def test_refuses_what_the_kernels_do_not_take():
    x = torch.randn(1, 4, 4, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        inorm.instance_norm_act(x.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        inorm.instance_norm_act(x, residual=torch.randn(1, 4, 4, 4, 4).transpose(2, 3))
    with pytest.raises(ValueError, match="does not match"):
        inorm.instance_norm_act(x, residual=x.double())
    with pytest.raises(ValueError, match="B, C, D, H, W"):
        inorm.instance_norm_act(x[0])
