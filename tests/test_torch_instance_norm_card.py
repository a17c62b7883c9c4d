"""``ops/instance_norm.py``'s kernels on the card against its plain version,
in bf16, at SwinUNETR's largest and smallest InstanceNorm (192^3 x 48
channels, 865 chunks a row; 6^3 x 768, one chunk a row), for each tail;
and the op captured in a CUDA graph and replayed. Each test skips without
a CUDA device, so the CPU suite counts none of them. The tests directory's
``conftest.py`` imports JAX, which the card's machine lacks, so run them
there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_instance_norm_card.py -q
"""

import pytest
import torch

import _torch_threads  # noqa: F401
from multimodal_segmentation_project_tpu_torch.ops import instance_norm as inorm
from multimodal_segmentation_project_tpu_torch.ops.instance_norm import instance_norm_act

SLOPE = 0.01
TAILS = ((False, None), (False, SLOPE), (True, SLOPE))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)


def _kernel(x, res, slope, dy):
    """(output, dx[, dresidual]) of the op."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, res) if t is not None]
    y = instance_norm_act(leaves[0], leaves[1] if res is not None else None, slope)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy))


def _plain(x, res, slope, dy, out):
    """The plain version's (output, dx[, dresidual]); its backward gates on
    ``out``, the kernel's output, so that a sign near 0, which the order of
    the sums may flip, gates both alike."""
    stats = inorm.plain_stats(x)
    dx, g = inorm.plain_backward(x, out, dy, stats, slope)
    return (inorm.plain_forward(x, res, slope, stats), dx, *(() if res is None else (g.to(dy.dtype),)))


@pytest.mark.parametrize("shape", [(1, 48, 192, 192, 192), (1, 768, 6, 6, 6)],
                         ids=["192^3x48", "6^3x768"])
def test_kernel_matches_plain(card, shape):
    """The output, dx and dresidual within two bf16 ulps plus 1e-5 of the
    largest magnitude: both take the statistics and sums in fp32 and round
    once, and differ only in the order of their sums."""
    gen = torch.Generator(device=card).manual_seed(7)
    x = (3 + 2 * torch.randn(shape, generator=gen, device=card)).to(torch.bfloat16)
    for has_res, slope in TAILS:
        res = torch.randn(shape, generator=gen, device=card).to(torch.bfloat16) if has_res else None
        dy = torch.randn(shape, generator=gen, device=card).to(torch.bfloat16)
        launches = instance_norm_act.launches
        got = _kernel(x, res, slope, dy)
        assert instance_norm_act.launches - launches == 6
        want = _plain(x, res, slope, dy, got[0])
        torch.cuda.synchronize()
        assert len(got) == len(want) == (3 if has_res else 2)
        for a, b in zip(got, want):
            a, b = a.float(), b.float()
            allowed = 2 * _bf16_ulp(torch.maximum(a.abs(), b.abs())) + 1e-5 * b.abs().max()
            assert bool(((a - b).abs() <= allowed).all()), (has_res, slope, (a - b).abs().max())


def test_graph_capture_replays_the_op(card):
    """Forward and backward captured in one CUDA graph (the capture counts no
    launch from the host) replay on new inputs bit for bit as eager calls."""
    shape = (2, 48, 32, 32, 32)  # 4 chunks a row
    gen = torch.Generator(device=card).manual_seed(8)

    def inputs():
        return [torch.randn(shape, generator=gen, device=card).to(torch.bfloat16) for _ in range(3)]

    static = inputs()
    leaves = [t.requires_grad_(True) for t in static[:2]]

    def step():
        y = instance_norm_act(leaves[0], leaves[1], SLOPE)
        return (y, *torch.autograd.grad(y, leaves, static[2]))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = instance_norm_act.launches
    with torch.cuda.graph(graph):
        outs = step()
    assert instance_norm_act.launches == launches
    for _ in range(2):
        fresh = inputs()
        with torch.no_grad():
            for s, f in zip(static, fresh):
                s.copy_(f)
        graph.replay()
        want = _kernel(fresh[0], fresh[1], SLOPE, fresh[2])
        torch.cuda.synchronize()
        for a, b in zip(outs, want):
            assert torch.equal(a, b)
