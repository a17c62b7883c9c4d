"""The head's forward (kernel 11) and weight gradient (kernel 11-dw) of the
port: their plain versions against the JAX package, the index arithmetic
of the CUDA kernels emulated on the CPU, and the calls their wrappers
build, on the CPU.

The CUDA kernels themselves run only on the card (chip_smoke.py holds
them against these plain versions there). Here the forward's 8-voxel
groups, tail and zero-padded weight table, and the weight gradient's
grid-stride walk over the groups, channel slices, per-block partials and
block-order reduce are written out in torch as the kernels do them, and
must reproduce the plain versions.

Tolerances:
* logits (fp32 sums of Cin products in another order): max |port - ref|
  <= 1e-5 * max |ref|;
* dkernel and dbias (fp32 sums over batch and volume in another order):
  each entry within 1e-5 of its sum of |terms|, sum |x ct| (dbias: sum
  |ct|).
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_segmentation_project_tpu.ops import head as jhead
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.ops import head

HEAD_TOL = 1e-5
DW_TOL = 1e-5
CSRC = Path(head.__file__).resolve().parent.parent / "csrc"
SOURCE = (CSRC / "head1x1.cu").read_text()
CONSTS = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", SOURCE)}
WARP = 32


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def _bf16_valued(rng, shape, scale=1.0):
    """fp32 values that bf16 holds exactly, so every side starts equal."""
    a = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))
    return a.bfloat16().float()


def _dw_within_bounds(got, want, x, ct):
    """Each entry of (dk, db) within DW_TOL of its sum of |terms|."""
    xa, ca = x.double().abs(), ct.double().abs()
    bounds = (torch.einsum("bidhw,bodhw->io", xa, ca), ca.sum(dim=(0, 2, 3, 4)))
    for g, w, b in zip(got, want, bounds):
        g, w = torch.as_tensor(np.asarray(g)).double(), torch.as_tensor(np.asarray(w)).double()
        assert g.shape == w.shape == b.shape
        err = (g - w).abs()
        assert bool((err <= DW_TOL * b).all()), float((err / b.clamp_min(1e-300)).max())


def _dw_slice(nc: int) -> int:
    """csrc/head1x1.cu dw_slice: feature channels per slice by classes."""
    m = re.search(r"nc <= 4 \? (\d+) : nc <= 6 \? (\d+) : (\d+);", SOURCE)
    assert m, "dw_slice's table not found in head1x1.cu"
    a, b, c = map(int, m.groups())
    return a if nc <= 4 else b if nc <= 6 else c


def _groups(b: int, v: int):
    """The kernels' 8-voxel groups over the flattened (batch, volume):
    group gi's batch element, first voxel and number of voxels."""
    vox = CONSTS["VOX"]
    per_b = -(-v // vox)
    gi = torch.arange(b * per_b)
    bi = gi // per_b
    v0 = (gi - bi * per_b) * vox
    return bi, v0, torch.clamp(v - v0, max=vox)


def _gather8(t: torch.Tensor, bi, v0, n) -> torch.Tensor:
    """(groups, C, 8) of t (B, C, V): each group's 8 voxels per plane, zero
    past its n valid ones, as the guarded loads read them."""
    j = torch.arange(CONSTS["VOX"])
    v = (v0[:, None] + j).clamp(max=t.shape[2] - 1)  # (groups, 8)
    vals = t[bi[:, None], :, v]  # (groups, 8, C)
    return torch.where((j < n[:, None])[:, :, None], vals, 0.0).transpose(1, 2)


def _emulate_forward(x: torch.Tensor, w_oc: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """head1x1_kernel in fp32 on the CPU: the [Cin][Co rounded up to 4]
    table filled from the flat (Co, Cin) weights, zero past Co; per group
    the sums start at the bias and add the channels i = 0..Cin-1 in order;
    the n valid voxels of each class plane stored. Every output element must
    be written exactly once."""
    b, cin = x.shape[:2]
    co = w_oc.shape[0]
    cop = -(-co // 4) * 4
    flat = w_oc.reshape(-1)
    idx = torch.arange(cin * cop)
    ci, o = idx // cop, idx % cop
    table = torch.where(o < co, flat[(o * cin + ci).clamp(max=co * cin - 1)], 0.0)
    table = table.reshape(cin, cop)
    assert bool((table[:, co:] == 0).all())

    v = x[0, 0].numel()
    bi, v0, n = _groups(b, v)
    xs = _gather8(x.float().reshape(b, cin, v), bi, v0, n)  # (groups, Cin, 8)
    acc = bias.float()[None, :, None].expand(len(bi), co, 8).clone()
    for i in range(cin):
        acc = acc + xs[:, i, None, :] * table[i, :co, None]
    out = torch.full((b, co, v), float("nan"))
    hits = torch.zeros((b, co, v), dtype=torch.int32)
    for j in range(CONSTS["VOX"]):
        keep = j < n
        for o_ in range(co):
            out[bi[keep], o_, v0[keep] + j] = acc[keep, o_, j]
            hits[bi[keep], o_, v0[keep] + j] += 1
    assert bool((hits == 1).all()), "a logit written other than once"
    return out.reshape(b, co, *x.shape[2:])


def _emulate_dw(x: torch.Tensor, ct: torch.Tensor, nblk: int):
    """head1x1_dw_kernel and its block reduce in fp32 on the CPU: block (k,
    s) takes feature slice s; its thread t walks the groups t + 256 k, t +
    256 (k + nblk), ...; per group its dk partials over the slice (the last
    channel read again past Cf) and its db partials; then per warp a
    shuffle-down tree, the warps in order, one row of the [nblk][Cf * NC +
    NC] scratch per block (each entry written once over the slices, db by
    slice 0), and the rows summed in block order."""
    b, cf = x.shape[:2]
    nc = ct.shape[1]
    v = x[0, 0].numel()
    threads = CONSTS["THREADS"]
    fs = _dw_slice(nc)
    bi, v0, n = _groups(b, v)
    xs = _gather8(x.float().reshape(b, cf, v), bi, v0, n)  # (groups, Cf, 8)
    cs = _gather8(ct.float().reshape(b, nc, v), bi, v0, n)  # (groups, NC, 8)
    groups, nthreads = len(bi), nblk * threads
    e_len = cf * nc + nc
    part = torch.full((nblk, e_len), float("nan"))
    hits = torch.zeros((nblk, e_len), dtype=torch.int32)
    visited = torch.zeros(groups, dtype=torch.int32)
    for s in range(-(-cf // fs)):
        f0 = s * fs
        fc = (f0 + torch.arange(fs)).clamp(max=cf - 1)
        acc = torch.zeros(nthreads, fs, nc)
        dbp = torch.zeros(nthreads, nc)
        for start in range(0, groups, nthreads):  # the grid-stride walk
            gi = torch.arange(start, min(start + nthreads, groups))
            t = gi - start
            visited[gi] += 1
            for j in range(CONSTS["VOX"]):
                dbp[t] += cs[gi, :, j]
            for f in range(fs):
                for j in range(CONSTS["VOX"]):
                    acc[t, f] += xs[gi, fc[f], None, j] * cs[gi, :, j]
        vals = torch.cat([acc.reshape(nthreads, fs * nc), dbp], 1)
        vals = vals.reshape(nblk, threads // WARP, WARP, -1)
        off = WARP // 2
        while off:  # __shfl_down_sync: lane l adds lane l + off
            vals = torch.cat([vals[:, :, :off] + vals[:, :, off:2 * off], vals[:, :, off:]], 2)
            off //= 2
        red = vals[:, :, 0]  # (nblk, warps, NP)
        tot = red[:, 0].clone()
        for w in range(1, red.shape[1]):
            tot += red[:, w]
        for k in range(fs * nc + nc):
            if k >= fs * nc:
                if s:
                    continue
                col = cf * nc + k - fs * nc
            elif f0 + k // nc >= cf:
                continue
            else:
                col = f0 * nc + k
            part[:, col] = tot[:, k]
            hits[:, col] += 1
    if groups:
        assert bool((visited == -(-cf // fs)).all()), "a group walked other than once a slice"
    assert bool((hits == 1).all()), "a scratch entry written other than once"
    out = part[0].clone()
    for k in range(1, nblk):
        out += part[k]
    return out[:cf * nc].reshape(cf, nc), out[cf * nc:]


def test_source_constants_match_the_wrappers():
    assert CONSTS["THREADS"] == head.HEAD_THREADS
    assert CONSTS["DX_MAX_CF"] == head.MAX_DX_CHANNELS
    assert CONSTS["DW_BLOCKS_PER_SM"] == head.HEAD_DW_BLOCKS_PER_SM
    assert CONSTS["VOX"] == 8 and CONSTS["FWD_UNROLL"] >= 8
    assert all(1 <= _dw_slice(nc) <= head.MAX_DX_CHANNELS for nc in range(1, 9))


# (x shape, classes): V % 8 != 0, Cin = 5, 16, 40 and 64, classes 1, 3, 4, 8, batch 2
FWD_CASES = [((2, 5, 3, 5, 7), 3), ((2, 16, 3, 5, 7), 4), ((2, 40, 2, 4, 8), 8),
             ((1, 64, 3, 3, 3), 1)]


@pytest.mark.parametrize("shape,co", FWD_CASES, ids=[f"{s}-{c}" for s, c in FWD_CASES])
def test_forward_groups_and_table_reproduce_the_op(shape, co):
    """The forward kernel's groups, tail and padded weight table reproduce
    head1x1_cf_reference (held against the JAX head in test_torch_ops.py),
    in fp32 from the same bf16-valued features."""
    rng = np.random.default_rng(sum(shape) + co)
    x = _bf16_valued(rng, shape)
    k = torch.from_numpy((rng.normal(size=(shape[1], co)) * shape[1] ** -0.5).astype(np.float32))
    bias = torch.from_numpy((rng.normal(size=(co,)) * 0.1).astype(np.float32))
    got = _emulate_forward(x.bfloat16(), k.t().contiguous(), bias)
    want = head.head1x1_cf_reference(x, k, bias)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= HEAD_TOL * float(want.abs().max())


# (x shape, classes, SMs): V % 8 != 0 with a tail, Cf = 16, 40 and 64 (one to
# ten channel slices), classes 1, 3, 4 and 8, batch 2; one SM gives two
# blocks whose threads walk two groups each, 132 SMs a block per 256 groups
DW_CASES = [((2, 16, 13, 15, 17), 4, 1), ((2, 40, 13, 15, 17), 3, 1), ((2, 16, 3, 5, 7), 8, 132),
            ((2, 64, 13, 15, 17), 1, 132), ((1, 40, 9, 10, 11), 8, 1)]


@pytest.mark.parametrize("shape,nc,sms", DW_CASES, ids=[f"{s}-{c}-{m}" for s, c, m in DW_CASES])
def test_dw_walk_partials_and_reduce_reproduce_the_op(shape, nc, sms, monkeypatch):
    """The weight-gradient kernel's grid-stride walk, channel slices,
    per-block partials and block-order reduce reproduce
    head1x1_cf_dw_reference within the sum-order bound; dw_blocks gives
    HEAD_DW_BLOCKS_PER_SM blocks a SM, at most one per 256 groups."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=sms))
    rng = np.random.default_rng(sum(shape) + nc + sms)
    x = _bf16_valued(rng, shape)
    ct = torch.from_numpy((rng.normal(size=(shape[0], nc, *shape[2:])) * 1e-2).astype(np.float32))
    groups = shape[0] * -(-x[0, 0].numel() // 8)
    nblk = head.dw_blocks(torch.device("cpu"), groups)
    assert nblk == max(1, min(head.HEAD_DW_BLOCKS_PER_SM * sms, -(-groups // head.HEAD_THREADS)))
    got = _emulate_dw(x.bfloat16(), ct, nblk)
    _dw_within_bounds(got, head.head1x1_cf_dw_reference(x.bfloat16(), ct), x, ct)


# (shape, Cf, NC, features' dtype): batch 2, odd extents (V % 8 != 0)
JAX_DW_CASES = [((2, 3, 5, 7), 16, 4, "float32"), ((2, 4, 1, 7), 40, 3, "bfloat16")]


@pytest.mark.parametrize("vol,cf,nc,dtype", JAX_DW_CASES,
                         ids=[f"{c}-{n}-{d}" for _, c, n, d in JAX_DW_CASES])
def test_dw_reference_matches_jax(vol, cf, nc, dtype):
    """The plain dkernel and dbias against the JAX head's backward
    (_head_bwd_rule's dot_general and sum, through jax.vjp of head1x1_cf
    in interpret mode), from fp32 or bf16 features."""
    rng = np.random.default_rng(cf + nc)
    b = vol[0]
    x = _bf16_valued(rng, (b, cf, *vol[1:]))
    k = (rng.normal(size=(cf, nc)) * 0.5).astype(np.float32)
    bias = np.zeros((nc,), np.float32)
    ct = (rng.normal(size=(b, nc, *vol[1:])) * 1e-2).astype(np.float32)
    _, vjp = jax.vjp(jhead.head1x1_cf, jnp.asarray(x.numpy(), getattr(jnp, dtype)),
                     jnp.asarray(k), jnp.asarray(bias))
    _, jdk, jdb = vjp(jnp.asarray(ct))
    got = head.head1x1_cf_dw_reference(x.to(getattr(torch, dtype)), torch.from_numpy(ct))
    assert got[0].dtype == got[1].dtype == torch.float32
    _dw_within_bounds(got, (np.array(jdk), np.array(jdb)), x, torch.from_numpy(ct))


def test_dw_call_names_its_entry_point_and_takes_the_tensors_as_they_are(monkeypatch):
    """dw_call passes x and ct as they are, with a scratch of one row of Cf *
    Co + Co per block and fp32 dk (Cf, Co) and db (Co,) as its result; the
    C arguments are what mmseg_head1x1_dw takes (the forward's call is
    checked in test_torch_head_upconv.py)."""
    monkeypatch.setattr(head._build, "require", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    x = torch.randn(2, 16, 3, 5, 7).bfloat16()
    ct = torch.randn(2, 4, 3, 5, 7)
    call = head.dw_call(x, ct)
    assert call.entry == "mmseg_head1x1_dw"
    xk, ctk, part, dk, db = call.tensors
    assert xk is x and ctk is ct
    nblk = head.dw_blocks(x.device, 2 * 14)
    assert call.args[:5] == (x.data_ptr(), ct.data_ptr(), part.data_ptr(), dk.data_ptr(),
                             db.data_ptr())
    assert call.args[5:] == (2, 16, 4, 105, nblk) and nblk == 1
    assert part.numel() == nblk * (16 * 4 + 4) and part.dtype == torch.float32
    assert call.result == (dk, db)
    assert dk.shape == (16, 4) and db.shape == (4,) and dk.dtype == db.dtype == torch.float32


@pytest.mark.parametrize("cf,co", [(65, 4), (16, 9), (0, 4)])
def test_dw_call_refuses_what_the_kernel_does_not_take(cf, co, monkeypatch):
    monkeypatch.setattr(head._build, "require", lambda *a: None)
    with pytest.raises(ValueError, match="the kernel takes"):
        head.dw_call(torch.empty(1, cf, 2, 2, 2, dtype=torch.bfloat16, device="meta"),
                     torch.empty(1, co, 2, 2, 2, device="meta"))
    with pytest.raises(ValueError, match="does not match"):
        head.dw_call(torch.empty(1, 16, 2, 2, 2, dtype=torch.bfloat16, device="meta"),
                     torch.empty(1, 4, 2, 2, 3, device="meta"))


def test_head_call_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(head._build, "require", lambda *a: None)
    x = torch.empty(1, 16, 2, 2, 2, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="1..8 classes"):
        head.head_call(x, torch.empty(16, 9, device="meta"), torch.empty(9, device="meta"))
    cin = head.SMEM_LIMIT // (8 * 4) + 1  # the weight table past 48 KB at 8 classes
    x = torch.empty(1, cin, 2, 2, 2, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="weight table"):
        head.head_call(x, torch.empty(cin, 8, device="meta"), torch.empty(8, device="meta"))


def test_the_backward_launches_the_dw_kernel_and_never_the_plain_einsum(monkeypatch):
    """On a tensor that is not on the CPU (here 'meta', with the launches
    faked) the head's backward takes dkernel and dbias from the kernel's
    call: one head1x1_cf_dw launch, no einsum, no plain version."""
    monkeypatch.setattr(head._build, "require", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: SimpleNamespace(multi_processor_count=132))
    calls = []

    def fake_run(name, call, t):
        calls.append(call.entry)
        return call.result

    def refuse(*a, **k):
        raise AssertionError("the plain weight gradient ran on a device tensor")

    monkeypatch.setattr(head, "run", fake_run)
    monkeypatch.setattr(head, "head1x1_cf_dw_reference", refuse)
    monkeypatch.setattr(torch, "einsum", refuse)
    param = torch.empty(4, 16, 1, 1, 1, device="meta", requires_grad=True)
    bias = torch.empty(4, device="meta", requires_grad=True)
    x = torch.empty(2, 16, 3, 5, 7, dtype=torch.bfloat16, device="meta", requires_grad=True)
    y = head.head1x1_cf(x, param[:, :, 0, 0, 0].t(), bias)
    y.backward(torch.empty_like(y))
    assert calls == ["mmseg_head1x1", "mmseg_head1x1_dx", "mmseg_head1x1_dw"]
    assert ops.launch_counts()["head1x1_cf_dw"] == 1
    assert param.grad.shape == (4, 16, 1, 1, 1) and bias.grad.shape == (4,)
    assert x.grad.shape == x.shape and x.grad.dtype == torch.bfloat16
