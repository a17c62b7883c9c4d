"""The train steps' CUDA-graph replay on the card (``engine/steps.py:_Replay``),
at 32^3, features 8, 16, accumulation 8 and 16 steps (two AdamW updates),
in bf16 with augmentation, in fp32, and DANN in bf16. Each test skips
without a CUDA device, so the CPU suite counts none of them.

* Graphed and eager steps agree bit for bit wherever two eager runs do:
  the parameters, both Adam moments, the accumulator, the BatchNorm
  buffers, each step's metrics and the logits a forward hook sees at each
  step; steps 3-16 replay the graph.
* A NaN in one replayed step's input rolls the whole state back.
* A freeze (a fresh optimizer) drops the graph, and the step captures anew.

The eager runs hold a no-op forward pre-hook on the model, which keeps the
step off the graphs. The tests directory's ``conftest.py`` imports JAX,
which the card's machine lacks, so run them there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs_card.py -q
"""

import pytest
import torch

import _torch_threads  # noqa: F401
from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
from multimodal_segmentation_project_tpu_torch.engine.steps import make_dann_step, make_train_step
from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator, UNet3D
from multimodal_segmentation_project_tpu_torch.ops.losses import get_loss_fn

SIZE, FEATURES, ACCUM, STEPS = 32, (8, 16), 8, 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.fixture
def graph_calls(monkeypatch):
    """Captures and replays of CUDA graphs, counted."""
    calls = {"capture": 0, "replay": 0}
    for name, method in (("capture", "capture_begin"), ("replay", "replay")):
        real = getattr(torch.cuda.CUDAGraph, method)

        def counted(self, *args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(self, *args, **kw)

        monkeypatch.setattr(torch.cuda.CUDAGraph, method, counted)
    return calls


def _snapshot(states) -> dict:
    out = {}
    for tag, st in zip(("seg", "disc"), states):
        out[f"{tag}.mini_step"] = torch.tensor(st.mini_step)
        out[f"{tag}.step"] = torch.tensor(st.step)
        for name, p in st.model.named_parameters():
            out[f"{tag}.param.{name}"] = p.detach().clone()
            for k in ("exp_avg", "exp_avg_sq"):
                if p in st.optimizer.state:
                    out[f"{tag}.{k}.{name}"] = st.optimizer.state[p][k].clone()
        for name, a in st.acc_grads.items():
            out[f"{tag}.acc.{name}"] = a.clone()
        for name, b in st.model.named_buffers():
            out[f"{tag}.buffer.{name}"] = b.clone()
    return out


def _run(kind, device, eager, nan_at=None, freeze_at=None, snap_at=()):
    """The metrics of each step, the states' snapshots after the steps in
    ``snap_at`` and at the end, and the logits a forward hook saw."""
    dtype = torch.float32 if kind == "fp32" else torch.bfloat16
    model = UNet3D(features=FEATURES, dtype=dtype,
                   generator=torch.Generator().manual_seed(0)).to(device)
    state = TrainState(model, 1e-3, 1e-4, ACCUM)
    loss = get_loss_fn("ce_tversky")
    if kind == "dann":
        disc = DomainDiscriminator(2 * FEATURES[-1],
                                   generator=torch.Generator().manual_seed(1)).to(device)
        states = (state, TrainState(disc, 1e-3, 1e-4, ACCUM))
        step = make_dann_step(loss, 0.2, nan_guard=True)
    else:
        states = (state,)
        step = make_train_step(loss, augment=kind == "bf16", nan_guard=True)
    if eager:
        model.register_forward_pre_hook(lambda *args: None)
    logits = []
    model.register_forward_hook(lambda module, args, out: logits.append(
        (out[0] if isinstance(out, tuple) else out).detach().clone()))
    data = torch.Generator(device=device).manual_seed(5)
    metrics, snaps = [], {}
    for i in range(STEPS):
        images, target = (torch.rand(1, 1, SIZE, SIZE, SIZE, generator=data, device=device)
                          for _ in range(2))
        labels = torch.randint(0, 4, (1, SIZE, SIZE, SIZE), generator=data, device=device,
                               dtype=torch.int32)
        if i == nan_at:
            images[0, 0, 3, 4, 5] = float("nan")
        if i == freeze_at:
            state.with_mask(("enc",))
        gen = torch.Generator().manual_seed(100 + i)
        out = (step(*states, images, labels, target, gen) if kind == "dann"
               else step(state, images, labels, gen))
        metrics.append({k: v.clone() for k, v in out.items()})
        if i in snap_at:
            snaps[i] = _snapshot(states)
    torch.cuda.synchronize(device)
    snaps["end"] = _snapshot(states)
    return metrics, snaps, logits


def _flat(metrics, snaps, logits) -> dict:
    out = {f"step{i}.{k}": v for i, m in enumerate(metrics) for k, v in m.items()}
    out.update({f"{at}.{k}": v for at, s in snaps.items() for k, v in s.items()})
    out.update({f"logits{i}": v for i, v in enumerate(logits)})
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN matching NaN (a rolled-back step's logits)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def _agree(graphed, first, second) -> None:
    """Graphed equals eager bit for bit wherever the two eager runs agree;
    elsewhere it lies within twice their difference."""
    g, a, b = _flat(*graphed), _flat(*first), _flat(*second)
    assert g.keys() == a.keys() == b.keys()
    differ = [k for k in a if not _same(a[k], b[k])]
    print(f"{len(differ)} of {len(a)} quantities differ between two eager runs: {differ[:8]}")
    wrong = [k for k in a if k not in differ and not _same(g[k], a[k])]
    assert not wrong, f"graphed and eager differ where two eager runs agree: {wrong[:8]}"
    for k in differ:
        spread = (a[k].double() - b[k].double()).abs().max()
        assert (g[k].double() - a[k].double()).abs().max() <= 2 * spread, k


@pytest.mark.parametrize("kind", ["bf16", "fp32", "dann"])
def test_graphed_steps_match_eager(card, graph_calls, kind):
    """``_agree`` holds the forward hook's logits of every step too, DANN's
    source and target forwards included."""
    graphed = _run(kind, card, eager=False)
    assert graph_calls == {"capture": 1, "replay": STEPS - 2}
    assert len(graphed[2]) == (2 if kind == "dann" else 1) * STEPS
    _agree(graphed, _run(kind, card, eager=True), _run(kind, card, eager=True))
    assert graph_calls["replay"] == STEPS - 2  # the eager runs replay nothing


def test_nan_rolls_back_the_replayed_step(card, graph_calls):
    nan_at = 5
    graphed = _run("bf16", card, eager=False, nan_at=nan_at, snap_at=(nan_at - 1, nan_at))
    metrics, snaps, _ = graphed
    assert float(metrics[nan_at]["nonfinite"]) == 1.0
    assert float(metrics[nan_at]["loss"]) == 0.0
    before, after = snaps[nan_at - 1], snaps[nan_at]
    assert before.keys() == after.keys()
    assert not [k for k in before if not _same(before[k], after[k])]
    assert graph_calls["replay"] == STEPS - 2  # the NaN step replays, then rolls back
    eager = [_run("bf16", card, eager=True, nan_at=nan_at, snap_at=(nan_at - 1, nan_at))
             for _ in range(2)]
    _agree(graphed, *eager)


def test_freeze_recaptures(card, graph_calls):
    graphed = _run("bf16", card, eager=False, freeze_at=10)
    assert graph_calls == {"capture": 2, "replay": STEPS - 2}
    _agree(graphed, *(_run("bf16", card, eager=True, freeze_at=10) for _ in range(2)))
