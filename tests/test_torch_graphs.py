"""The parts of the train steps' CUDA-graph replay (``engine/steps.py:_Replay``)
that run on the CPU, at a toy size (16^3; features 4, 8 and 32, 64, whose
bottleneck takes the per-conv chain):

* the Dropout masks drawn ahead by :func:`draw_masks` from a forward's plan
  are bitwise the masks the forward draws inline, for ``UNet3D`` and for
  DANN's three streams (``_split_generator``'s generators, or the CPU's
  default one), the discriminator's included;
* a forward given the drawn-ahead masks (a ``MaskSource`` over a buffer)
  gives bitwise the logits and BatchNorm statistics of the inline one;
* the gating (``_replays``) keeps the eager path on the CPU, under a
  multi-device mesh and with hooks a replay cannot honour; the train, DANN
  and distillation steps run eagerly on the CPU;
* the metrics a step returns share no storage across calls.

The replay itself needs a CUDA device: ``tests/test_torch_graphs_card.py``.
"""

import types

import pytest
import torch

import _torch_threads  # noqa: F401
from multimodal_segmentation_project_tpu_torch.engine import steps
from multimodal_segmentation_project_tpu_torch.engine.state import TrainState
from multimodal_segmentation_project_tpu_torch.models import DomainDiscriminator, UNet3D, unet3d
from multimodal_segmentation_project_tpu_torch.models.unet3d import MaskSource, draw_masks
from multimodal_segmentation_project_tpu_torch.ops.losses import distillation_loss, get_loss_fn

SIZE = 16


def _model(features=(4, 8), seed=0):
    return UNet3D(features=features, dtype=torch.float32,
                  generator=torch.Generator().manual_seed(seed)).train()


def _volume(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(1, 1, SIZE, SIZE, SIZE, generator=g),
            torch.randint(0, 4, (1, SIZE, SIZE, SIZE), generator=g, dtype=torch.int32))


@pytest.fixture
def drawn(monkeypatch):
    """Every keep mask drawn from now on, in order, flat."""
    masks, real = [], unet3d._draw_keep

    def record(shape, rate, generator):
        mask = real(shape, rate, generator)
        masks.append(mask.reshape(-1))
        return mask

    monkeypatch.setattr(unet3d, "_draw_keep", record)
    return masks


def test_unet_masks_drawn_ahead_match_inline(drawn):
    model, (x, _) = _model(), _volume(1)
    model(x, generator=torch.Generator().manual_seed(7))
    plain = torch.cat(drawn)
    drawn.clear()
    source = MaskSource(torch.Generator().manual_seed(7))
    model(x, generator=source)
    inline = torch.cat(drawn)
    assert len(source.plan) == 10  # two masks a DoubleConv, five DoubleConvs
    ahead = draw_masks(source.plan, torch.Generator().manual_seed(7))
    assert torch.equal(inline, plain) and torch.equal(ahead, inline)


@pytest.mark.parametrize("seeded", [True, False], ids=["split", "default_generator"])
def test_dann_masks_drawn_ahead_match_inline(drawn, seeded):
    """The source, target and discriminator streams in the DANN step's
    order; without a generator all three draw from the CPU's default one."""
    model, disc = _model(), DomainDiscriminator(16, generator=torch.Generator().manual_seed(3))
    (src, _), (tgt, _) = _volume(1), _volume(2)

    def generators():
        torch.manual_seed(23)
        return steps._split_generator(torch.Generator().manual_seed(11) if seeded else None, 3)

    sources = [MaskSource(g) for g in generators()]
    src_feat = model(src, return_features=True, generator=sources[0])[1]
    tgt_feat = model(tgt, return_features=True, generator=sources[1])[1]
    disc.train()(torch.cat([src_feat, tgt_feat]).detach(), generator=sources[2])
    inline = torch.cat(drawn)
    assert [len(s.plan) for s in sources] == [10, 10, 2]
    ahead = torch.cat([draw_masks(s.plan, g) for s, g in zip(sources, generators())])
    assert torch.equal(ahead, inline)


def _drawn_ahead(forward, seed):
    """(output, source) of ``forward`` given the masks drawn ahead of it
    from a generator seeded ``seed``, with the plan noted by a forward of
    ``forward`` on another copy."""
    plan = MaskSource(torch.Generator().manual_seed(seed))
    forward(plan, copy=True)
    source = MaskSource(buffer=draw_masks(plan.plan, torch.Generator().manual_seed(seed)),
                        plan=plan.plan)
    return forward(source), source


@pytest.mark.parametrize("net", ["unet", "disc"])
def test_forward_unchanged_with_drawn_masks(net):
    if net == "unet":  # the bottleneck (64 -> 128) and dec0 take the per-conv chain
        nets = [_model((32, 64)) for _ in range(3)]
        x = _volume(4)[0]
    else:
        nets = [DomainDiscriminator(16, generator=torch.Generator().manual_seed(3)).train()
                for _ in range(3)]
        x = torch.randn(2, 16, generator=torch.Generator().manual_seed(4))
    inline = nets[0](x, generator=torch.Generator().manual_seed(5))

    def forward(masks, copy=False):
        return nets[2 if copy else 1](x, generator=masks)

    out, source = _drawn_ahead(forward, 5)
    assert source.exhausted()
    assert torch.equal(out, inline)
    for a, b in zip(nets[0].buffers(), nets[1].buffers()):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="plan"):
        nets[1](x, generator=MaskSource(buffer=source.buffer, plan=source.plan[1:]))


def test_gating_keeps_the_eager_path(monkeypatch):
    """``_replays`` on a stand-in CUDA input: yes for one card with a plain
    forward hook, and for two states at different points of their
    accumulation (each folds its gradients eagerly); no on the CPU, under a
    multi-device mesh, with a pre-hook, a submodule's hook or a hook taking
    kwargs."""
    state = TrainState(_model(), 1e-3, grad_accum_steps=2)
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    gens = (torch.Generator(),)
    assert steps._replays((state,), (cuda,), gens)
    assert steps._replays((state,), (cuda,), (None,))
    assert not steps._replays((state,), (_volume(0)[0],), gens)
    with monkeypatch.context() as m:
        m.setattr(steps, "active_multi_mesh", lambda: object())
        assert not steps._replays((state,), (cuda,), gens)
    plain = state.model.register_forward_hook(lambda *args: None)
    assert steps._replays((state,), (cuda,), gens)
    plain.remove()
    for hook in (state.model.register_forward_pre_hook(lambda *args: None),
                 state.model.register_forward_hook(lambda *args: None, with_kwargs=True),
                 state.model.encoder[0].register_forward_hook(lambda *args: None)):
        assert not steps._replays((state,), (cuda,), gens)
        hook.remove()
    other = TrainState(DomainDiscriminator(16), 1e-3, grad_accum_steps=2)
    assert steps._replays((state, other), (cuda,), gens * 2)
    other.mini_step = 1
    assert steps._replays((state, other), (cuda,), gens * 2)


def test_cpu_steps_run_eagerly(monkeypatch):
    """The train, DANN and distillation steps on the CPU never capture."""

    def refuse(*args):
        raise AssertionError("a step captured a CUDA graph on the CPU")

    monkeypatch.setattr(steps._Replay, "_capture", refuse)
    monkeypatch.setattr(steps._Replay, "_warm_up", refuse)
    loss = get_loss_fn("ce_tversky")
    state = TrainState(_model(), 1e-3, grad_accum_steps=2)
    train = steps.make_train_step(loss, augment=True, nan_guard=True)
    distill = steps.make_distill_step(distillation_loss, nan_guard=True)
    teacher = _model(seed=1).eval()
    disc = TrainState(DomainDiscriminator(16), 1e-3, grad_accum_steps=2)
    dann = steps.make_dann_step(loss, 0.2, nan_guard=True)
    for i in range(3):
        (x, y), (t, _) = _volume(10 + i), _volume(20 + i)
        gen = torch.Generator().manual_seed(i)
        for m in (train(state, x, y, gen), distill(state, teacher, x, y, gen),
                  dann(state, disc, x, y, t, gen)):
            assert float(m["nonfinite"]) == 0.0
    assert state.step == 9 and disc.step == 3


def test_metrics_do_not_alias():
    state = TrainState(_model(), 1e-3, grad_accum_steps=2)
    step = steps.make_train_step(get_loss_fn("ce_tversky"), nan_guard=True)
    first = step(state, *_volume(1), torch.Generator().manual_seed(1))
    second = step(state, *_volume(2), torch.Generator().manual_seed(2))
    held = {k: v.clone() for k, v in first.items()}
    ptrs = {v.untyped_storage().data_ptr() for v in first.values()}
    assert not ptrs & {v.untyped_storage().data_ptr() for v in second.values()}
    assert all(torch.equal(first[k], held[k]) for k in held)
    static = {k: torch.tensor(float(i)) for i, k in enumerate(("dice", "iou", "acc", "loss"))}
    copies = [steps._copied(static) for _ in range(2)]
    assert all(torch.equal(c[k], static[k]) for c in copies for k in static)
    storages = [{v.untyped_storage().data_ptr() for v in d.values()} for d in (static, *copies)]
    assert len(storages[1]) == len(storages[2]) == 1
    assert not (storages[0] & storages[1] or storages[1] & storages[2])
