"""The FLOP count from shapes against torch's own count of the reference."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import flops
from gpubench.reference.train import Discriminator, _Reverse
from gpubench.reference.unet3d import Reference, ce_tversky, cross_entropy
from gpubench.weights import discriminator_layout, make_weights, unet3d_layout

CONFIG = {"features": [8, 16], "volume_size": 32, "in_channels": 1, "classes": 4,
          "precision": "fp32"}


def _reference():
    w = make_weights(unet3d_layout(CONFIG["features"]), 0, "cpu")
    return Reference(w, CONFIG["features"], 0.1)


def _inputs():
    g = torch.Generator().manual_seed(1)
    x = torch.rand((1, 1, 32, 32, 32), generator=g)
    y = torch.randint(0, 4, (1, 32, 32, 32), generator=g)
    return x, y


def _count(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("step", ["eval", "train"])
def test_unet3d_flops_match_torch_count(step):
    net, (x, y) = _reference(), _inputs()

    def go():
        if step == "eval":
            with torch.no_grad():
                net.forward(x, train=False)
        else:
            loss = ce_tversky(net.forward(x, train=True, gen=torch.Generator()), y)
            torch.autograd.grad(loss, list(net.params.values()))

    assert _count(go) == flops.model_flops(flops.step_work(CONFIG, step))


def test_dann_flops_match_torch_count():
    net, (x, y) = _reference(), _inputs()
    disc = Discriminator(make_weights(discriminator_layout(32), 2, "cpu"))
    cfg = {**CONFIG}

    def go():
        logits, fs = net.forward(x, True, torch.Generator(), return_features=True)
        ft = net.forward(x, True, torch.Generator(), return_features=True)[1]
        feats = torch.cat([_Reverse.apply(fs, 0.2), _Reverse.apply(ft, 0.2)])
        total = ce_tversky(logits, y) + 0.2 * cross_entropy(disc.forward(feats, torch.Generator()),
                                                            torch.tensor([0, 1]))
        torch.autograd.grad(total, [*net.params.values(), *disc.params.values()])

    assert _count(go) == flops.model_flops(flops.step_work(cfg, "dann"))


def test_full_size_counts():
    cfg = json.load(open(flops.__file__.replace("flops.py", "configs/unet3d-bf16.json")))
    assert flops.model_flops(flops.step_work(cfg, "eval")) == pytest.approx(0.806426e12, rel=1e-6)
    assert flops.model_flops(flops.step_work(cfg, "train")) == pytest.approx(2.413163e12,
                                                                             rel=1e-6)
