"""SwinUNETR (``models/swin_unetr.py``) and its window attention
(``ops/window_attn.py``) on the CPU, against the plain MONAI-form reference
``tests/swin_unetr_reference.py``.

* The window attention's plain version against the reference's
  composition (LayerNorm output padded with zeros, rolled, partitioned, the
  qkv Linear on every window token, the table's bias, ``compute_mask``,
  softmax, reverse, roll back, crop), forward and gradients of the input,
  the Linears, the bias and the table, in fp64 at a shape that pads all
  three axes, shifted by 3: the same function, so within 1e-10 relative.
* The CUDA kernels' index arithmetic (``window_attn_tokens`` of
  ``csrc/window_attn_triton.py``: a window's token to its real row or the
  bias, and its shift region) run in torch on the CPU against the plain partition of the rolled, padded volume; the
  plain version's regions against MONAI's ``compute_mask``.
* The port's SwinUNETR in fp32 against the reference in fp64 at 32^3
  (stages 3 and 4 clip their windows and run unshifted), published widths,
  seeded weights with non-trivial biases and norms: logits, loss and every
  gradient.
* encoder1's residual on its one input channel in bf16: its weight
  gradient against the fp64 reference's.
* Two train steps through the train CLI (``--model swin_unetr``), its
  checkpoint evaluated by the eval CLI, a ``.msgpack`` save and resume of
  the train state, and the refusals (DANN, distillation, a mesh, a freeze,
  fp32 on CUDA, what the kernels do not take).
"""

import importlib.util
import statistics
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_segmentation_project_tpu_torch.data import save_nifti
from multimodal_segmentation_project_tpu_torch.engine import checkpoint as ckpt
from multimodal_segmentation_project_tpu_torch.engine import trainer as trainer_mod
from multimodal_segmentation_project_tpu_torch.engine.interop import jax_path
from multimodal_segmentation_project_tpu_torch.engine.trainer import (
    DannTrainer,
    Trainer,
    TrainerConfig,
    make_model,
)
from multimodal_segmentation_project_tpu_torch.models.swin_unetr import SwinUNETR, UnetResBlock
from multimodal_segmentation_project_tpu_torch.ops import window_attn as wa
from multimodal_segmentation_project_tpu_torch.workloads import test_model, train_unet
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)
from tests import swin_unetr_reference as ref

SIZE = 32


def _perturbed_model(seed: int = 0) -> SwinUNETR:
    """fp32 SwinUNETR whose biases and norms are non-trivial."""
    model = SwinUNETR(dtype=torch.float32, generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def test_window_attention_plain_matches_monai_composition():
    gen = torch.Generator().manual_seed(3)
    size, c, heads, shift = (9, 10, 12), 48, 3, 3
    x = torch.randn(1, *size, c, generator=gen, dtype=torch.float64)
    weights = {"a.qkv.weight": 0.2 * torch.randn(3 * c, c, generator=gen, dtype=torch.float64),
               "a.qkv.bias": torch.randn(3 * c, generator=gen, dtype=torch.float64),
               "a.proj.weight": 0.2 * torch.randn(c, c, generator=gen, dtype=torch.float64),
               "a.proj.bias": torch.randn(c, generator=gen, dtype=torch.float64),
               "a.relative_position_bias_table": torch.randn(13 ** 3, heads, generator=gen,
                                                             dtype=torch.float64)}
    r = ref.SwinUNETRReference(weights, torch.float64)
    xr = x.clone().requires_grad_(True)
    win, sft = ref.window_size(size, shift=shift)
    pad = [-(-s // w) * w for s, w in zip(size, win)]
    y = F.pad(xr, (0, 0, 0, pad[2] - size[2], 0, pad[1] - size[1], 0, pad[0] - size[0]))
    y = torch.roll(y, tuple(-s for s in sft), (1, 2, 3))
    mask = ref.compute_mask(pad, win, sft, x.device, x.dtype)
    y = r._attention(ref.window_partition(y, win), "a", heads, mask)
    y = torch.roll(ref.window_reverse(y.view(-1, *win, c), win, (1, *pad)), sft, (1, 2, 3))
    want = y[:, :size[0], :size[1], :size[2]]
    g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    leaves = [xr, *r.params.values()]
    g_want = torch.autograd.grad(want, leaves, g)

    p = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    xp = x.clone().requires_grad_(True)
    qkv = F.linear(xp, p["a.qkv.weight"], p["a.qkv.bias"])
    out = wa.window_attention(qkv, p["a.qkv.bias"], p["a.relative_position_bias_table"],
                              wa.relative_position_index(), heads, 7, shift)
    got = F.linear(out, p["a.proj.weight"], p["a.proj.bias"])
    g_got = torch.autograd.grad(got, [xp, *p.values()], g)
    got, want = got.detach(), want.detach()
    assert float((got - want).norm() / want.norm()) < 1e-10
    for name, a, b in zip(["x", *weights], g_got, g_want):
        assert float((a - b).norm() / b.norm()) < 1e-10, name
    # padded tokens take part: their keys and values are the bias, so the
    # qkv bias's gradient differs from the real tokens' sum alone
    assert float(g_got[2].norm()) > 0


def _kernel_source_on_torch(monkeypatch):
    """``csrc/window_attn_triton.py`` loaded with torch in Triton's place:
    ``triton.jit`` returns the plain function."""
    tl = types.SimpleNamespace(
        where=lambda c, a, b: torch.where(torch.as_tensor(c), torch.as_tensor(a),
                                          torch.as_tensor(b)),
        int32=torch.int32, int64=torch.int64)
    triton = types.ModuleType("triton")
    triton.jit = lambda fn=None, **kw: fn if fn is not None else (lambda f: f)
    triton.language = tl
    monkeypatch.setitem(sys.modules, "triton", triton)
    monkeypatch.setitem(sys.modules, "triton.language", tl)
    spec = importlib.util.spec_from_file_location("window_attn_triton_on_torch", wa.KERNEL_SOURCE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_kernel_index_arithmetic_and_regions(monkeypatch):
    """``window_attn_tokens`` with torch in Triton's place, every window of
    padded, shifted, clipped and batched volumes, against the plain
    partition; and the plain regions against MONAI's ``compute_mask``."""
    tokens = _kernel_source_on_torch(monkeypatch).window_attn_tokens
    for shape, shift in (((1, 9, 12, 16), 3), ((2, 12, 12, 12), 3), ((1, 4, 4, 4), 3),
                         ((1, 14, 14, 14), 0), ((1, 21, 10, 8), 3)):
        geo = wa.Geometry(shape + (144,), 3, 7, shift)
        n, d, h, w, pd, ph, pw, nwh, nww, per_b, wd, wh, ww, sd, sh, sw = geo.args()[:16]
        full = torch.full((shape[0], pd, ph, pw, 1), -1, dtype=torch.long)
        full[:, :d, :h, :w] = torch.arange(shape[0] * d * h * w).view(shape[0], d, h, w, 1)
        if geo.shifted:
            full = torch.roll(full, (-sd, -sh, -sw), (1, 2, 3))
        want = wa._partition(full, geo.window)[..., 0]
        regions = wa._partition(wa.region_ids(geo.pad, geo.window, geo.shift, "cpu")[
            None, ..., None], geo.window)[..., 0]
        t = torch.arange(geo.nb * wa.BLOCK)
        for wid in range(geo.n_windows):
            real, row, region = tokens(torch.tensor(wid), t, n, d, h, w, pd, ph, pw, nwh, nww,
                                       per_b, wd, wh, ww, sd, sh, sw)
            assert torch.equal(real[:n], want[wid] >= 0) and not real[n:].any()
            assert torch.equal(row[:n][real[:n]], want[wid][want[wid] >= 0])
            if geo.shifted:
                assert torch.equal(region[:n], regions[wid % per_b])
        groups, size = geo.groups()
        assert groups * geo.heads <= wa.PARTIAL_TILES and (groups - 1) * size < geo.n_windows
    # MONAI's compute_mask: -100 exactly where the plain regions differ
    for pad, win, sft in (((14, 14, 21), (7, 7, 7), (3, 3, 3)), ((4, 14, 14), (4, 7, 7), (0, 3, 3))):
        ids = wa._partition(wa.region_ids(pad, win, sft, "cpu")[None, ..., None], win)[..., 0]
        mine = torch.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0)
        assert torch.equal(mine, ref.compute_mask(pad, win, sft, "cpu"))


def test_swin_unetr_matches_reference_at_32():
    """fp32 port against the fp64 reference. Logits within 1e-5 relative
    (fp32 rounding through 8 Swin blocks and 10 residual blocks: 1e-6
    measured). Each gradient within 1e-2 of the larger of its reference norm
    and the median leaf's: the sums behind the biases that feed a LayerNorm
    cancel, and fp32 keeps about 3 digits of them (the fp32 reference itself
    errs by up to 2.5e-3 there, the port by 3.3e-3)."""
    model = _perturbed_model()
    r = ref.SwinUNETRReference(model.state_dict(), torch.float64)
    gen = torch.Generator().manual_seed(5)
    x = torch.rand(1, 1, SIZE, SIZE, SIZE, generator=gen)
    labels = torch.randint(0, 4, (1, SIZE, SIZE, SIZE), generator=gen)
    got, want = model(x), r.forward(x)
    assert float((got.double() - want).norm() / want.norm()) < 1e-5
    loss_got, loss_want = F.cross_entropy(got, labels), F.cross_entropy(want, labels)
    assert abs(float(loss_got) - float(loss_want)) < 1e-6 * abs(float(loss_want))
    loss_got.backward()
    g_want = dict(zip(r.params, torch.autograd.grad(loss_want, list(r.params.values()))))
    median = statistics.median(float(g.norm()) for g in g_want.values())
    assert set(g_want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        gap = float((p.grad.double() - g_want[name]).norm())
        assert gap <= 1e-2 * max(float(g_want[name].norm()), median), name


def test_residual_on_one_channel_keeps_its_gradient_in_bf16():
    """encoder1's residual IN(conv1x1(x)) in bf16 against the fp64 reference.
    IN(w_c x) hardly depends on w_c once w_c^2 var >> eps (every |w_c| >= 0.5
    here), so the gradient in w is eps-sized: the composition's, left after
    IN's backward cancels sums over the volume, was 2.7-4.1 times off in
    bf16; the closed form's is 0.02-0.09 off (4 seeds), hence 0.25."""
    for seed in range(2):
        gen = torch.Generator().manual_seed(seed)
        block = UnetResBlock(1, 48)
        with torch.no_grad():
            for p in block.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * (2 / p[0].numel()) ** 0.5)
            w = block.conv3.conv.weight
            w.copy_(w.sign() * (0.5 + w.abs()))
        x = 0.3 * torch.rand(1, 1, 24, 24, 24, generator=gen)
        target = torch.randn(1, 48, 24, 24, 24, generator=gen)
        (block(x.bfloat16(), torch.bfloat16).float() * target).sum().backward()
        r = ref.SwinUNETRReference({f"b.{k}": v for k, v in block.state_dict().items()},
                                   torch.float64)
        want, = torch.autograd.grad((r._res(x.double(), "b") * target).sum(),
                                    [r.params["b.conv3.conv.weight"]])
        got = block.conv3.conv.weight.grad.double()
        assert float((got - want).norm()) < 0.25 * float(want.norm()), seed


def _write_split(root, split: str, seed: int) -> None:
    rng = np.random.default_rng(seed)
    for name in ("synth_ct", "synth_mri"):
        img_dir, lbl_dir = root / split / name / "images", root / split / name / "labels"
        img_dir.mkdir(parents=True)
        lbl_dir.mkdir(parents=True)
        lbl = rng.integers(0, 4, (SIZE,) * 3).astype(np.int16)
        img = lbl.astype(np.float32) * 60 + rng.normal(0, 25, lbl.shape)
        save_nifti(img.astype(np.float32), str(img_dir / "c00.nii.gz"), affine=np.eye(4))
        save_nifti(lbl, str(lbl_dir / "c00.nii.gz"), affine=np.eye(4))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("swin_data")
    for i, split in enumerate(("train", "val", "test")):
        _write_split(root, split, 10 * i)
    return root


def test_train_cli_two_steps_and_eval(data_root, tmp_path):
    """--model swin_unetr: one epoch of two volumes (two steps, batch 1),
    the best model's ``.msgpack`` (MONAI's names nested) evaluated."""
    exp = tmp_path / "exp"
    args = train_unet.build_parser().parse_args([
        "--data_root", str(data_root), "--experiment_dir", str(exp), "--batch_size", "1",
        "--model", "swin_unetr", "--device", "cpu", "--mixed_precision", "no", "--epochs", "1",
        "--loss", "ce_tversky", "--num_workers", "0"])
    args.experiment_name = "swin"
    summary = train_unet.main(args)
    assert summary["epoch"] == 1 and np.isfinite(summary["train"]["loss"])
    best = exp / "swin" / "checkpoints" / "best_model_swin.msgpack"
    tree = ckpt.load_checkpoint(str(best))
    qkv = tree["params"]["swinViT"]["layers1"]["0"]["blocks"]["0"]["attn"]["qkv"]["weight"]
    assert tuple(qkv.shape) == (144, 48) and tree["batch_stats"] == {}
    overall = test_model.main(test_model.build_parser().parse_args([
        "--model_path", str(best), "--data_root", str(data_root), "--experiment_dir", str(exp),
        "--model_name", "swin", "--model", "swin_unetr", "--precision", "fp32",
        "--device", "cpu", "--no_visualizations"]))
    assert np.isfinite(overall["mean_dice_overall"])


def _volumes(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.random((1, SIZE, SIZE, SIZE), dtype=np.float32),
             rng.integers(0, 4, (SIZE,) * 3).astype(np.int32)) for _ in range(n)]


def _cfg(tmp_path, name: str, **kw) -> TrainerConfig:
    return TrainerConfig(experiment_dir=str(tmp_path), experiment_name=name, precision="fp32",
                         device="cpu", model="swin_unetr", grad_accum=2, num_workers=0,
                         lr=1e-3, weight_decay=1e-4, augment=True, **kw)


def test_msgpack_save_and_resume_round_trip(tmp_path):
    """After one AdamW update (two steps, accumulation 2), the train state
    saved as ``.msgpack`` and resumed: params, AdamW's moments, the step
    and the epoch come back; the names are their own JAX paths."""
    vols = _volumes(2, 7)
    run = Trainer(_cfg(tmp_path, "a"), vols, vols[:1])
    run.train_epoch(0)
    path = str(tmp_path / "state.msgpack")
    run.save_checkpoint(path, 0, {"loss": 1.0}, {})
    resumed = Trainer(_cfg(tmp_path, "b", resume=path), vols, vols[:1])
    params = dict(resumed.state.model.named_parameters())
    for name, p in run.state.model.named_parameters():
        assert jax_path(name) == tuple(name.split("."))
        assert torch.equal(p, params[name]), name
        a, b = run.state.optimizer.state[p], resumed.state.optimizer.state[params[name]]
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"],
                                                                      b["exp_avg_sq"])
    assert (resumed.state.step, resumed.state.mini_step, resumed.start_epoch) == (2, 0, 1)


def test_refusals(tmp_path, monkeypatch):
    vols = _volumes(1, 9)
    with pytest.raises(ValueError, match="DANN runs on UNet3D"):
        DannTrainer(_cfg(tmp_path, "dann"), vols, vols, vols)
    with pytest.raises(ValueError, match="distillation"):
        Trainer(_cfg(tmp_path, "kd"), vols, vols, teacher=torch.nn.Linear(1, 1),
                kd_loss_fn=lambda *a: 0)
    monkeypatch.setattr(trainer_mod, "world_size", lambda: 2)
    with pytest.raises(ValueError, match="halo"):
        Trainer(_cfg(tmp_path, "mesh"), vols, vols)
    monkeypatch.undo()
    for kw in ({"freeze_at_start": True}, {"freeze_encoder_epoch": 1}):
        with pytest.raises(ValueError, match="swinViT"):
            Trainer(_cfg(tmp_path, "freeze", **kw), vols, vols)
    with pytest.raises(ValueError, match="bf16 only"):
        make_model("swin_unetr", precision="fp32", device="cuda")
    model = make_model("swin_unetr", precision="fp32", device="cpu")
    with pytest.raises(ValueError, match="bottleneck"):
        model(torch.zeros(1, 1, SIZE, SIZE, SIZE), return_features=True)
    with pytest.raises(ValueError, match="multiples of 32"):
        model(torch.zeros(1, 1, 16, 16, 16))
    # what the CUDA kernels take, checked before any launch
    qkv = torch.zeros(1, 7, 7, 7, 144, dtype=torch.bfloat16)
    wa.check(qkv, 3, 7)
    with pytest.raises(TypeError, match="bfloat16"):
        wa.check(qkv.float(), 3, 7)
    with pytest.raises(ValueError, match="head dim 16"):
        wa.check(qkv, 6, 7)
    with pytest.raises(ValueError, match="window"):
        wa.check(qkv, 3, 8)
