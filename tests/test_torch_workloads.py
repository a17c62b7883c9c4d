"""The port's fine-tune, distillation and DANN CLIs and its orchestrator,
end to end on the CPU at a toy size (features 4, 8; 16^3 volumes; batch 1;
fp32; ``--device cpu``), on synthetic NIfTI splits in the JAX CLIs'
layouts, the DANN one's five directories included."""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_segmentation_project_tpu.engine.trainer import DannTrainer as JaxDannTrainer
from multimodal_segmentation_project_tpu.workloads import distill_unet as jax_distill
from multimodal_segmentation_project_tpu.workloads import finetune_ct as jax_finetune
from multimodal_segmentation_project_tpu.workloads import main as jax_main
from multimodal_segmentation_project_tpu.workloads import train_dann as jax_dann
from multimodal_segmentation_project_tpu_torch import ops
from multimodal_segmentation_project_tpu_torch.data import CombinedDataset, save_nifti
from multimodal_segmentation_project_tpu_torch.engine import checkpoint as ckpt
from multimodal_segmentation_project_tpu_torch.engine import msgpack_codec
from multimodal_segmentation_project_tpu_torch.engine.checkpoint import load_params_any
from multimodal_segmentation_project_tpu_torch.engine.interop import (
    state_dict_to_discriminator_params,
)
from multimodal_segmentation_project_tpu_torch.engine.trainer import DannTrainer, TrainerConfig
from multimodal_segmentation_project_tpu_torch.models import UNet3D
from multimodal_segmentation_project_tpu_torch.workloads import (
    distill_unet,
    finetune_ct,
    main,
    test_model,
    train_dann,
    train_unet,
)
from tests import _torch_threads  # noqa: F401  (torch's threads in the workers)

SIZE = 16
TOY = ["--features", "4,8", "--device", "cpu", "--mixed_precision", "no", "--batch_size", "1",
       "--num_workers", "0", "--dropout_rate", "0.0", "--seed", "3"]


@pytest.fixture(autouse=True)
def _no_launches():
    ops.reset_launch_counts()
    yield
    assert ops.launch_counts() == dict.fromkeys(ops.KERNEL_OPS, 0)


def _write_cases(root, split, dataset, n, seed):
    rng = np.random.default_rng(seed)
    img_dir, lbl_dir = root / split / dataset / "images", root / split / dataset / "labels"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    for i in range(n):
        lbl = np.zeros((SIZE,) * 3, np.int16)
        lbl[2:9, 3:10, 4:12] = 2
        lbl[10:14, 2:6, 9:14] = 1
        lbl[9:13, 11:15, 1:5] = 3
        img = lbl.astype(np.float32) * 60 + rng.normal(0, 25, lbl.shape)
        save_nifti(img.astype(np.float32), str(img_dir / f"c{i:02d}.nii.gz"))
        save_nifti(lbl, str(lbl_dir / f"c{i:02d}.nii.gz"))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """train/val/test in both modalities, and DANN's extra directories."""
    root = tmp_path_factory.mktemp("workload_data")
    for i, (split, n) in enumerate([("train", 2), ("val", 1), ("test", 1), ("target", 2),
                                    ("dann_add_labeled", 1), ("dann_add_unlabeled", 1)]):
        _write_cases(root, split, "synth_ct", n, seed=10 * i)
        _write_cases(root, split, "synth_mri", n, seed=10 * i + 1)
    return root


@pytest.fixture(scope="module")
def pretrained(data_root, tmp_path_factory):
    """A best checkpoint of the port's train CLI (one epoch)."""
    exp = tmp_path_factory.mktemp("pretrain")
    args = train_unet.build_parser().parse_args(
        ["--data_root", str(data_root), "--experiment_dir", str(exp), "--epochs", "1", *TOY])
    args.experiment_name = "base"
    train_unet.main(args)
    path = exp / "base" / "checkpoints" / "best_model_base.msgpack"
    assert path.exists() and Path(f"{path}.json").exists()
    return path


def _model_state(path):
    """The state dict of a toy UNet3D loaded from a checkpoint."""
    model = UNet3D(features=(4, 8), dtype=torch.float32)
    assert load_params_any(model, str(path)) == []
    return model.state_dict()


def _only_run(exp):
    (run,) = [p for p in exp.iterdir() if p.is_dir()]
    return run


def _rows(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_finetune_freezes_encoder_and_bottleneck(data_root, pretrained, tmp_path):
    exp = tmp_path / "ft"
    main.main(["--experiment", "finetune", "--pretrained_model", str(pretrained),
               "--freeze_encoder", "--data_root", str(data_root), "--experiment_dir", str(exp),
               "--epochs", "2", "--modalities", "ct", "--lr", "1e-3", *TOY])
    run = _only_run(exp)
    assert run.name.startswith("finetune_") and "best_model_base_samples_None" in run.name
    fields, rows = _rows(run / "logs" / "finetune_log.csv")
    assert [r["epoch"] for r in rows] == ["1", "2"]
    assert all(r["encoder_frozen"] == "True" for r in rows)
    assert all(np.isfinite(float(r["train_loss"])) for r in rows)
    (best,) = (run / "checkpoints").glob("best_finetuned_model_*.msgpack")
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == [best.name,
                                                                         f"{best.name}.json"]
    before, after = _model_state(pretrained), _model_state(best)
    params = {n for n, _ in UNet3D(features=(4, 8), dtype=torch.float32).named_parameters()}
    frozen = [n for n in params if n.startswith(("encoder.", "bottleneck."))]
    assert frozen and all(torch.equal(before[n], after[n]) for n in frozen)
    moved = [n for n in params - set(frozen) if not torch.equal(before[n], after[n])]
    assert moved and all(n.startswith(("upconvs.", "decoder.", "final_conv.")) for n in moved)
    assert any(n.startswith("decoder.") for n in moved)


def test_finetune_refuses_a_checkpoint_of_other_widths(data_root, pretrained, tmp_path):
    args = finetune_ct.build_parser().parse_args(
        ["--pretrained_model", str(pretrained), "--data_root", str(data_root),
         "--experiment_dir", str(tmp_path), "--epochs", "1", *TOY, "--features", "4,8,16"])
    # the pretrained model is the train CLI's .msgpack: the JAX package's strict KeyError
    with pytest.raises(KeyError, match="missing or mismatched param"):
        finetune_ct.main(args)


def test_distill_saves_the_best_student_only(data_root, pretrained, tmp_path):
    exp = tmp_path / "kd"
    main.main(["--experiment", "distill", "--teacher_model", str(pretrained),
               "--data_root", str(data_root), "--experiment_dir", str(exp), "--epochs", "2",
               "--alpha", "0.7", "--temperature", "2.0", "--loss", "ce_tversky", *TOY])
    run = _only_run(exp)
    assert run.name.startswith("distill_")
    _, rows = _rows(run / "logs" / "distill_log.csv")
    assert [r["epoch"] for r in rows] == ["1", "2"]
    assert all(np.isfinite(float(r[k])) for r in rows for k in ("train_loss", "val_loss"))
    names = sorted(p.name for p in (run / "checkpoints").iterdir())
    assert names == [f"best_student_{run.name}.msgpack", f"best_student_{run.name}.msgpack.json"]
    config = (run / "config.txt").read_text()
    assert "alpha: 0.7" in config and "temperature: 2.0" in config


def _dann_args(data_root, exp, name, *extra):
    args = train_dann.build_parser().parse_args(
        ["--data_root", str(data_root), "--experiment_dir", str(exp), "--source_modality",
         "mri", "--target_modality", "ct", "--lambda_domain", "0.2", "--loss", "ce_tversky",
         "--n_add_source", "1", *TOY, *extra])
    args.experiment_name = name
    return args


def test_dann_cli_checkpoints_the_discriminator_and_resumes(data_root, pretrained, tmp_path,
                                                            capsys):
    exp = tmp_path / "dann"
    summary = train_dann.main(_dann_args(data_root, exp, "run", "--epochs", "1",
                                         "--pretrained_model", str(pretrained)))
    out = capsys.readouterr().out
    # source: 2 MRI train + 1 CT add; target: 2 CT + 1 CT add; val: the CT split
    assert "source: 2 train + 1 add = 3; target: 2 + 1 = 3; val: 1" in out
    assert "(non-strict; 0 tensors kept their initial values)" in out
    assert np.isfinite(summary["train"]["task_loss"])
    assert np.isfinite(summary["train"]["domain_loss"])
    fields, rows = _rows(exp / "run" / "logs" / "train_log.csv")
    assert fields == JaxDannTrainer.CSV_COLUMNS
    r = rows[0]
    total = float(r["task_loss"]) + 0.2 * float(r["domain_loss"])
    np.testing.assert_allclose(float(r["train_loss"]), total, rtol=1e-6)
    best = exp / "run" / "checkpoints" / "best_model_run.msgpack"
    saved, meta = ckpt.load_checkpoint(str(best)), ckpt.load_metadata(str(best))
    assert set(saved["disc_params"]) == {"fc0", "fc1", "fc2", "out"}
    assert saved["disc_params"]["fc0"]["kernel"].shape == (16, 256)  # flax's (in, out)
    assert saved["disc_opt_state"]  # AdamW moments
    assert meta["lambda_domain"] == 0.2

    # the eval CLI loads the DANN model unchanged
    overall = test_model.main(test_model.build_parser().parse_args([
        "--model_path", str(best), "--data_root", str(data_root), "--experiment_dir",
        str(exp), "--model_name", "dann", "--precision", "fp32", "--features", "4,8",
        "--device", "cpu", "--no_visualizations", "--modalities", "ct"]))
    assert np.isfinite(overall["mean_dice_overall"])

    # --resume restores the discriminator and its optimizer too
    args = _dann_args(data_root, exp, "resumed", "--epochs", "2", "--resume", str(best))
    cfg = TrainerConfig(experiment_dir=str(exp), experiment_name="resumed", epochs=2,
                        batch_size=1, features=(4, 8), precision="fp32", device="cpu",
                        num_workers=0, resume=str(best), dropout_rate=0.0)
    trainer = DannTrainer(cfg, CombinedDataset(str(data_root / "train"), ["mri"]),
                          CombinedDataset(str(data_root / "target"), ["ct"]),
                          CombinedDataset(str(data_root / "val"), ["ct"]), lambda_domain=0.2)
    disc = state_dict_to_discriminator_params(trainer.disc_state.model.state_dict())
    for layer, leaves in saved["disc_params"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(np.asarray(disc[layer][k]), v, err_msg=f"{layer}/{k}")
    assert msgpack_codec.packb(trainer.disc_state.optax_state()) == msgpack_codec.packb(
        saved["disc_opt_state"])  # the discriminator's AdamW moments, as written
    assert trainer.disc_state.step == trainer.state.step == int(saved["step"]) > 0
    assert trainer.start_epoch == 1
    capsys.readouterr()
    train_dann.main(args)
    assert f"[RESUME] from {best} at epoch 1" in capsys.readouterr().out
    _, rows = _rows(exp / "resumed" / "logs" / "train_log.csv")
    assert [r["epoch"] for r in rows] == ["2"]


def test_main_routes_every_experiment(monkeypatch, capsys):
    calls = []
    for module in (train_unet, finetune_ct, test_model, distill_unet, train_dann):
        monkeypatch.setattr(module, "main",
                            lambda ns, name=module.__name__: calls.append((name, ns)))
    base = ["--data_root", "d", "--device", "cpu", "--lr", "5e-4"]
    routes = {
        "train": (train_unet, []),
        "finetune": (finetune_ct, ["--pretrained_model", "p.pth", "--freeze_encoder"]),
        "eval": (test_model, ["--model_path", "m.pth"]),
        "distill": (distill_unet, ["--teacher_model", "t.pth"]),
        "dann": (train_dann, ["--source_modality", "mri", "--target_modality", "ct"]),
    }
    for experiment, (module, extra) in routes.items():
        main.main(["--experiment", experiment, *base, *extra])
        name, ns = calls[-1]
        assert name == module.__name__, experiment
        assert ns.device == "cpu" and ns.data_root == "d"
        # every flag of the CLI's parser, the orchestrator's value where it has one
        dests = {a.dest for a in module.build_parser()._actions} - {"help"}
        assert set(vars(ns)) == dests
        if "lr" in dests:
            assert ns.lr == 5e-4
    assert calls[1][1].freeze_encoder and calls[1][1].pretrained_model == "p.pth"
    assert calls[2][1].precision == "bf16"  # test_model's own default
    assert "Device Information" in capsys.readouterr().out
    for experiment, flag in (("finetune", "--pretrained_model"), ("eval", "--model_path"),
                             ("distill", "--teacher_model")):
        with pytest.raises(ValueError, match=flag):
            main.main(["--experiment", experiment, "--device", "cpu"])
    main.main(["--experiment", "transfer"])
    main.main(["--experiment", "cyclegan"])
    out = capsys.readouterr().out
    assert "Transfer learning not implemented yet." in out
    assert "CycleGAN not implemented yet." in out
    assert len(calls) == 5


REQUIRED = {
    "finetune_ct": ["--data_root", "d", "--pretrained_model", "p"],
    "distill_unet": ["--data_root", "d", "--teacher_model", "t"],
    "train_dann": ["--data_root", "d", "--source_modality", "mri", "--target_modality", "ct"],
    "main": [],
}


@pytest.mark.parametrize("mine,ref", [(finetune_ct, jax_finetune), (distill_unet, jax_distill),
                                      (train_dann, jax_dann), (main, jax_main)],
                         ids=list(REQUIRED))
def test_clis_take_the_jax_clis_flags_and_defaults(mine, ref):
    argv = REQUIRED[mine.__name__.rsplit(".", 1)[1]]
    got = vars(mine.build_parser().parse_args(argv))
    want = vars(ref.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("module,extra", [
    (finetune_ct, ["--pretrained_model", "p.pth"]),
    (distill_unet, ["--teacher_model", "t.pth"]),
    (train_dann, ["--source_modality", "mri", "--target_modality", "ct"]),
])
def test_clis_refuse_cuda_without_a_gpu(data_root, tmp_path, module, extra):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU error cannot show")
    args = module.build_parser().parse_args(
        ["--data_root", str(data_root), "--experiment_dir", str(tmp_path),
         "--mixed_precision", "bf16", *extra])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(args)
    assert not any(tmp_path.iterdir())  # refused before anything was written


@pytest.fixture(scope="module")
def jax_msgpack(tmp_path_factory):
    """A toy UNet3D (features 4, 8) as the JAX package saves it: its params
    and batch_stats through ``engine/checkpoint.py:save_checkpoint``."""
    import jax
    import jax.numpy as jnp

    from multimodal_segmentation_project_tpu.engine import checkpoint as jax_ckpt
    from multimodal_segmentation_project_tpu.models import UNet3D as JaxUNet3D

    model = JaxUNet3D(out_channels=4, features=(4, 8), dtype=jnp.float32, conv_impl="xla")
    variables = jax.jit(model.init)(jax.random.key(1), jnp.zeros((1, 1, SIZE, SIZE, SIZE)))
    path = tmp_path_factory.mktemp("jax_ckpt") / "model.msgpack"
    jax_ckpt.save_checkpoint(str(path), {"params": variables["params"],
                                         "batch_stats": variables["batch_stats"]})
    return path


@pytest.mark.parametrize("flag", ["--pretrained_model", "--teacher_model", "--model_path",
                                  "malformed"])
def test_a_msgpack_checkpoint_is_refused(data_root, tmp_path, jax_msgpack, flag, capsys):
    """A JAX ``.msgpack`` loads wherever main.py takes a model path (the
    name is kept from when the port refused them); a file that is not a
    checkpoint is refused with a ValueError that says so."""
    experiment = {"--pretrained_model": "finetune", "--teacher_model": "distill",
                  "--model_path": "eval", "malformed": "eval"}[flag]
    argv = ["--experiment", experiment, "--data_root", str(data_root),
            "--experiment_dir", str(tmp_path / "exp"), "--epochs", "1", *TOY]
    if flag == "malformed":
        bad = tmp_path / "model.msgpack"
        bad.write_bytes(b"\x80")  # an empty msgpack map
        with pytest.raises(ValueError, match="not a model checkpoint"):
            main.main([*argv, "--model_path", str(bad)])
        return
    main.main([*argv, flag, str(jax_msgpack)])
    out = capsys.readouterr().out
    if flag == "--model_path":
        assert "Overall Mean - Dice" in out
    else:
        assert "[END] training completed" in out


def test_dann_subsets_as_the_jax_cli():
    """``_rng_subset`` draws the JAX CLI's indices."""
    data = list(range(9))
    for n, seed in ((4, 42), (1, 0), (8, 7)):
        assert train_dann._rng_subset(data, n, seed).indices == \
            list(jax_dann._rng_subset(data, n, seed).indices)
    assert train_dann._rng_subset(data, None, 1) is data
