"""One rank of the port's multi-device path on the CPU, for
tests/test_torch_parallel.py.

    python tests/torch_parallel_worker.py RANK WORLD PORT DIR

Joins a gloo world of WORLD ranks at tcp://127.0.0.1:PORT, reads the cases'
inputs from DIR/inputs.pt (written by the test: {name: inputs}, each with
its kind and its mesh), runs each case in that order on the ranks of its
mesh (a rank outside a smaller mesh sits it out) on this rank's shard, and
writes {name: output} to DIR/out_RANK.pt. The kinds:

* ``halo``: ``halo_conv3`` of the plain conv on a 1 x n mesh, forward and
  backward: this rank's y and dx slabs, and its dW and db partials;
* ``train``: one ``make_train_step`` on the (n_data, n_spatial) mesh, with
  SGD in the TrainState (the JAX test's optimizer): the metrics, the
  gradients applied, the parameters and BatchNorm statistics after;
* ``eval``: ``make_sharded_eval_step`` on the mesh, this rank's rows and
  weights of a padded batch;
* ``dann_distill``: one DANN step and one distillation step on the mesh.
"""

import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from multimodal_segmentation_project_tpu_torch.engine.state import TrainState  # noqa: E402
from multimodal_segmentation_project_tpu_torch.engine.steps import (  # noqa: E402
    make_dann_step,
    make_distill_step,
    make_sharded_eval_step,
    make_train_step,
)
from multimodal_segmentation_project_tpu_torch.models import (  # noqa: E402
    DomainDiscriminator,
    UNet3D,
)
from multimodal_segmentation_project_tpu_torch.ops import conv3  # noqa: E402
from multimodal_segmentation_project_tpu_torch.ops.halo import halo_conv3  # noqa: E402
from multimodal_segmentation_project_tpu_torch.ops.losses import (  # noqa: E402
    distillation_loss,
    get_loss_fn,
)
from multimodal_segmentation_project_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    shard_batch_arrays,
    use_spatial_mesh,
)
from tests import _torch_threads  # noqa: E402,F401  (torch's threads in the workers)


def _unet(inp: dict, key: str = "state_dict") -> UNet3D:
    model = UNet3D(in_channels=1, out_channels=4, features=inp["features"], dropout_rate=0.0,
                   dtype=torch.float32)
    model.load_state_dict(inp[key], strict=True)
    return model


def _sgd_state(model, lr: float) -> TrainState:
    """A TrainState whose update is p -= lr * g (the JAX test's optax.sgd(1.0)
    times the state's LR)."""
    state = TrainState(model, lr)
    state.optimizer = torch.optim.SGD(model.parameters(), lr=lr)
    return state


def _after(model) -> dict:
    return {"grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state_dict": {k: v.clone() for k, v in model.state_dict().items()}}


def _halo(inp: dict, mesh: Mesh) -> dict:
    x, ct = shard_batch_arrays(mesh, inp["x"], inp["ct"])
    x = x.clone().requires_grad_(True)
    w, b = (inp[k].clone().requires_grad_(True) for k in ("w", "b"))
    y = halo_conv3(conv3.conv3x3x3_cf, x, w, b, mesh)
    y.backward(ct)
    return {"y": y.detach(), "dx": x.grad, "dw": w.grad, "db": b.grad}


def _train(inp: dict, mesh: Mesh) -> dict:
    model = _unet(inp)
    state = _sgd_state(model, inp["lr"])
    images, labels = shard_batch_arrays(mesh, inp["images"], inp["labels"])
    metrics = make_train_step(get_loss_fn("ce_tversky"), nan_guard=True)(state, images, labels)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, **_after(model)}


def _eval(inp: dict, mesh: Mesh) -> dict:
    model = _unet(inp)
    images, labels, weights = shard_batch_arrays(mesh, inp["images"], inp["labels"],
                                                 inp["weights"])
    out = make_sharded_eval_step(get_loss_fn("ce_tversky"))(TrainState(model, 1e-3), images,
                                                            labels, weights)
    return {"metrics": {k: float(v) for k, v in out.items()}}


def _dann_distill(inp: dict, mesh: Mesh) -> dict:
    seg = _unet(inp)
    disc = DomainDiscriminator(2 * inp["features"][-1], dropout_rate=0.0)
    disc.load_state_dict(inp["disc_state_dict"], strict=True)
    seg_state, disc_state = _sgd_state(seg, inp["lr"]), _sgd_state(disc, inp["lr"])
    src, lbl, tgt = shard_batch_arrays(mesh, inp["images"], inp["labels"], inp["target"])
    step = make_dann_step(get_loss_fn("ce_tversky"), inp["lambda_domain"], nan_guard=True)
    metrics = step(seg_state, disc_state, src, lbl, tgt, torch.Generator().manual_seed(0))
    dann = {"metrics": {k: float(v) for k, v in metrics.items()}, **_after(seg),
            "disc": _after(disc)}

    student, teacher = _unet(inp), _unet(inp, "teacher_state_dict").requires_grad_(False)
    state = _sgd_state(student, inp["lr"])
    kd = make_distill_step(lambda s, t, y: distillation_loss(s, t, y, alpha=inp["alpha"],
                                                              temperature=inp["temperature"]),
                           nan_guard=True)
    metrics = kd(state, teacher, src, lbl)
    distill = {"metrics": {k: float(v) for k, v in metrics.items()}, **_after(student)}
    return {"dann": dann, "distill": distill}


KINDS = {"halo": _halo, "train": _train, "eval": _eval, "dann_distill": _dann_distill}


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        cases = torch.load(Path(out_dir) / "inputs.pt", weights_only=False)
        outs = {}
        for name, inp in cases.items():
            mesh = Mesh(*inp["mesh"])  # every rank makes the mesh's groups
            if mesh.member:
                with use_spatial_mesh(mesh):
                    outs[name] = KINDS[inp["kind"]](inp, mesh)
        torch.save(outs, Path(out_dir) / f"out_{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
