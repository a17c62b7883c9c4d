"""The device mesh over ``torch.distributed`` ranks, the batch layout and
the collectives of the multi-device path.

Port of ``multimodal_segmentation_project_tpu/parallel/mesh.py``. The JAX
package runs one controller over a ``('data', 'spatial')`` device mesh and
lets XLA insert the collectives; the port runs one process per GPU
(``torchrun``, or processes a caller starts, one rank per card) and makes
them itself:

* :class:`Mesh` ``(n_data, n_spatial)`` over the first ``n_data *
  n_spatial`` ranks of the world: rank r sits at (r // n_spatial,
  r % n_spatial). It holds the group of all its ranks, this rank's data
  group (the ranks with its spatial index) and its spatial group (the
  ranks with its data index), each made with ``dist.new_group`` on every
  rank of the world, in one order.
* the batch layout is the JAX package's: the batch over ``data``, D over
  ``spatial`` (D is axis 2 of an image batch, axis 1 of a label batch).
  :func:`batch_sharding` gives this rank's index into a host batch and
  :func:`shard_batch_arrays` applies it; :func:`replicated_sharding` the
  whole array.
* :func:`reduce_sum` is the one rule for a reduction that the JAX package
  takes over a global array: a sum all-reduce whose backward all-reduces
  the cotangent too (:class:`_AllReduceSum`). Every rank then holds the
  same global value L, and a backward on every rank computes the gradient
  of world * L, which the train steps' gradient all-reduce divides by the
  mesh's size (``engine/steps.py``). The D-axis halo's backward is a send,
  not a sum (``ops/halo.py``).
* the transport follows the group's backend, and nothing silent chooses
  it: NCCL moves CUDA tensors card to card; gloo takes CUDA tensors in the
  collectives of :data:`GLOO_CUDA_COLLECTIVES`, which it stages through
  host memory itself, and a tensor for any other operation (the halo's
  point-to-point planes, gathers) is staged through host memory here.

The active-mesh context (:func:`set_active_mesh`, :func:`use_spatial_mesh`,
:func:`active_spatial_mesh`, :func:`active_multi_mesh`,
:func:`active_mesh_devices`) is the JAX package's: the model, the losses,
the metrics and the steps consult it. A mesh of one device, or none, is
the single-device path exactly: no collective runs.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
MESH_AXES = "mesh"  # a reduction over every rank of the mesh

# the collectives ProcessGroupGloo runs on CUDA tensors (it stages them
# through host memory itself), as checked on an H100 with torch 2.11;
# its point-to-point send of a CUDA tensor fails ("writev ... Bad
# address": the TCP transport reads device memory as host memory), so the
# halo's planes are staged here. chip_smoke.py's phase 11 checks the set.
GLOO_CUDA_COLLECTIVES = frozenset({"all_reduce", "broadcast", "all_gather"})

TORCHRUN_HINT = ("launch one process per GPU under torchrun, e.g. `torchrun --standalone "
                 "--nproc_per_node N -m multimodal_segmentation_project_tpu_torch.workloads."
                 "train_unet ...`")


def torchrun_env() -> bool:
    """Whether torchrun's environment (RANK, WORLD_SIZE) is present."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(backend: str | None = None, device: str = "cuda",
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> None:
    """Initialise the default process group, once: from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK), or
    from ``init_method``, ``rank`` and ``world_size`` where a caller starts
    the processes itself. The backend is NCCL for a CUDA device and gloo
    for the CPU unless ``backend`` names one (gloo runs two ranks on one
    card, which NCCL refuses). On CUDA each rank takes the card LOCAL_RANK
    (modulo the visible cards under gloo), and NCCL is told so."""
    if dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if rank is None:
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = init_method or "env://"
    card = None
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", rank))
        card = torch.device("cuda", local if backend == "nccl" else
                            local % torch.cuda.device_count())
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            device_id=card if backend == "nccl" else None)
    if rank == 0:
        print(f"[DIST] {world_size} rank(s) over {backend}", flush=True)


class Mesh:
    """The ``(n_data, n_spatial)`` mesh over the first ``n_data * n_spatial``
    ranks of the world. Every rank of the world builds it (the groups are
    made on every rank); a rank outside it is idle (``member`` False)."""

    def __init__(self, n_data: int = 1, n_spatial: int = 1):
        if n_data < 1 or n_spatial < 1:
            raise ValueError(f"mesh {n_data}x{n_spatial}: both sizes must be >= 1")
        world = world_size()
        if n_data * n_spatial > world:
            raise ValueError(f"mesh {n_data}x{n_spatial} needs {n_data * n_spatial} ranks, the "
                             f"world has {world}: {TORCHRUN_HINT}")
        self.n_data, self.n_spatial = n_data, n_spatial
        self.rank = rank()
        self.member = self.rank < self.size
        self.data_index, self.spatial_index = divmod(self.rank, n_spatial)
        self.group = self.data_group = self.spatial_group = None
        if self.size > 1:
            self.group = dist.new_group(list(range(self.size)))
            for s in range(n_spatial):
                g = dist.new_group([d * n_spatial + s for d in range(n_data)])
                if self.member and s == self.spatial_index:
                    self.data_group = g
            for d in range(n_data):
                g = dist.new_group([d * n_spatial + s for s in range(n_spatial)])
                if self.member and d == self.data_index:
                    self.spatial_group = g

    @property
    def size(self) -> int:
        return self.n_data * self.n_spatial

    def global_rank(self, data_index: int, spatial_index: int) -> int:
        return data_index * self.n_spatial + spatial_index

    def axis(self, name: str) -> tuple:
        """(group, size) of a reduction over ``name``: MESH_AXES, DATA_AXIS
        or SPATIAL_AXIS."""
        if name == MESH_AXES:
            return self.group, self.size
        if name == DATA_AXIS:
            return self.data_group, self.n_data
        if name == SPATIAL_AXIS:
            return self.spatial_group, self.n_spatial
        raise ValueError(f"unknown mesh axis {name!r}")

    def __repr__(self) -> str:
        return f"Mesh({self.n_data}x{self.n_spatial}, rank {self.rank})"


def make_mesh(n_data: int | None = None, n_spatial: int = 1) -> Mesh:
    """The JAX ``make_mesh``: all ranks on the data axis by default."""
    world = world_size()
    if n_data is None:
        if world % n_spatial:
            raise ValueError(f"{world} ranks not divisible by n_spatial={n_spatial}")
        n_data = world // n_spatial
    return Mesh(n_data, n_spatial)


class MeshChoice(NamedTuple):
    n_data: int
    n_spatial: int
    auto_spatial: bool  # n_spatial was raised to fill the idle ranks


def choose_mesh(world: int, batch_size: int, n_spatial: int = 1, n_data: int | None = None,
                auto_spatial: bool = True, depth: int = 192, n_levels: int = 4) -> MeshChoice:
    """The JAX trainer's choice of mesh (``engine/trainer.py:171-207``): the
    largest ``n_data`` that divides the global batch, then, where the batch
    alone cannot fill the world, ``n_spatial`` raised to world // n_data,
    halved until it divides D at every pooling level (``depth >> i`` for
    i = 0..n_levels). Refuses a mesh the world cannot hold, an ``n_data``
    that does not divide the batch and an ``n_spatial`` that does not
    divide D at every level."""
    if n_spatial < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"--n_spatial {n_spatial} and --n_data {n_data} must be >= 1")
    depths = [depth >> i for i in range(n_levels + 1)]
    raised = False
    if n_data is None:
        avail = max(world // n_spatial, 1)
        n_data = next(d for d in range(avail, 0, -1) if batch_size % d == 0)
        if auto_spatial and n_spatial == 1 and n_data < world and world % n_data == 0:
            cand = world // n_data
            while cand > 1 and any(d % cand for d in depths):
                cand //= 2
            if cand > 1:
                n_spatial, raised = cand, True
    if n_data * n_spatial > world:
        raise ValueError(f"mesh {n_data}x{n_spatial} needs {n_data * n_spatial} ranks, the "
                         f"world has {world}: {TORCHRUN_HINT}")
    if batch_size % n_data:
        raise ValueError(f"the global batch {batch_size} does not split over n_data={n_data}")
    if any(d % n_spatial for d in depths):
        raise ValueError(f"n_spatial={n_spatial} does not divide the volume's D at every pooling "
                         f"level ({depths})")
    return MeshChoice(n_data, n_spatial, raised)


# ---- the batch layout -----------------------------------------------------------------


def batch_sharding(mesh: Mesh, ndim: int = 4) -> tuple:
    """This rank's index into a global batch array of rank ``ndim``: the
    batch (axis 0) over ``data``; D over ``spatial``, axis 2 of an image
    batch (ndim >= 5) and axis 1 of a label batch (2 <= ndim <= 4). Apply
    it with :func:`shard_batch_arrays`, which checks the split."""
    d_axis = 2 if ndim >= 5 else 1 if ndim >= 2 else None
    index = [slice(None)] * ndim
    index[0] = (DATA_AXIS, mesh.data_index, mesh.n_data)
    if d_axis is not None:
        index[d_axis] = (SPATIAL_AXIS, mesh.spatial_index, mesh.n_spatial)
    return tuple(index)


def replicated_sharding(mesh: Mesh) -> tuple:
    """The whole array on every rank."""
    return (Ellipsis,)


def _apply(a, index):
    out = []
    for axis, spec in enumerate(index):
        if isinstance(spec, tuple):
            name, i, n = spec
            if a.shape[axis] % n:
                raise ValueError(f"axis {axis} of a {tuple(a.shape)} batch does not split over "
                                 f"{name}={n}")
            size = a.shape[axis] // n
            out.append(slice(i * size, (i + 1) * size))
        else:
            out.append(spec)
    return a[tuple(out)]


def shard_batch_arrays(mesh: Mesh, *arrays):
    """This rank's slice of each global batch array (numpy or torch), as
    :func:`batch_sharding` lays it out."""
    out = tuple(_apply(a, batch_sharding(mesh, a.ndim)) for a in arrays)
    return out if len(out) > 1 else out[0]


def data_rows(n_local: int) -> tuple[int, slice]:
    """(global rows, this rank's rows) of a batch axis of ``n_local`` rows
    under the active mesh's data axis: draws over the global batch (the
    Dropout3d masks) take this rank's rows."""
    mesh = active_multi_mesh()
    if mesh is None or mesh.n_data == 1:
        return n_local, slice(None)
    start = mesh.data_index * n_local
    return n_local * mesh.n_data, slice(start, start + n_local)


# ---- collectives --------------------------------------------------------------------


def _staged(t: torch.Tensor, group, op: str) -> bool:
    """Whether ``op`` on ``t`` goes through a host copy: a CUDA tensor in a
    gloo group, for an operation gloo does not run on CUDA tensors."""
    return (t.is_cuda and dist.get_backend(group) == "gloo"
            and op not in GLOO_CUDA_COLLECTIVES)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group``."""
    if _staged(t, group, "all_reduce"):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place: global rank ``src``'s ``t`` on every rank of ``group``."""
    if _staged(t, group, "broadcast"):
        host = t.cpu()
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group; its backward sums the cotangent over the group
    (the gradient of the sum over every rank's copy of the result)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


_REDUCE_AXIS = MESH_AXES


@contextlib.contextmanager
def reduction_axis(name: str):
    """Reductions by :func:`reduce_sum` and :func:`reduce_mean` inside the
    block run over ``name``: SPATIAL_AXIS for per-sample values (a volume's
    rows lie on one data rank), DATA_AXIS for rows replicated over the
    spatial axis (the bottleneck's features)."""
    global _REDUCE_AXIS
    prev, _REDUCE_AXIS = _REDUCE_AXIS, name
    try:
        yield
    finally:
        _REDUCE_AXIS = prev


def reduce_sum(t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
    """``t`` summed over the active mesh's ``axis`` (by default the
    reduction axis in force, the whole mesh), differentiably; ``t`` itself
    without a multi-device mesh or over an axis of size 1."""
    mesh = active_multi_mesh()
    if mesh is None:
        return t
    group, n = mesh.axis(axis or _REDUCE_AXIS)
    if n == 1:
        return t
    if t.requires_grad:
        return _AllReduceSum.apply(t, group)
    return all_reduce_(t.clone(), group)


def reduce_count(n_local: int, axis: str | None = None) -> int:
    """The global count of ``n_local`` values per rank over ``axis`` (the
    shards are equal)."""
    mesh = active_multi_mesh()
    return n_local if mesh is None else n_local * mesh.axis(axis or _REDUCE_AXIS)[1]


def reduce_mean(t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
    """The mean over every element of ``t`` on every rank of ``axis``;
    ``t.mean()`` without a multi-device mesh."""
    if active_multi_mesh() is None:
        return t.mean()
    return reduce_sum(t.sum(), axis) / reduce_count(t.numel(), axis)


# ---- active-mesh context --------------------------------------------------------------
# The model, the losses, the metrics and the steps consult the active mesh:
# with a spatial axis every 3x3x3 conv runs on a haloed slab (ops/halo.py);
# on any mesh of more than one device the train-mode DoubleConv takes the
# per-conv chain with global-batch BatchNorm, and the reductions all-reduce.

_ACTIVE_MESH: Mesh | None = None


def set_active_mesh(mesh: Mesh | None) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_spatial_mesh() -> Mesh | None:
    """The active mesh if it has a spatial axis of more than one rank."""
    m = _ACTIVE_MESH
    if m is not None and m.n_spatial > 1:
        return m
    return None


def active_mesh_devices() -> int:
    """The active mesh's size (1 when none is set)."""
    return 1 if _ACTIVE_MESH is None else _ACTIVE_MESH.size


def active_multi_mesh() -> Mesh | None:
    """The active mesh if it spans more than one rank, else None."""
    m = _ACTIVE_MESH
    if m is not None and m.size > 1:
        return m
    return None


class use_spatial_mesh:
    """Context manager: activate a mesh for the block."""

    def __init__(self, mesh: Mesh | None):
        self.mesh = mesh

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev = _ACTIVE_MESH
        _ACTIVE_MESH = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False
