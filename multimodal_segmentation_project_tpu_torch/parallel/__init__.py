"""The multi-device path: the mesh over ``torch.distributed`` ranks, the
batch layout and the collectives (``parallel/mesh.py``); the D-axis halo
exchange is ``ops/halo.py``."""

from multimodal_segmentation_project_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    choose_mesh,
    init_distributed,
    make_mesh,
    replicated_sharding,
    set_active_mesh,
    shard_batch_arrays,
    use_spatial_mesh,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "shard_batch_arrays",
    "Mesh",
    "choose_mesh",
    "init_distributed",
    "set_active_mesh",
    "use_spatial_mesh",
]
