"""The training engine: the train state, the LR schedule, the steps, the
loop (``trainer``), checkpoint IO and weight interop with the JAX package.

The package exports the JAX package's ``engine`` names.
"""

from multimodal_segmentation_project_tpu_torch.engine.schedule import ReduceLROnPlateau
from multimodal_segmentation_project_tpu_torch.engine.state import (
    TrainState,
    create_train_state,
    freeze_mask,
    make_optimizer,
)
from multimodal_segmentation_project_tpu_torch.engine.steps import (
    make_dann_step,
    make_distill_step,
    make_eval_step,
    make_sharded_eval_step,
    make_train_step,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "make_optimizer",
    "freeze_mask",
    "ReduceLROnPlateau",
    "make_train_step",
    "make_eval_step",
    "make_sharded_eval_step",
    "make_distill_step",
    "make_dann_step",
]
