"""PyTorch/CUDA port of the multimodal abdominal-organ segmentation framework.

The JAX package ``multimodal_segmentation_project_tpu`` is the reference;
this package computes the same functions in PyTorch, with hand-written
CUDA kernels (``csrc/``) where the JAX package has Pallas kernels. It
imports nothing of JAX and nothing of the JAX package: its host-side data
stack (``data/``) and CLI helpers (``workloads/common.py``) are its own
copies.

Slice 1 covers full-volume evaluation (``workloads.test_model``); slice 2
the baseline training step and its CLI (``workloads.train_unet``). The
multi-device path (``parallel``: the mesh over ``torch.distributed`` ranks,
one process per GPU, with ``ops/halo.py``'s D-axis halo exchange) runs
every training CLI and the eval CLI on several GPUs.
"""

NUM_CLASSES = 4  # background, spleen=1, liver=2, kidneys=3
CLASS_NAMES = ("background", "spleen", "liver", "kidneys")
ORGAN_NAMES = ("spleen", "liver", "kidneys")

__all__ = ["CLASS_NAMES", "NUM_CLASSES", "ORGAN_NAMES"]
