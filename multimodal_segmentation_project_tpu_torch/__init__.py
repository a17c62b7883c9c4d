"""PyTorch/CUDA port of the multimodal abdominal-organ segmentation framework.

The JAX package ``multimodal_segmentation_project_tpu`` is the reference;
this package computes the same functions in PyTorch, with hand-written
CUDA kernels (``csrc/``) where the JAX package has Pallas kernels. It
imports no JAX. Its host-only data stack (NIfTI IO, datasets, loader) is
the JAX package's own, which imports only numpy.

Slice 1 covers full-volume evaluation: ``workloads.test_model``.
"""

from multimodal_segmentation_project_tpu import CLASS_NAMES, NUM_CLASSES, ORGAN_NAMES

__all__ = ["CLASS_NAMES", "NUM_CLASSES", "ORGAN_NAMES"]
