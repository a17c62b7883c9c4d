"""The port's host-side data stack: NIfTI IO, the datasets and their
preprocessing, the decode-once cache and the threaded loader.

These modules are copies of the JAX package's ``data/`` modules (numpy,
ctypes and gzip only), kept here so that the port imports nothing of the
JAX package. The JAX package's device prefetch is not copied: the trainer
uploads batches from pinned memory instead.
"""

from multimodal_segmentation_project_tpu_torch.data.dataset import (
    CombinedDataset,
    ConcatDataset,
    Subset,
    preprocess_ct,
    preprocess_mri,
    seeded_subset,
)
from multimodal_segmentation_project_tpu_torch.data.nifti import (
    NiftiImage,
    load_nifti,
    load_nifti_header,
    save_nifti,
)
from multimodal_segmentation_project_tpu_torch.data.pipeline import DataLoader

__all__ = [
    "CombinedDataset",
    "ConcatDataset",
    "DataLoader",
    "NiftiImage",
    "Subset",
    "load_nifti",
    "load_nifti_header",
    "preprocess_ct",
    "preprocess_mri",
    "save_nifti",
    "seeded_subset",
]
