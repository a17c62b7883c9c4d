"""The port's host-side data stack: NIfTI IO, the datasets and their
preprocessing, the decode-once cache and the threaded loader.

These modules are copies of the JAX package's ``data/`` modules (numpy,
ctypes and gzip only), kept here so that the port imports nothing of the
JAX package. ``pipeline.prefetch_to_device`` and ``pipeline.upload``
take the JAX package's device prefetch's place: each batch (each rank's
slice of it on a mesh) is uploaded from pinned memory, non-blocking.
"""

from multimodal_segmentation_project_tpu_torch.data.dataset import (
    AMOS_MAPPING,
    CHAOS_RANGES,
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
    reorient_to_ras,
    save_nifti,
)
from multimodal_segmentation_project_tpu_torch.data.pipeline import DataLoader

__all__ = [
    "AMOS_MAPPING",
    "CHAOS_RANGES",
    "CombinedDataset",
    "ConcatDataset",
    "DataLoader",
    "NiftiImage",
    "Subset",
    "load_nifti",
    "load_nifti_header",
    "preprocess_ct",
    "preprocess_mri",
    "reorient_to_ras",
    "save_nifti",
    "seeded_subset",
]
