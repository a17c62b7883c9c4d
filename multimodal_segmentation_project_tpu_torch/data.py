"""The host-side data stack, shared with the JAX package.

NIfTI IO, the datasets and their preprocessing, the threaded loader
(``multimodal_segmentation_project_tpu/data/``) and the CLI parsers of
``workloads/common.py`` import only numpy, ctypes and gzip at module level,
so the port uses them as they are instead of keeping a copy. This module is
the one place the port takes code from the JAX package.
"""

from multimodal_segmentation_project_tpu.data.dataset import CombinedDataset, preprocess_ct
from multimodal_segmentation_project_tpu.data.nifti import (
    load_nifti,
    load_nifti_header,
    save_nifti,
)
from multimodal_segmentation_project_tpu.data.pipeline import DataLoader
from multimodal_segmentation_project_tpu.workloads.common import (
    parse_features,
    parse_modalities,
)

__all__ = [
    "CombinedDataset",
    "DataLoader",
    "load_nifti",
    "load_nifti_header",
    "parse_features",
    "parse_modalities",
    "preprocess_ct",
    "save_nifti",
]
