"""Dataset layer: directory scanning, modality routing, normalization,
label harmonization.

Capability parity with the reference CombinedDataset
(utils/dataloader.py:17-204 of fransiskusbudi/multimodal_segmentation_project):

  * walks ``split_dir/<dataset>/{images,labels}`` pairs, sorted;
  * modality inferred from the dataset directory suffix ``_ct`` /
    ``_mri`` (default mri for unknown names, utils/dataloader.py:97-109);
  * CT normalization: abdominal HU window [-160, 240] -> [0, 1]
    (utils/dataloader.py:111-117);
  * MRI normalization: z-score -> clip to [1st, 99th] percentile ->
    min-max to [0, 1] (utils/dataloader.py:128-144);
  * label harmonization to {0:bg, 1:spleen, 2:liver, 3:kidneys}:
    AMOS index remap, CHAOS ranged-intensity remap, TotalSegmentator /
    BTCV passthrough (utils/dataloader.py:43-58, 162-185).

Differences from the reference (deliberate):
  * pure numpy host code, no torch tensors, no internal Accelerator()
    instance (the reference constructs one just to gate prints,
    utils/dataloader.py:34);
  * samples are returned CHANNEL-FIRST ``(1, D, H, W)`` float32 image
    + ``(D, H, W)`` int32 label — the reference's torch layout, which
    is also TPU-storage-friendly (spatial dims minor);
  * augmentation happens on-device inside the jitted train step
    (ops/augment.py), not here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from multimodal_segmentation_project_tpu_torch.data import native
from multimodal_segmentation_project_tpu_torch.data.cache import (
    VolumeCache,
    cache_enabled,
    default_cache_dir,
)
from multimodal_segmentation_project_tpu_torch.data.nifti import load_nifti

# AMOS label ids -> harmonized classes (utils/dataloader.py:43-49)
AMOS_MAPPING = {0: 0, 1: 1, 2: 3, 3: 3, 6: 2}

# CHAOS intensity ranges -> harmonized classes (utils/dataloader.py:167-181)
CHAOS_RANGES = (
    ((55, 70), 2),  # liver
    ((110, 135), 3),  # right kidney -> kidneys
    ((175, 200), 3),  # left kidney -> kidneys
    ((240, 255), 1),  # spleen
)


def preprocess_ct(image: np.ndarray) -> np.ndarray:
    """Abdominal window [-160, 240] HU -> [0, 1] (utils/dataloader.py:111-117)."""
    lo, hi = -160.0, 240.0
    image = np.clip(image, lo, hi)
    return ((image - lo) / (hi - lo)).astype(np.float32)


def preprocess_mri(image: np.ndarray) -> np.ndarray:
    """Z-score -> percentile clip [1, 99] -> min-max (utils/dataloader.py:128-144)."""
    image = np.asarray(image, dtype=np.float64)
    image = (image - image.mean()) / (image.std() + 1e-8)
    lo, hi = np.percentile(image, [1, 99])
    image = np.clip(image, lo, hi)
    return ((image - lo) / (hi - lo + 1e-8)).astype(np.float32)


def harmonize_labels(label: np.ndarray, dataset_name: str) -> np.ndarray:
    """Map a dataset's native labels to {0,1,2,3} (utils/dataloader.py:162-185)."""
    name = dataset_name.lower()
    if name.startswith("amos"):
        out = np.zeros_like(label)
        for old, new in AMOS_MAPPING.items():
            out[label == old] = new
        return out
    if name.startswith("chaos"):
        out = np.zeros_like(label)
        for (lo, hi), new in CHAOS_RANGES:
            out[(label >= lo) & (label <= hi)] = new
        return out
    # ts* / btcv labels are already harmonized
    return label


def modality_of(dataset_name: str) -> str:
    """'ct' or 'mri' from the dataset directory suffix (default mri)."""
    name = dataset_name.lower()
    if name.endswith("_ct"):
        return "ct"
    if name.endswith("_mri"):
        return "mri"
    return "mri"


@dataclass(frozen=True)
class Sample:
    image_path: str
    label_path: str
    dataset_name: str


class CombinedDataset:
    """Aggregates ``split_dir/<dataset>/{images,labels}`` across datasets."""

    def __init__(self, split_dir, modalities=None, verbose=True, cache="auto"):
        """``cache``: "auto" (default) caches decoded volumes as raw
        mmap-able sidecars under ``default_cache_dir(split_dir)`` —
        the first epoch decodes, later epochs read at page-cache speed
        (see data/cache.py); a path uses that directory; None/False
        disables. ``MMSEG_NO_CACHE=1`` force-disables "auto"."""
        self.split_dir = str(split_dir)
        self.modalities = (
            [m.lower() for m in modalities] if modalities is not None else None
        )
        if cache == "auto":
            cache_dir = default_cache_dir(self.split_dir) if cache_enabled() else None
        elif cache:
            cache_dir = str(cache)
        else:
            cache_dir = None
        self.cache = VolumeCache(cache_dir)
        self.samples: list[Sample] = []

        for dataset_name in sorted(os.listdir(self.split_dir)):
            if dataset_name.startswith("."):
                continue  # dot-dirs (incl. the decode cache) are not datasets
            if self.modalities is not None and modality_of(dataset_name) not in self.modalities:
                if verbose:
                    print(
                        f"Skipping dataset {dataset_name}: modality "
                        f"'{modality_of(dataset_name)}' not in {self.modalities}"
                    )
                continue
            images_dir = os.path.join(self.split_dir, dataset_name, "images")
            labels_dir = os.path.join(self.split_dir, dataset_name, "labels")
            if not (os.path.isdir(images_dir) and os.path.isdir(labels_dir)):
                if verbose:
                    print(f"Skipping dataset {dataset_name}: missing images or labels dir")
                continue
            image_files = sorted(os.listdir(images_dir))
            label_files = sorted(os.listdir(labels_dir))
            if len(image_files) != len(label_files):
                raise ValueError(f"image/label count mismatch in {dataset_name}")
            for img, lbl in zip(image_files, label_files):
                self.samples.append(
                    Sample(
                        os.path.join(images_dir, img),
                        os.path.join(labels_dir, lbl),
                        dataset_name,
                    )
                )
        if verbose:
            mod = f"modalities {self.modalities}" if self.modalities else "all modalities"
            print(f"Loaded {len(self.samples)} samples from {self.split_dir} ({mod})")

    def __len__(self) -> int:
        return len(self.samples)

    def _decode_image(self, s: Sample, is_ct: bool) -> np.ndarray:
        # native C++ fast path: decode + (for CT) fused window normalize
        norm = native.NORM_CT_WINDOW if is_ct else native.NORM_NONE
        loaded = native.load_nifti_f32(s.image_path, norm_mode=norm)
        if loaded is not None:
            image = loaded[0]
            if not is_ct:
                image = preprocess_mri(image)
        else:
            image = load_nifti(s.image_path).data.astype(np.float32)
            image = preprocess_ct(image) if is_ct else preprocess_mri(image)
        return image

    def _decode_label(self, s: Sample) -> np.ndarray:
        lloaded = native.load_nifti_f32(s.label_path)
        if lloaded is not None:
            label = lloaded[0].astype(np.int64)
        else:
            label = load_nifti(s.label_path).data.astype(np.int64)
        label = harmonize_labels(label, s.dataset_name)
        # harmonized classes are {0..3}; int16 halves the sidecar size
        # (kept int32 if exotic passthrough labels overflow)
        if label.size and label.max(initial=0) < 2**15 and label.min(initial=0) >= -(2**15):
            return label.astype(np.int16)
        return label.astype(np.int32)

    def __getitem__(self, idx: int):
        s = self.samples[idx]
        is_ct = modality_of(s.dataset_name) == "ct"
        img_tag = "img-ct" if is_ct else "img-mri"
        name = s.dataset_name.lower()
        lbl_tag = (
            "lbl-amos" if name.startswith("amos")
            else "lbl-chaos" if name.startswith("chaos")
            else "lbl-id"
        )
        image = self.cache.get(
            s.image_path, img_tag, lambda: self._decode_image(s, is_ct)
        )
        label = self.cache.get(s.label_path, lbl_tag, lambda: self._decode_label(s))

        # channel-first: (1, D, H, W) image, (D, H, W) int32 label
        return image[None], np.asarray(label, dtype=np.int32)


class Subset:
    """Index-based view of a dataset (torch.utils.data.Subset analog)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(int(i) for i in indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    @property
    def samples(self):
        return [self.dataset.samples[i] for i in self.indices]


class ConcatDataset:
    """Concatenation of datasets (torch.utils.data.ConcatDataset analog)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        for d in self.datasets:
            if idx < len(d):
                return d[idx]
            idx -= len(d)
        raise IndexError(idx)

    @property
    def samples(self):
        out = []
        for d in self.datasets:
            out.extend(d.samples)
        return out


def seeded_subset(dataset, n_samples: int | None, seed: int | None):
    """Reference n-sample subsetting: seeded rng.choice without replacement
    (train_unet.py:365-370)."""
    if n_samples is None or n_samples >= len(dataset):
        return dataset
    rng = np.random.default_rng(seed) if seed is not None else np.random.default_rng()
    indices = rng.choice(len(dataset), size=n_samples, replace=False)
    return Subset(dataset, indices)
