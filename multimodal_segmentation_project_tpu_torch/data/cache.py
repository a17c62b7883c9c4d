"""Decode-once volume cache: mmap-able raw sidecars for .nii.gz sources.

The reference pipeline re-pays the full gzip inflate + preprocess cost
for every volume on every epoch and hides it behind DataLoader worker
processes (train_unet.py:372-374 of
fransiskusbudi/multimodal_segmentation_project). On a TPU host the
measured cost is ~226 ms/volume of zlib inflate at 192^3 — far below
the ~7 samples/s the train step can consume per decode core. This
module converts that into a ONE-TIME cost: the first touch of a volume
decodes + preprocesses and writes a raw ``.npy`` sidecar; every later
epoch memory-maps it and reads at page-cache/disk bandwidth.

Design:
  * one cache file per (source file, semantic tag): the tag encodes the
    preprocessing baked into the cached array (``img-ct`` = CT-windowed
    float32, ``img-mri`` = z-score+percentile float32, ``lbl-<remap>`` =
    harmonized int16), so the same source cached under different
    preprocessing never collides;
  * validation is by construction: the file NAME embeds the source's
    ``(st_mtime_ns, st_size)`` — a changed source simply misses and the
    stale sibling is pruned on the next write;
  * writes are atomic (tmp file + ``os.replace``) so concurrent loader
    threads/processes can only ever observe complete entries;
  * reads are ``np.load(mmap_mode="r")`` — zero decode, zero copy until
    the consumer touches pages;
  * every failure path (read-only data dir, ENOSPC, corrupt entry)
    degrades silently to the direct decode path: the cache can never
    make a previously-working pipeline fail.
"""

from __future__ import annotations

import glob
import hashlib
import os
import tempfile

import numpy as np

_FORMAT_VERSION = "v1"


def default_cache_dir(split_dir: str) -> str:
    """Cache location for a dataset split: ``$MMSEG_CACHE_DIR`` if set,
    else a dot-directory inside the split (skipped by the dataset's
    directory scan)."""
    env = os.environ.get("MMSEG_CACHE_DIR")
    if env:
        return env
    return os.path.join(str(split_dir), ".decoded_cache")


def cache_enabled() -> bool:
    return not os.environ.get("MMSEG_NO_CACHE")


def _entry_paths(cache_dir: str, src_path: str, tag: str):
    """(exact path for the current source stat, glob of all generations)."""
    src_path = os.path.abspath(src_path)
    h = hashlib.sha1(src_path.encode()).hexdigest()[:20]
    st = os.stat(src_path)
    stem = f"{h}-{tag}-{_FORMAT_VERSION}"
    exact = os.path.join(cache_dir, f"{stem}-{st.st_mtime_ns}-{st.st_size}.npy")
    pattern = os.path.join(cache_dir, f"{stem}-*.npy")
    return exact, pattern


class VolumeCache:
    """Per-directory decode cache. ``get`` returns the cached array when
    the source is unchanged, else calls ``decode`` and persists its
    result. A ``VolumeCache(None)`` is a no-op passthrough."""

    def __init__(self, cache_dir: str | None):
        self.cache_dir = cache_dir
        self.hits = 0
        self.misses = 0

    def get(self, src_path: str, tag: str, decode):
        if self.cache_dir is None:
            return decode()
        try:
            exact, pattern = _entry_paths(self.cache_dir, src_path, tag)
        except OSError:
            return decode()  # source un-stat-able; let decode() raise properly
        if os.path.exists(exact):
            try:
                arr = np.load(exact, mmap_mode="r")
                self.hits += 1
                return arr
            except (OSError, ValueError):
                pass  # corrupt/truncated entry: fall through to re-decode
        arr = decode()
        self.misses += 1
        self._store(exact, pattern, arr)
        return arr

    def _store(self, exact: str, pattern: str, arr: np.ndarray) -> None:
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=self.cache_dir, prefix=".tmp-", suffix=".npy"
            )
            try:
                with os.fdopen(fd, "wb") as f:
                    np.save(f, np.ascontiguousarray(arr))
                os.replace(tmp, exact)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            # prune stale generations of this (source, tag)
            for old in glob.glob(pattern):
                if old != exact:
                    try:
                        os.unlink(old)
                    except OSError:
                        pass
        except OSError:
            # read-only data dir / disk full: permanently fall back to
            # direct decode for this dataset instance
            self.cache_dir = None
