"""Host data pipeline: shuffling, batching, threaded prefetch, the upload.

A copy of the JAX package's ``data/pipeline.py`` loader (the port keeps
its own host data stack). The loader is IO-bound (gzip inflate + disk),
so a small thread pool with a bounded prefetch queue overlaps host IO
with device compute without fork overhead. :func:`upload` (which the
trainer calls) and :func:`prefetch_to_device` copy each batch from pinned
memory with a non-blocking copy, so the copy overlaps the host's next
decode; on a mesh (``parallel/mesh.py``) each rank uploads only its slice.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from multimodal_segmentation_project_tpu_torch.parallel.mesh import shard_batch_arrays
from multimodal_segmentation_project_tpu_torch.utils.spans import span


def _collate(samples):
    images = np.stack([s[0] for s in samples])
    labels = np.stack([s[1] for s in samples])
    return images, labels


class DataLoader:
    """Iterable over (images, labels) numpy batches with threaded prefetch.

    Args:
      dataset: indexable returning (image (1,D,H,W) f32, label (D,H,W) i32).
      batch_size: samples per global batch.
      shuffle: reshuffle indices every epoch.
      seed: base seed for the epoch shuffles (epoch-dependent stream).
      num_workers: loader threads (0 = synchronous).
      drop_last: drop the trailing partial batch. For pjit training keep
        True so the global batch is always divisible by the mesh.
      prefetch: max ready batches held in the queue.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int | None = None,
        num_workers: int = 2,
        drop_last: bool = False,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Draw ``epoch``'s shuffle on the next iteration (a resumed run
        starts at its epoch; an uninterrupted one is there already)."""
        self._epoch = epoch

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            seed = None if self.seed is None else self.seed + self._epoch
            np.random.default_rng(seed).shuffle(idx)
        return idx

    def __iter__(self):
        indices = self._epoch_indices()
        self._epoch += 1
        batches = [
            indices[i : i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if self.num_workers <= 0:
            for b in batches:
                with span("data.wait"):
                    batch = _collate([self.dataset[int(i)] for i in b])
                yield batch
            return

        yield from self._prefetch_iter(batches)

    def _prefetch_iter(self, batches):
        job_q: queue.Queue = queue.Queue()
        n_batches = len(batches)
        results: dict[int, object] = {}
        lock = threading.Lock()
        stop = threading.Event()
        progress = {"next": 0}
        cap = max(self.prefetch, 1)

        for i, b in enumerate(batches):
            job_q.put((i, b))

        def worker():
            while not stop.is_set():
                try:
                    i, b = job_q.get_nowait()
                except queue.Empty:
                    return
                # backpressure: never decode more than `prefetch` batches
                # ahead of the consumer — decoded 192^3 volumes are tens
                # of MB each, so an unbounded ready-set OOMs the host on
                # long epochs. Workers pull jobs in order, so at most
                # (prefetch + num_workers) batches are decoded-or-in-flight.
                while not stop.is_set() and i - progress["next"] >= cap:
                    stop.wait(0.005)
                if stop.is_set():
                    return
                try:
                    batch = _collate([self.dataset[int(j)] for j in b])
                except Exception as e:  # surface loader errors to the consumer
                    batch = e
                with lock:
                    results[i] = batch

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(min(self.num_workers, n_batches) or 1)
        ]
        for t in threads:
            t.start()

        try:
            while progress["next"] < n_batches:
                with span("data.wait"):
                    while True:
                        with lock:
                            batch = results.pop(progress["next"], None)
                        if batch is not None:
                            break
                        stop.wait(0.005)
                if isinstance(batch, Exception):
                    raise batch
                yield batch
                progress["next"] += 1
        finally:
            stop.set()



def upload(arrays, device, mesh=None) -> list:
    """numpy arrays -> tensors on ``device``, each through pinned memory with
    a non-blocking copy on CUDA; with ``mesh``, this rank's slice of each
    (``parallel.mesh.batch_sharding``)."""
    device = torch.device(device)
    out = []
    with span("data.upload"):
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(
                a if mesh is None else shard_batch_arrays(mesh, a)))
            if device.type == "cuda":
                t = t.pin_memory()
            out.append(t.to(device, non_blocking=True))
    return out


def prefetch_to_device(iterator, sharding=None, device="cuda"):
    """(images, labels) numpy batches -> device tensors, each uploaded by
    :func:`upload` as the iterator yields it: the copy of one batch runs
    while the caller computes on the one before. ``sharding`` is a
    ``parallel.mesh.Mesh``: each rank uploads its slice of the global
    batch, the JAX ``prefetch_to_device``'s split over the data axis."""
    for images, labels in iterator:
        yield tuple(upload((images, labels), device, sharding))
