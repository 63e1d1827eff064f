"""Host-side batching + prefetch (replaces torch DataLoader workers,
reference train.py:161-173).

The port's own copy of ``multiagentperception_tpu/data/pipeline.py``; keep
the two in step.

The decode path (cv2 PNG -> numpy) releases the GIL, so a thread pool gets
real parallel decode; a small prefetch queue keeps the device fed while the
current step runs. Batches come out as numpy arrays ready for a single
host->device transfer: images ``(B, N, H, W, 3)`` float32, labels
``(B, N, H, W)`` int32, and (optionally) communication labels. Each pass
tells a dataset that has ``set_epoch`` its epoch (0, 1, ...), from which
the port's dataset draws its noise and augmentations.

With ``shard=(index, count)`` (a data-parallel rank's place among
``count`` ranks) the loader decodes only rows ``[index * b/count, (index +
1) * b/count)`` of every global batch of ``b`` frames, in the order of the
seed and the epoch, and yields them as a ``ShardBatch``, which knows the
global batch's size; a batch that does not divide over ``count`` ranks (a
tail) comes whole on every rank, as JAX replicates it. The noise and
augmentation draws are generators of (seed, epoch, frame), the same on
every rank.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


class ShardBatch(tuple):
    """A batch's tuple of arrays holding one rank's rows of a global batch
    of ``global_size`` frames (all of them where it did not divide)."""

    global_size: int

    def __new__(cls, fields, global_size: int):
        out = super().__new__(cls, fields)
        out.global_size = int(global_size)
        return out

    @property
    def whole(self) -> bool:
        return len(self[0]) == self.global_size


class DataLoader:
    """Minimal shuffling batch loader over an indexable dataset;
    ``shard=(index, count)`` yields one rank's rows (module docstring)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        shard: tuple[int, int] | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)
        self._epoch = 0
        self.shard = shard

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        end = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        for s in range(0, end, self.batch_size):
            chunk = idx[s : s + self.batch_size]
            if len(chunk):
                yield chunk

    def _rows(self, chunk: np.ndarray) -> np.ndarray:
        """This rank's frames of a global batch (all of a tail that does not
        divide over the ranks)."""
        if self.shard is None:
            return chunk
        index, count = self.shard
        if len(chunk) % count:
            return chunk
        share = len(chunk) // count
        return chunk[index * share:(index + 1) * share]

    def _collate(self, samples):
        cols = list(zip(*samples))
        return tuple(np.stack(c, axis=0) for c in cols)

    def __iter__(self) -> Iterator:
        set_epoch = getattr(self.dataset, "set_epoch", None)
        if set_epoch is not None:
            set_epoch(self._epoch)
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for chunk in self._batches():
                    rows = self._rows(chunk)
                    batch = self._collate(list(pool.map(self.dataset.__getitem__, rows)))
                    q.put(batch if self.shard is None else ShardBatch(batch, len(chunk)))
            q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
