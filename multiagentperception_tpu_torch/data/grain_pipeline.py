"""A deterministic, checkpointable batch stream (``training.data_backend:
grain``) on ``torch.utils.data``.

The port's counterpart of ``multiagentperception_tpu/data/grain_pipeline.py``
(:43-133): the class keeps JAX's name, constructor, ``__len__``,
``persistent_iterator``, ``get_state`` / ``set_state`` and ``shutdown``, so
``data_backend: grain`` finds it, but no grain is used: batches come from a
``torch.utils.data.DataLoader`` over a batch sampler of this module's.

- Order: epoch ``e`` visits the frames in ``numpy.random.default_rng(seed +
  e).permutation(n)`` with ``shuffle`` (JAX's per-epoch reshuffle by seed +
  epoch; grain's own ``index_shuffle`` order is that library's and is not
  reproduced), in index order without. ``drop_last`` drops each epoch's
  ragged tail.
- ``num_workers`` > 0 decodes in that many worker processes started with
  ``spawn`` (a process holding CUDA or JAX threads must not fork), kept
  alive across epochs; 0 decodes in the calling thread. A worker's error is
  raised where the batch is read. Each frame is loaded with its epoch
  (``dataset.load(index, epoch)`` where the dataset has it), so its noise
  and augmentations do not depend on which process loads it.
- State: ``{"seed", "epoch", "consumed"}``, the position of the persistent
  stream after the last batch it yielded. The epoch's order is a pure
  function of seed and epoch, so ``set_state`` skips to that batch without
  decoding the ones before it, in this loader or a fresh one.

Batches are tuples of stacked numpy arrays, as ``data.pipeline.DataLoader``
yields them. ``shard_by_process=True`` (``training.shard_data_by_process``)
gives each rank of the ``torch.distributed`` world a disjoint slice of the
frames, JAX's ``ShardByJaxProcess(drop_remainder=True)``: rank ``i`` of
``P`` takes frames ``[i * (n // P), (i + 1) * (n // P))`` (grain's
``even_split``; the remainder is dropped), and its epochs visit them in
``default_rng(seed + epoch)``'s permutation of the slice; each rank's
stream has its own position. ``shard_options=(index, count)`` gives the
slice explicitly.
"""

from __future__ import annotations

import multiprocessing

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.data


class _Source(torch.utils.data.Dataset):
    """The dataset, read by (index, epoch) keys."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, key):
        index, epoch = key
        load = getattr(self.dataset, "load", None)
        return load(index, epoch) if load is not None else self.dataset[index]


class _Keys(torch.utils.data.Sampler):
    """A batch sampler over the key batches it is given before each pass."""

    def __init__(self):
        super().__init__()
        self.batches: list[list[tuple[int, int]]] = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self) -> int:
        return len(self.batches)


def _collate(samples):
    """Stack each field; tensors, so that worker processes hand batches over
    through shared memory."""
    return tuple(torch.from_numpy(np.stack(field)) for field in zip(*samples))


class _Stream:
    """The endless iterator of ``persistent_iterator``: it follows the
    loader's position, and starts over from it after ``set_state``."""

    def __init__(self, loader: GrainLoader):
        self._loader = loader
        self._gen = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._gen is None:
            self._gen = self._loader._from_state()
        return next(self._gen)

    def restart(self) -> None:
        if self._gen is not None:
            self._gen.close()
            self._gen = None


class GrainLoader:
    """Drop-in replacement for ``data.pipeline.DataLoader`` with a
    checkpointable stream. ``num_epochs`` is accepted and unused, as in JAX
    (the persistent stream is endless; ``__iter__`` is one epoch)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 0, seed: int = 0,
                 num_epochs: int | None = None, shard_options=None,
                 shard_by_process: bool = False):
        if shard_options is None and shard_by_process and dist.is_initialized():
            shard_options = (dist.get_rank(), dist.get_world_size())
        self.shard = None if shard_options is None else tuple(int(v) for v in shard_options)
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = int(seed)
        self.num_workers = int(num_workers)
        self._epoch = 0  # __iter__'s next epoch
        self._state = {"seed": self.seed, "epoch": 0, "consumed": 0}
        self._it: _Stream | None = None
        self._loaders: dict[str, tuple[torch.utils.data.DataLoader, _Keys]] = {}

    def _frames(self) -> np.ndarray:
        """The frames this loader reads: all, or its rank's slice."""
        n = len(self.dataset)
        if self.shard is None:
            return np.arange(n)
        index, count = self.shard
        per = n // count
        return np.arange(index * per, (index + 1) * per)

    def __len__(self):
        n = len(self._frames())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def order(self, epoch: int) -> np.ndarray:
        """The frames of ``epoch`` in the order they are visited."""
        frames = self._frames()
        if not self.shuffle:
            return frames
        return frames[np.random.default_rng(self.seed + int(epoch)).permutation(len(frames))]

    def _key_batches(self, epoch: int, start: int) -> list:
        order = self.order(epoch)
        end = len(order) - len(order) % self.batch_size if self.drop_last else len(order)
        return [[(int(i), int(epoch)) for i in order[s:s + self.batch_size]]
                for s in range(0, end, self.batch_size)][start:]

    def _batches(self, which: str, epoch: int, start: int):
        """The batches of ``epoch`` from batch ``start``, through the torch
        loader ``which`` (one for ``__iter__``, one for the stream)."""
        if which not in self._loaders:
            keys = _Keys()
            kw = {}
            if self.num_workers > 0:
                kw = dict(num_workers=self.num_workers, persistent_workers=True,
                          multiprocessing_context=multiprocessing.get_context("spawn"))
            loader = torch.utils.data.DataLoader(_Source(self.dataset), batch_sampler=keys,
                                                 collate_fn=_collate, **kw)
            self._loaders[which] = (loader, keys)
        loader, keys = self._loaders[which]
        keys.batches = self._key_batches(epoch, start)
        for batch in loader:
            yield tuple(t.numpy() for t in batch)

    def __iter__(self):
        # one epoch, reshuffled per epoch (seed + epoch); the checkpointable
        # stream is persistent_iterator()
        epoch, self._epoch = self._epoch, self._epoch + 1
        return self._batches("epochs", epoch, 0)

    # --- checkpointable stream -------------------------------------------
    def _from_state(self):
        if len(self) == 0:
            raise ValueError(f"the stream has no batch: {len(self.dataset)} frames, batch "
                             f"{self.batch_size}, drop_last {self.drop_last}")
        while True:
            epoch, consumed = self._state["epoch"], self._state["consumed"]
            for batch in self._batches("stream", epoch, consumed):
                consumed += 1
                self._state = {"seed": self.seed, "epoch": epoch, "consumed": consumed}
                yield batch
            self._state = {"seed": self.seed, "epoch": epoch + 1, "consumed": 0}

    def persistent_iterator(self):
        """The endless, per-epoch reshuffled iterator whose position
        ``get_state`` / ``set_state`` save and restore; the trainer iterates
        this one and checkpoints its position with the train state, so a
        resumed run continues exactly mid-epoch."""
        if self._it is None:
            self._it = _Stream(self)
        return self._it

    def get_state(self) -> dict:
        """The persistent stream's position after its last yielded batch."""
        return dict(self._state)

    def set_state(self, state: dict) -> None:
        """Continue the persistent stream at ``state`` (seed included)."""
        self.seed = int(state["seed"])
        self._state = {"seed": self.seed, "epoch": int(state["epoch"]),
                       "consumed": int(state["consumed"])}
        if self._it is not None:
            self._it.restart()

    def shutdown(self) -> None:
        """Stop the worker processes and drop the stream's iterator (before
        an ``rss_limit_gb`` re-exec); a later ``persistent_iterator()``
        continues from the same position with fresh workers."""
        if self._it is not None:
            self._it.restart()
            self._it = None
        for loader, _ in self._loaders.values():
            workers = getattr(loader, "_iterator", None)
            if workers is not None and hasattr(workers, "_shutdown_workers"):
                workers._shutdown_workers()
            loader._iterator = None
        self._loaders.clear()
