"""Datasets for the loader tests that worker processes import by name
(a spawned worker unpickles its dataset by module path)."""

from __future__ import annotations

import os

import numpy as np


class PidDataset:
    """Wraps a dataset; each sample also carries the pid that loaded it."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def load(self, index, epoch):
        return (*self.dataset.load(index, epoch), np.int64(os.getpid()))


class FailingDataset(PidDataset):
    """Raises on frame ``bad``."""

    def __init__(self, dataset, bad: int):
        super().__init__(dataset)
        self.bad = bad

    def load(self, index, epoch):
        if index == self.bad:
            raise ValueError(f"frame {index} is unreadable")
        return super().load(index, epoch)
