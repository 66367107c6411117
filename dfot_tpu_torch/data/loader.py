"""Host batching of a dataset's numpy samples.

Port of ``dfot_tpu/data/loader.py:DataLoader`` (:34) as validation uses it
(``shuffle=False``, ``drop_last=False``): the dataset's order, the last
batch kept when it is short, the same ``len()`` and the same dicts of
stacked numpy arrays. Samples are made in the calling thread, when the
batch is asked for: validation reads one batch per sampled window, so a
prefetch thread would hide nothing. Shuffled epochs, worker processes and
per-host shards come with the training loop and its data (ROADMAP.md queue
items A10, A12) and multi-GPU (A16).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["DataLoader"]


class DataLoader:
    """In-order batches of ``batch_size`` samples, the last one possibly
    shorter."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for b in range(len(self)):
            items = [self.dataset[i] for i in
                     range(b * self.batch_size, min((b + 1) * self.batch_size, len(self.dataset)))]
            yield {key: np.stack([it[key] for it in items]) for key in items[0]}
