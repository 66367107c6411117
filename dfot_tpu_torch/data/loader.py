"""Host batching of a dataset's numpy samples.

Port of ``dfot_tpu/data/loader.py``: ``DataLoader`` (:34) with its epoch
counter, the index order of ``_index_order`` (:66; shuffled by
``np.random.RandomState(seed + epoch)``), ``drop_last`` and ``len()``
(:56), and ``make_loader`` (:187). Batches are dicts of stacked numpy
arrays, made on the host in the calling thread when they are asked for
(the training loop copies each to the card without waiting for the
device, so the next batch is made while the device runs the step). Not
ported, and so raising with their ROADMAP.md queue item: per-process
shards (``process_shard``, A16) and the grain worker processes of
``num_workers > 0`` with ``shuffle`` (A12: grain's ``IndexSampler``
shuffles in another order). Unshuffled, grain's order is the dataset's,
so ``num_workers > 0`` with ``shuffle: false`` loads in this process, in
the same order.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["DataLoader", "make_loader"]


def _collate(items) -> Dict[str, np.ndarray]:
    return {key: np.stack([it[key] for it in items]) for key in items[0]}


class DataLoader:
    """Epoch batches of ``batch_size`` samples: the dataset's order or, with
    ``shuffle``, a permutation seeded by ``seed`` plus the epoch; the last
    short batch kept unless ``drop_last``. Each ``iter()`` is one epoch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 process_shard: Optional[Tuple[int, int]] = None):
        if process_shard is not None:
            raise NotImplementedError(
                "per-process data shards are multi-GPU work, not ported yet (ROADMAP.md queue A16)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        return order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._index_order()
        self.epoch += 1
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield _collate([self.dataset[int(i)] for i in idx])


def make_loader(dataset, batch_size: int, shuffle: bool = False, drop_last: bool = True,
                seed: int = 0, num_workers: int = 0,
                process_shard: Optional[Tuple[int, int]] = None) -> DataLoader:
    """The training loader (``dfot_tpu/data/loader.py:make_loader``), in
    this process; ``num_workers > 0`` only where that gives the same order
    (no shuffle)."""
    if num_workers and num_workers > 0 and shuffle:
        raise NotImplementedError(
            "shuffled loading in worker processes (grain's IndexSampler order) is not ported "
            "yet (ROADMAP.md queue A12); set experiment.training.data.num_workers=0 or "
            "shuffle=false")
    return DataLoader(dataset, batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed,
                      process_shard=process_shard)
