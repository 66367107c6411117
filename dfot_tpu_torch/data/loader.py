"""Host batching of a dataset's numpy samples, in this process or in
worker processes.

Port of ``dfot_tpu/data/loader.py``. ``DataLoader`` (:34): epoch batches
made in the calling thread when they are asked for, the index order of
``_index_order`` (:66; shuffled by ``np.random.RandomState(seed +
epoch)``), ``drop_last`` and ``len()`` (:56). ``WorkerDataLoader``, the
counterpart of ``GrainDataLoader`` (:113): worker processes load the
samples (``torch.utils.data.DataLoader`` over the spawn context, its
workers kept from one epoch to the next), in the record order of grain's
``IndexSampler`` without sharding, one epoch at a time, seeded ``seed +
epoch`` (``data/index_shuffle.py``): the dataset's order unshuffled, grain's
permutation shuffled, so batches come in the JAX loader's order whatever the
worker count. The batches are stacked here, in the main process (:177-184),
and the worker count is capped at the number of full batches (:170). A
worker that dies raises in the loop that reads it. ``make_loader`` (:187)
picks the worker loader when ``num_workers > 0``.

``process_shard=(index, count)`` gives this process its share of every
epoch, disjoint from the other processes' and equal in length, as the JAX
loaders do (:19-26): ``DataLoader`` the strided slice ``index::count`` of
the epoch order (cut to a multiple of ``count`` under ``drop_last``, else
padded by wrapping, :45-80); ``WorkerDataLoader`` grain's
``ShardOptions(index, count, drop_remainder=True)`` (:131-150): the
``index``-th of ``count`` consecutive equal pieces of the records, shuffled
within the piece. ``batch_size`` is then the process's own batch.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from .index_shuffle import EpochOrder

__all__ = ["DataLoader", "WorkerDataLoader", "make_loader"]


def _collate(items) -> Dict[str, np.ndarray]:
    return {key: np.stack([it[key] for it in items]) for key in items[0]}


def _check_shard(process_shard) -> None:
    if process_shard is not None:
        index, count = process_shard
        if not 0 <= index < count:
            raise ValueError(f"process shard {index} outside {count} shards")


def _batch_count(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


class DataLoader:
    """Epoch batches of ``batch_size`` samples: the dataset's order or, with
    ``shuffle``, a permutation seeded by ``seed`` plus the epoch; the last
    short batch kept unless ``drop_last``. Each ``iter()`` is one epoch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 process_shard: Optional[Tuple[int, int]] = None):
        _check_shard(process_shard)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_shard = process_shard
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.process_shard is not None:
            count = self.process_shard[1]
            n = n // count if self.drop_last else -(-n // count)
        return _batch_count(n, self.batch_size, self.drop_last)

    def _index_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        if self.process_shard is not None:
            # one order on every process, then a strided slice each
            index, count = self.process_shard
            if self.drop_last:
                order = order[:len(order) // count * count]
            elif len(order) % count:
                order = np.concatenate([order, order[:count - len(order) % count]])
            order = order[index::count]
        return order

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = self._index_order()
        self.epoch += 1
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield _collate([self.dataset[int(i)] for i in idx])

    def close(self) -> None:
        """Nothing to release: the samples are made in this process."""


class _Sampler:
    """The current epoch's record order, read by the worker pool's sampler
    in the main process at the start of each epoch."""

    order: EpochOrder

    def __iter__(self):
        return iter(self.order)

    def __len__(self) -> int:
        return len(self.order)


class _ShardOrder:
    """One process's records of an epoch under grain's sharding with
    ``drop_remainder``: piece ``index`` of ``count`` equal consecutive pieces
    of the records, in the piece's own (shuffled) order."""

    def __init__(self, num_records: int, process_shard, shuffle: bool, seed: int):
        index, count = process_shard
        self.length = num_records // count
        self.start = index * self.length
        self.order = EpochOrder(self.length, shuffle, seed)

    def __len__(self) -> int:
        return self.length

    def __iter__(self):
        return (self.start + key for key in self.order)


def _identity(item):
    return item


class WorkerDataLoader:
    """Epoch batches of samples loaded by ``num_workers`` worker processes
    in grain's ``IndexSampler`` order; same protocol as :class:`DataLoader`.
    ``close()`` stops the workers."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, num_workers: int = 4,
                 process_shard: Optional[Tuple[int, int]] = None):
        self._pool = None
        _check_shard(process_shard)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_shard = process_shard
        self.workers = max(1, min(num_workers, len(dataset) // batch_size))
        self.epoch = 0
        self._sampler = _Sampler()

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.process_shard is not None:
            n //= self.process_shard[1]
        return _batch_count(n, self.batch_size, self.drop_last)

    def _loader(self):
        if self._pool is None:
            import torch.utils.data

            self._pool = torch.utils.data.DataLoader(
                self.dataset, batch_size=None, sampler=self._sampler,
                num_workers=self.workers, collate_fn=_identity,
                multiprocessing_context="spawn", persistent_workers=True)
        return self._pool

    def epoch_order(self):
        """The record order of the next epoch, this process's share."""
        seed = self.seed + self.epoch
        if self.process_shard is None:
            return EpochOrder(len(self.dataset), self.shuffle, seed)
        return _ShardOrder(len(self.dataset), self.process_shard, self.shuffle, seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        self._sampler.order = self.epoch_order()
        self.epoch += 1
        buf = []
        for item in self._loader():
            buf.append(item)
            if len(buf) == self.batch_size:
                yield _collate(buf)
                buf = []
        if buf and not self.drop_last:
            yield _collate(buf)

    def close(self) -> None:
        """Stop the worker processes (a later epoch starts new ones)."""
        pool, self._pool = self._pool, None
        if pool is not None and pool._iterator is not None:
            pool._iterator._shutdown_workers()


def make_loader(dataset, batch_size: int, shuffle: bool = False, drop_last: bool = True,
                seed: int = 0, num_workers: int = 0,
                process_shard: Optional[Tuple[int, int]] = None):
    """The training loader (``dfot_tpu/data/loader.py:make_loader``): worker
    processes when ``num_workers > 0``, else this process."""
    if num_workers and num_workers > 0:
        return WorkerDataLoader(dataset, batch_size, shuffle=shuffle, drop_last=drop_last,
                                seed=seed, num_workers=num_workers, process_shard=process_shard)
    return DataLoader(dataset, batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed,
                      process_shard=process_shard)
