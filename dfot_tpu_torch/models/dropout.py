"""Dropout drawn for the global batch.

A JAX program under ``jit`` draws one dropout mask for the global batch; a
data rank of the port holds only its rows ``index::count`` of that batch
(``training/noise_levels.py:draw_rows``). Every random draw inside the
models goes through :func:`uniform`, which draws ``torch.rand`` for the
whole global batch (and, under tensor parallelism, for the whole width of a
sharded hidden) and takes this process's rows (and columns), so that the
processes together draw what one process draws for the global batch.

The draws come from the default generator, which the train step seeds from
(run seed, step) on every rank (``training/trainer.py``); so the stream is
the same on every rank, and ``torch.utils.checkpoint``, which restores the
default generators before it recomputes a block, replays the same masks.
The rows are set for the duration of a train step's forward and backward by
:func:`global_batch_rows`; outside one a process draws for its own batch.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch
from torch import nn

__all__ = ["global_batch_rows", "uniform", "Dropout"]

_ROWS = threading.local()


@contextlib.contextmanager
def global_batch_rows(rows: Optional[Tuple[int, int]]):
    """Context: the batch a model sees is the rows ``index::count`` of a
    global batch (``rows=(index, count)``; None: the batch is the whole)."""
    prev = getattr(_ROWS, "rows", None)
    _ROWS.rows = rows
    try:
        yield
    finally:
        _ROWS.rows = prev


def uniform(shape, device, columns: Optional[Tuple[torch.Tensor, int]] = None
            ) -> torch.Tensor:
    """``torch.rand(shape)`` from the default generator, drawn for the
    global batch (``count`` times ``shape[0]`` rows, this process's rows
    ``index::count`` kept) and, with ``columns=(index, width)``, for a last
    axis of ``width`` of which the columns ``index`` are kept."""
    shape = tuple(int(s) for s in shape)
    rows = getattr(_ROWS, "rows", None)
    full = shape
    if rows is not None:
        full = (shape[0] * rows[1],) + full[1:]
    if columns is not None:
        full = full[:-1] + (int(columns[1]),)
    u = torch.rand(full, device=device)
    if rows is not None:
        u = u[rows[0]::rows[1]]
    if columns is not None:
        u = u.index_select(-1, columns[0].to(u.device))
    return u


class Dropout(nn.Dropout):
    """``nn.Dropout`` whose mask is drawn by :func:`uniform`: zero with
    probability ``p`` in training mode, the rest scaled by 1 / (1 - p).
    ``columns`` (set by tensor parallelism) says which columns of a wider
    hidden this module's input holds."""

    columns: Optional[Tuple[torch.Tensor, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = uniform(x.shape, x.device, self.columns) >= self.p
        return x * keep.to(x.dtype) * (1.0 / (1.0 - self.p))
