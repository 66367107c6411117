"""Long-video planners: keyframes, interpolation chunks, sliding windows.

A numpy copy of ``dfot_tpu/sampling/planner.py`` (reachable there only
through ``dfot_tpu/sampling/__init__``, which imports jax);
``tests/test_torch_port_rollout.py`` holds it equal to the original.

Long videos are generated over a fixed ``max_tokens`` window:

1. a keyframe pass samples round(density * T) keyframes with a sliding
   window;
2. interpolation passes chunk the gaps between known frames greedily into
   ``max_tokens``-sized windows and infill each round's chunks together.

All of it is index math on the host, known before any window runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

__all__ = [
    "keyframe_indices",
    "interpolation_plan",
    "SlidingWindow",
    "sliding_window_plan",
    "pad_to_length",
]


def keyframe_indices(density: float, n_tokens: int, n_context_tokens: int) -> np.ndarray:
    """Evenly spaced keyframes at ``density``; the context tokens are always
    included."""
    if density > 1:
        raise ValueError("keyframe_density must be <= 1")
    if n_context_tokens > n_tokens:
        raise ValueError(
            f"n_context_tokens ({n_context_tokens}) exceeds the sequence "
            f"length ({n_tokens}) — lower dataset.context_length or raise "
            "n_frames"
        )
    num_key = int(round(density * n_tokens))
    keys = np.round(np.linspace(0, n_tokens - 1, num_key)).astype(np.int64)
    return np.unique(np.concatenate([np.arange(n_context_tokens), keys]))


def interpolation_plan(context_mask: np.ndarray, max_tokens: int) -> List[List[np.ndarray]]:
    """Greedy interpolation plan.

    context_mask: (T,) bool, True where the frame is known; the first and
    last frames must be known. Returns a list of rounds, each a list of
    frame-index arrays (each of length <= max_tokens) that can be infilled
    together; after a round its frames are known.
    """
    mask = context_mask.astype(bool).copy()
    if not (mask[0] and mask[-1]):
        raise ValueError("first and last frames must be known to interpolate")

    plan: List[List[np.ndarray]] = []
    while not mask.all():
        key_frames = np.flatnonzero(mask)
        current_plan: List[np.ndarray] = []
        current_chunk: Optional[np.ndarray] = None
        for left, right in zip(key_frames[:-1], key_frames[1:]):
            if current_chunk is not None:
                if len(current_chunk) + right - left <= max_tokens:
                    current_chunk = np.concatenate(
                        [current_chunk, np.arange(left + 1, right + 1)]
                    )
                    continue
                current_plan.append(current_chunk)
                current_chunk = None
            if right - left == 1:  # adjacent keys: nothing to fill
                continue
            if right - left >= max_tokens - 1:
                # too far apart: place max_tokens equally spaced frames
                current_plan.append(
                    np.round(np.linspace(left, right, max_tokens)).astype(np.int64)
                )
            else:
                current_chunk = np.arange(left, right + 1)
        if current_chunk is not None:
            current_plan.append(current_chunk)
        for frames in current_plan:
            mask[frames] = True
        plan.append(current_plan)
    return plan


@dataclass(frozen=True)
class SlidingWindow:
    """One window of the sliding-window rollout: [last ``context_len`` known
    tokens | ``gen_len`` new tokens], padded to the horizon by the sampler."""

    context_len: int            # reused tokens from what exists so far
    gen_len: int                # new tokens generated by this window
    start_token: int            # index of the first context token in the sequence
    generated_context_len: int  # context tokens that were generated: mask code 2

    @property
    def length(self) -> int:
        return self.context_len + self.gen_len


def sliding_window_plan(
    gt_len: int,
    length: int,
    max_tokens: int,
    sliding_context_len: Optional[int] = None,
    chunk_size: int = -1,
    use_causal_mask: bool = False,
) -> List[SlidingWindow]:
    """Plan the sliding-window rollout from ``gt_len`` ground-truth context
    tokens to ``length`` tokens."""
    if sliding_context_len is None:
        if max_tokens < length:
            raise ValueError("length > max_tokens requires sliding_context_len")
        sliding_context_len = max_tokens - 1
    if sliding_context_len == -1:
        sliding_context_len = max_tokens - 1
    if sliding_context_len < gt_len:
        raise ValueError(
            f"sliding_context_len ({sliding_context_len}) must be >= initial "
            f"context length ({gt_len})"
        )
    eff_chunk = chunk_size if use_causal_mask else max_tokens

    windows: List[SlidingWindow] = []
    curr_token = gt_len
    while curr_token < length:
        c = min(sliding_context_len, curr_token)
        h = min(length - curr_token, max_tokens - c)
        if eff_chunk > 0:
            h = min(h, eff_chunk)
        generated_len = curr_token - max(curr_token - c, gt_len)
        windows.append(SlidingWindow(
            context_len=c, gen_len=h, start_token=curr_token - c,
            generated_context_len=generated_len,
        ))
        curr_token += h
    return windows


def pad_to_length(x: np.ndarray, length: int, axis: int = 0, value=0) -> np.ndarray:
    """Pad along ``axis`` to ``length`` with a constant."""
    cur = x.shape[axis]
    if cur >= length:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, length - cur)
    return np.pad(x, widths, constant_values=value)
