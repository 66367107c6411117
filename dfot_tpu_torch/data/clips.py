"""Clip indexing and sub-epoch resumable sampling: host index math.

Port of ``dfot_tpu/data/clips.py`` (the reference's indexing contract,
datasets/video/base_video.py:390-613), in numpy and Python's ``random`` as
there, with the same seeding, so both packages pick the same clips:

- each video of length L yields max(L - n_frames + 1, 1) clips,
- ``idx_remap`` maps dataset indices to absolute clip indices:
  * subdataset mode: epoch-seeded global shuffles sliced into contiguous
    ``subdataset_size`` windows (deterministic sub-epoch resume),
  * evaluation mode: one seeded random clip per video, shuffled, truncated
    to ``num_eval_videos``,
  * default: one fixed seeded shuffle,
- frame-skip condition stacking: each kept frame carries the conditions of
  its skipped predecessors.
"""

from __future__ import annotations

import bisect
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "cumulative_clip_sizes",
    "build_idx_remap",
    "clip_location",
    "stack_external_cond",
]


def cumulative_clip_sizes(video_lengths: Sequence[int], n_frames: int) -> List[int]:
    sizes = [max(l - n_frames + 1, 1) for l in video_lengths]
    return list(np.cumsum(sizes))


def build_idx_remap(
    cumulative_sizes: List[int],
    subdataset_size: Optional[int] = None,
    current_subepoch: Optional[int] = None,
    num_eval_videos: Optional[int] = None,
) -> List[int]:
    total = cumulative_sizes[-1]

    if subdataset_size is not None and current_subepoch is not None:
        def locate(idx: int) -> Tuple[int, int]:
            return divmod(idx + subdataset_size * current_subepoch, total)

        start_epoch, start_idx = locate(0)
        end_epoch, end_idx = locate(subdataset_size - 1)
        if not 0 <= end_epoch - start_epoch <= 1:
            raise ValueError("subdataset_size must be <= dataset size")
        shuffles = {}
        for epoch in range(start_epoch, end_epoch + 1):
            indices = list(range(total))
            random.seed(epoch)
            random.shuffle(indices)
            shuffles[epoch] = indices
        if start_epoch == end_epoch:
            return shuffles[start_epoch][start_idx : end_idx + 1]
        return shuffles[start_epoch][start_idx:] + shuffles[end_epoch][: end_idx + 1]

    if num_eval_videos is not None:
        random.seed(0)
        remap = [
            random.randrange(start, end)
            for start, end in zip([0] + cumulative_sizes[:-1], cumulative_sizes)
        ]
        random.shuffle(remap)
        return remap[:num_eval_videos]

    remap = list(range(total))
    random.seed(0)
    random.shuffle(remap)
    return remap


def clip_location(
    cumulative_sizes: List[int], idx_remap: List[int], idx: int
) -> Tuple[int, int]:
    """dataset index -> (video_idx, start_frame)."""
    idx = idx_remap[idx]
    video_idx = bisect.bisect_right(cumulative_sizes, idx)
    clip_idx = idx if video_idx == 0 else idx - cumulative_sizes[video_idx - 1]
    return video_idx, clip_idx


def stack_external_cond(cond: np.ndarray, frame_skip: int) -> np.ndarray:
    """(T, D) per-frame conditions -> (T//fs, fs*D): shift by fs-1 so each kept
    frame carries its own + preceding skipped actions
    (reference: base_video.py:597-613)."""
    if frame_skip == 1:
        return cond
    cond = np.pad(cond, ((frame_skip - 1, 0), (0, 0)))
    t = cond.shape[0] // frame_skip
    return cond[: t * frame_skip].reshape(t, frame_skip * cond.shape[1])
