"""Training-time clip augmentation.

Port of the RE10K half of ``dfot_tpu/data/augmentation.py``:
``re10k_augment`` (:401; horizontal flip with mirrored camera poses,
back-and-forth, reverse) and ``mirror_poses`` (:436), host numpy with the
caller's ``RandomState``, as there. The EDM ``AugmentPipe`` of the UCF-101
recipe is not ported (ROADMAP.md queue A12): building one raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["AugmentPipe", "re10k_augment", "mirror_poses"]


class AugmentPipe:
    """The EDM augmentation pipe: not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the EDM AugmentPipe (dataset.augmentation of the UCF-101 recipe) is not ported "
            "yet (ROADMAP.md queue A12)")


def re10k_augment(
    video: np.ndarray,
    poses: Optional[np.ndarray],
    rng: np.random.RandomState,
    horizontal_flip_prob: float = 0.0,
    reverse_prob: float = 0.0,
    back_and_forth_prob: float = 0.0,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """RE10K-style clip augmentation; poses (T, 16) = [K(4), E(12)] rows."""
    if horizontal_flip_prob > 0 and rng.rand() < horizontal_flip_prob:
        video = video[:, :, ::-1]
        if poses is not None:
            poses = mirror_poses(poses)
    if back_and_forth_prob > 0 and rng.rand() < back_and_forth_prob:
        # 0 1 2 ... 2k+1 -> 0 2 4 ... 2k 2k+1 ... 3 1: even frames forward,
        # then odd frames reversed (reference realestate10k.py:291-297) —
        # a same-length out-and-back walk through the camera trajectory
        T = len(video)
        idx = list(range(0, T, 2)) + list(range(T - 1 - (T % 2), 0, -2))
        video = video[idx]
        if poses is not None:
            poses = poses[idx]
    if reverse_prob > 0 and rng.rand() < reverse_prob:
        video = video[::-1]
        if poses is not None:
            poses = poses[::-1]
    return np.ascontiguousarray(video), (
        np.ascontiguousarray(poses) if poses is not None else None
    )


def mirror_poses(poses: np.ndarray) -> np.ndarray:
    """Mirror camera poses for a horizontally-flipped video.

    poses (..., 16): [fx, fy, cx, cy, E(3x4 row-major)]. Mirroring x
    negates the principal-point offset (cx -> 1 - cx for normalized
    intrinsics) and conjugates the extrinsics with diag(-1, 1, 1).
    """
    poses = np.array(poses, copy=True)
    poses[..., 2] = 1.0 - poses[..., 2]
    E = poses[..., 4:].reshape(poses.shape[:-1] + (3, 4))
    S = np.diag([-1.0, 1.0, 1.0]).astype(poses.dtype)
    R = E[..., :3]
    t = E[..., 3:]
    R2 = S @ R @ S
    t2 = S @ t
    poses[..., 4:] = np.concatenate([R2, t2], axis=-1).reshape(
        poses.shape[:-1] + (12,)
    )
    return poses
