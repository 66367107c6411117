"""Video datasets: the synthetic videos that need no data on disk.

Port of the synthetic half of ``dfot_tpu/data/video_dataset.py``
(``SyntheticVideoDataset`` :389, the synthetic branch of ``build_dataset``
:443-458), in numpy as there. The on-disk datasets (npz/npy/mp4 clips,
latents, the per-dataset layouts) are queue item A12: a dataset directory
that exists raises, rather than being replaced by synthetic videos.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

__all__ = ["SyntheticVideoDataset", "build_dataset"]


class SyntheticVideoDataset:
    """Deterministic moving-gradient videos for tests and smoke runs."""

    def __init__(
        self,
        num_videos: int = 16,
        n_frames: int = 8,
        resolution: int = 16,
        channels: int = 3,
        cond_dim: int = 0,
        seed: int = 0,
    ):
        self.num_videos = num_videos
        self.n_frames = n_frames
        self.resolution = resolution
        self.channels = channels
        self.cond_dim = cond_dim
        self.seed = seed

    def __len__(self) -> int:
        return self.num_videos

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed + idx)
        r = self.resolution
        phase = rng.uniform(0, 2 * np.pi)
        speed = rng.uniform(0.1, 0.5)
        t = np.arange(self.n_frames)[:, None, None, None]
        yy = np.linspace(0, 2 * np.pi, r)[None, :, None, None]
        xx = np.linspace(0, 2 * np.pi, r)[None, None, :, None]
        video = 0.5 + 0.5 * np.sin(xx + yy + phase + speed * t)
        video = np.broadcast_to(video, (self.n_frames, r, r, self.channels))
        out = {
            "videos": video.astype(np.float32),
            "nonterminal": np.ones(self.n_frames, dtype=bool),
        }
        if self.cond_dim == 16:
            # valid RE10K-style camera poses: intrinsics + a smooth orbit
            # trajectory of orthonormal 3x4 extrinsics, so the quaternion /
            # SLERP pose math downstream stays well-posed
            K = np.asarray([0.8, 0.8, 0.5, 0.5], np.float32)
            conds = np.empty((self.n_frames, 16), np.float32)
            for t in range(self.n_frames):
                a = speed * 0.1 * t + phase * 0.01
                c, s = np.cos(a), np.sin(a)
                R = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
                T = np.asarray([0.1 * t, 0.0, 0.05 * t], np.float32)
                conds[t] = np.concatenate([K, np.concatenate([R, T[:, None]], 1).reshape(-1)])
            out["conds"] = conds
        elif self.cond_dim:
            out["conds"] = rng.randn(self.n_frames, self.cond_dim).astype(np.float32)
        return out


def build_dataset(cfg, split: str = "training", current_epoch: Optional[int] = None):
    """Dataset from the ``dataset`` config node: the synthetic videos when
    the dataset is ``synthetic`` or its directory is absent, as in the JAX
    package. ``current_epoch`` (sub-epoch slices of the training set) is for
    the on-disk datasets."""
    name = cfg.get("_name", "")
    if name == "synthetic" or not os.path.isdir(str(cfg.save_dir)):
        return SyntheticVideoDataset(
            num_videos=(
                256 if split == "training" else cfg.get("num_eval_videos") or 16
            ),
            # synthetic videos are emitted at token rate directly (no
            # frame_skip subsampling happens for them)
            n_frames=cfg.max_frames if split == "training" else cfg.n_frames,
            resolution=cfg.resolution,
            channels=cfg.observation_shape[0],
            cond_dim=cfg.external_cond_dim or 0,
        )
    raise NotImplementedError(
        f"dataset {name!r} at {cfg.save_dir}: on-disk video datasets are not ported yet "
        "(ROADMAP.md queue A12); move the directory away to run on synthetic videos"
    )
