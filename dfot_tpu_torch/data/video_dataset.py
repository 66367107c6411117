"""Video datasets: clips of on-disk videos, and synthetic videos.

Port of ``dfot_tpu/data/video_dataset.py``. Storage contract (the
reference's layout, datasets/video/base_video.py:18-264):
``{save_dir}/{split}/`` holds one file per video; the metadata (paths and
lengths, and per-frame timestamps of video containers) is scanned once and
cached in ``{save_dir}/metadata/{split}.npz``; pre-sampled latents live in
``{save_dir}_latent_{resolution}/{split}/{stem}.npy`` (channel-last, as
``experiments/video_latent_preprocessing.py`` writes them).

Formats: ``.npz`` with a ``video`` array (T, H, W, C) uint8 and optional
``actions``/``conds``/``poses``; ``.npy`` video arrays; ``.mp4``, ``.avi``,
``.mov``, ``.mkv`` and ``.webm`` decoded with OpenCV and rescaled and
center-cropped to the dataset resolution (``cv2`` is imported where such a
file is read: without it that read raises ``ImportError``). Training clips
go through ``re10k_augment`` (the RE10K keys), the EDM ``AugmentPipe`` (any
other ``augmentation`` dict, the UCF-101 recipe's) or the legacy
``augmentation_prob`` subset, each clip's ``RandomState`` seeded from its
index as in the JAX package. ``SyntheticVideoDataset``
makes deterministic moving-gradient videos; ``build_dataset`` returns it
when the dataset is ``synthetic`` or its directory is absent, else the
dataset's layout class (``data/layouts.py``), as the JAX package does.
Samples are dicts of numpy arrays, made on the host.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from .clips import (
    build_idx_remap,
    clip_location,
    cumulative_clip_sizes,
    stack_external_cond,
)

__all__ = ["VideoDataset", "SyntheticVideoDataset", "build_dataset", "rescale_and_crop"]

_VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def _cv2():
    """OpenCV, imported where a video file is read; its absence raises."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "reading a video file (.mp4/.avi/.mov/.mkv/.webm) needs OpenCV, the cv2 module, "
            "which is not installed; store the videos as .npz or .npy instead") from e
    return cv2


def rescale_and_crop(video: np.ndarray, resolution: int) -> np.ndarray:
    """(T, H, W, C) uint8 -> (T, resolution, resolution, C): short side scaled
    to `resolution`, center-cropped (reference utils/transform.py:90-110)."""
    cv2 = _cv2()

    t, h, w, c = video.shape
    scale = max(resolution / h, resolution / w)
    hs, ws = round(h * scale), round(w * scale)
    out = np.empty((t, resolution, resolution, c), dtype=video.dtype)
    row = (hs - resolution) // 2
    col = (ws - resolution) // 2
    for i in range(t):
        f = cv2.resize(video[i], (ws, hs), interpolation=cv2.INTER_AREA)
        out[i] = f[row : row + resolution, col : col + resolution]
    return out


def _mp4_length(path: str) -> int:
    cv2 = _cv2()

    cap = cv2.VideoCapture(path)
    try:
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()
    return n


def video_timestamps(path: str) -> tuple:
    """Per-frame presentation timestamps + fps for one video file.

    Counterpart of the reference's metadata build step
    (datasets/video/base_video.py:95-160, via torchvision
    read_video_timestamps): returns (pts_ms float64 (N,), fps float).
    Walks the container with grab() (no pixel decode), so variable-frame-
    rate files get their true timestamps rather than frame_index / fps.
    """
    cv2 = _cv2()

    cap = cv2.VideoCapture(path)
    pts = []
    try:
        fps = float(cap.get(cv2.CAP_PROP_FPS)) or 0.0
        while cap.grab():
            pts.append(cap.get(cv2.CAP_PROP_POS_MSEC))
    finally:
        cap.release()
    return np.asarray(pts, np.float64), fps


def _mp4_read(path: str, start: int, end: int) -> np.ndarray:
    """Decode frames [start, end) as (N, H, W, 3) RGB uint8."""
    cv2 = _cv2()

    cap = cv2.VideoCapture(path)
    try:
        if start:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        frames = []
        for _ in range(end - start):
            ok, f = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    return np.stack(frames)


class VideoDataset:
    """Clip-sampling dataset over variable-length videos.

    Returns dicts of numpy arrays:
      videos      (T, H, W, C) float32 in [0, 1]  (unless latent-only training)
      latents     (T, h, w, c) float32            (if latents enabled)
      conds       (T, D) float32                  (if external conditioning)
      nonterminal (T,) bool                       (False on padding frames)
    """

    def __init__(self, cfg, split: str = "training", current_epoch: Optional[int] = None):
        self.cfg = cfg
        self.split = split
        self.save_dir = str(cfg.save_dir)
        self.resolution = cfg.resolution
        self.frame_skip = cfg.frame_skip
        self.external_cond_dim = cfg.external_cond_dim or 0
        self.external_cond_stack = bool(cfg.get("external_cond_stack", False))
        self.latent_enabled = bool(cfg.latent.enabled)
        self.latent_pre_sampled = self.latent_enabled and str(
            cfg.latent.type
        ).startswith("pre_")

        n_tokens = cfg.max_frames if split == "training" else cfg.n_frames
        self.n_frames = 1 + (n_tokens - 1) * cfg.frame_skip

        self.metadata = self._load_metadata()
        min_len = (
            self.n_frames
            if split == "training" or cfg.filter_min_len is None
            else cfg.filter_min_len
        )
        self.metadata = [m for m in self.metadata if m["length"] >= min_len]
        if not self.metadata:
            raise FileNotFoundError(
                f"no videos of length >= {min_len} under {self.save_dir}/{split}"
            )

        self.cumulative_sizes = cumulative_clip_sizes(
            [m["length"] for m in self.metadata], self.n_frames
        )
        sub = cfg.get("subdataset_size")
        sub = None if isinstance(sub, str) else sub  # '???' placeholder
        self.idx_remap = build_idx_remap(
            self.cumulative_sizes,
            subdataset_size=sub if split == "training" else None,
            current_subepoch=current_epoch if split == "training" else None,
            num_eval_videos=cfg.get("num_eval_videos") if split != "training" else None,
        )

    # -- metadata ----------------------------------------------------------
    def _split_dir(self) -> str:
        return os.path.join(self.save_dir, self.split)

    def _keep_file(self, name: str) -> bool:
        """Layout-adapter hook: skip non-video sibling files in the walk."""
        return True

    def _load_metadata(self) -> List[Dict[str, Any]]:
        # cache keys on the WALKED DIRECTORY's name, not the bare split:
        # layouts whose _split_dir embeds the resolution (RE10K
        # training_64/ vs training_256/) must not serve each other's file
        # lists when dataset.resolution changes
        cache = os.path.join(
            self.save_dir, "metadata",
            f"{os.path.basename(self._split_dir())}.npz",
        )
        if os.path.exists(cache):
            data = np.load(cache, allow_pickle=True)
            metadata = [
                {"path": str(p), "length": int(l)}
                for p, l in zip(data["paths"], data["lengths"])
            ]
            # pts/fps present only in caches built from video containers
            # (older caches carry paths+lengths only — stay loadable)
            if "fps" in data:
                offsets = data["pts_offsets"]
                for i, m in enumerate(metadata):
                    m["fps"] = float(data["fps"][i])
                    m["pts"] = data["pts"][offsets[i] : offsets[i + 1]]
            return metadata
        split_dir = self._split_dir()
        if not os.path.isdir(split_dir):
            raise FileNotFoundError(f"dataset split directory not found: {split_dir}")
        # per-frame pts build (reference base_video.py:95-160) walks every
        # container with grab(); opt out via dataset.metadata_timestamps=false
        want_pts = bool(self.cfg.get("metadata_timestamps", True))
        metadata = []
        for root, _dirs, files in sorted(os.walk(split_dir)):
            for name in sorted(files):
                if not self._keep_file(name):
                    continue
                path = os.path.join(root, name)
                if name.endswith(".npz"):
                    with np.load(path) as z:
                        length = z["video"].shape[0]
                elif name.endswith(".npy"):
                    length = np.load(path, mmap_mode="r").shape[0]
                elif name.lower().endswith(_VIDEO_EXTS):
                    if want_pts:
                        pts, fps = video_timestamps(path)
                        metadata.append(
                            {"path": path, "length": len(pts), "fps": fps, "pts": pts}
                        )
                        continue
                    length = _mp4_length(path)
                else:
                    continue
                metadata.append({"path": path, "length": length})
        os.makedirs(os.path.join(self.save_dir, "metadata"), exist_ok=True)
        arrays = {
            "paths": np.asarray([m["path"] for m in metadata]),
            "lengths": np.asarray([m["length"] for m in metadata]),
        }
        if any("pts" in m for m in metadata):
            pts_list = [np.asarray(m.get("pts", []), np.float64) for m in metadata]
            arrays["fps"] = np.asarray([m.get("fps", 0.0) for m in metadata])
            arrays["pts"] = (
                np.concatenate(pts_list) if pts_list else np.zeros(0)
            )
            arrays["pts_offsets"] = np.cumsum([0] + [len(p) for p in pts_list])
        # written whole, then renamed: the processes of a multi-process run
        # build the same cache at once, and a reader must not find half a file
        tmp = f"{cache}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, cache)
        return metadata

    # -- loading -----------------------------------------------------------
    def _load_video(self, meta, start: int, end: int) -> np.ndarray:
        path = meta["path"]
        if path.endswith(".npz"):
            with np.load(path) as z:
                video = z["video"][start:end]
        elif path.lower().endswith(_VIDEO_EXTS):
            video = _mp4_read(path, start, end)
            if video.shape[1] != self.resolution or video.shape[2] != self.resolution:
                video = rescale_and_crop(video, self.resolution)
        else:
            video = np.load(path, mmap_mode="r")[start:end]
        video = np.asarray(video)
        if video.dtype == np.uint8:
            video = video.astype(np.float32) / 255.0
        return video

    def _load_cond(self, meta, start: int, end: int) -> Optional[np.ndarray]:
        if not self.external_cond_dim:
            return None
        cond_type = self.cfg.get("external_cond_type")
        path = meta["path"]
        if cond_type == "label":
            # per-video class label: npz 'label' key, else parent class dir
            if path.endswith(".npz"):
                with np.load(path) as z:
                    if "label" in z:
                        return np.asarray(z["label"], dtype=np.int32).reshape(())
            return np.asarray(self._dir_label(path), dtype=np.int32).reshape(())
        if path.endswith(".npz"):
            with np.load(path) as z:
                # actions (DMLab/Minecraft/BAIR) or raw camera poses (RE10K:
                # intrinsics + flattened 3x4 extrinsics per frame)
                for key in ("actions", "conds", "poses"):
                    if key in z:
                        return z[key][start:end].astype(np.float32)
        raise FileNotFoundError(f"no conditions found in {path}")

    def _dir_label(self, path: str) -> int:
        """Class index from the parent directory name (UCF-101 layout)."""
        if not hasattr(self, "_class_to_idx"):
            split_dir = self._split_dir()
            classes = sorted(
                {os.path.basename(os.path.dirname(m["path"])) for m in self.metadata}
            )
            self._class_to_idx = {c: i for i, c in enumerate(classes)}
        return self._class_to_idx[os.path.basename(os.path.dirname(path))]

    def _load_latent(self, meta, start: int, end: int) -> np.ndarray:
        latent_dir = f"{self.save_dir}_latent_{self.resolution}"
        base = os.path.splitext(os.path.basename(meta["path"]))[0]
        path = os.path.join(latent_dir, self.split, base + ".npy")
        return np.load(path, mmap_mode="r")[start:end].astype(np.float32)

    # -- dataset protocol ----------------------------------------------------
    def __len__(self) -> int:
        return len(self.idx_remap)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        video_idx, start = clip_location(self.cumulative_sizes, self.idx_remap, idx)
        meta = self.metadata[video_idx]
        end = min(start + self.n_frames, meta["length"])

        out: Dict[str, np.ndarray] = {}
        video = latent = cond = None
        if self.latent_pre_sampled:
            latent = self._load_latent(meta, start, end)
            if self.split != "training":
                video = self._load_video(meta, start, end)
            if self.external_cond_dim:
                cond = self._load_cond(meta, start, end)
        else:
            video = self._load_video(meta, start, end)
            if self.external_cond_dim:
                cond = self._load_cond(meta, start, end)

        # training-time augmentation (consistent with camera poses when present)
        if self.split == "training":
            aug = self.cfg.get("augmentation")
            aug_prob = self.cfg.get("augmentation_prob", 0.0) or 0.0
            rng = np.random.RandomState((idx * 2654435761 + 12345) % 2**31)
            _RE10K_KEYS = ("horizontal_flip_prob", "reverse_prob", "back_and_forth_prob")
            # dispatch on which KEYS are present, not their values: an RE10K
            # augmentation dict with all probs overridden to 0 must stay a
            # no-op, not fall through to AugmentPipe(**aug) (whose kwargs
            # differ, e.g. frame_skip_increase -> TypeError)
            if (
                aug is not None
                and video is not None
                and any(k in aug for k in _RE10K_KEYS)
            ):
                from .augmentation import re10k_augment

                is_pose = cond is not None and cond.ndim == 2 and cond.shape[-1] == 16
                video, new_cond = re10k_augment(
                    video, cond if is_pose else None, rng,
                    horizontal_flip_prob=aug.get("horizontal_flip_prob", 0.0) or 0.0,
                    reverse_prob=aug.get("reverse_prob", 0.0) or 0.0,
                    back_and_forth_prob=aug.get("back_and_forth_prob", 0.0) or 0.0,
                )
                if is_pose:
                    cond = new_cond
            elif aug is not None and video is not None:
                # EDM AugmentPipe config dict (reference ucf_101.py:288:
                # AugmentPipe(**cfg.augmentation))
                from .augmentation import AugmentPipe

                video = AugmentPipe(**dict(aug))(video, rng)
            elif aug_prob > 0 and video is not None:
                # legacy scalar prob: the classic blit+color subset
                from .augmentation import AugmentPipe

                video = AugmentPipe(
                    p=aug_prob, xflip=1.0, rotate_int=1.0,
                    brightness=1.0, contrast=1.0, saturation=1.0,
                )(video, rng)

        length = next(
            len(a)
            for a in (video, latent, cond if cond is not None and cond.ndim > 0 else None)
            if a is not None
        )
        pad = self.n_frames - length
        nonterminal = np.ones(self.n_frames, dtype=bool)
        if pad > 0:
            nonterminal[-pad:] = False

        def pad_t(a):
            if a is None or pad == 0 or a.ndim == 0:
                return a
            return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

        video, latent, cond = pad_t(video), pad_t(latent), pad_t(cond)
        if self.frame_skip > 1:
            if video is not None:
                video = video[:: self.frame_skip]
            if latent is not None:
                latent = latent[:: self.frame_skip]
            nonterminal = nonterminal[:: self.frame_skip]
        if cond is not None:
            if cond.ndim > 0:  # per-frame conditions; labels stay scalar
                if self.external_cond_stack:
                    cond = stack_external_cond(cond, self.frame_skip)
                elif self.frame_skip > 1 and cond.shape[0] != nonterminal.shape[0]:
                    cond = cond[:: self.frame_skip]
            out["conds"] = cond

        if video is not None:
            out["videos"] = video.astype(np.float32)
        if latent is not None:
            out["latents"] = latent
        out["nonterminal"] = nonterminal
        return out


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
    """Dataset factory from the ``dataset`` config node. Falls back to
    synthetic data when the dataset directory is absent (zero-egress hosts)."""
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
    from .layouts import LAYOUTS

    cls = LAYOUTS.get(name, VideoDataset)
    return cls(cfg, split, current_epoch)
