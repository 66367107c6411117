"""Per-dataset on-disk layout adapters (port of ``dfot_tpu/data/layouts.py``).

The reference ships one dataset class per corpus, each with its own
directory layout and conditioning format (datasets/video/*.py). The
generic :class:`~dfot_tpu_torch.data.video_dataset.VideoDataset` already covers
clip indexing / resumable subepochs / padding; these adapters pin the
exact on-disk layouts so real data drops in without drift:

===========  =========================================================
dataset      layout (reference citation)
===========  =========================================================
RE10K        ``{save_dir}/{split}_{res}/`` — npz at 64px with ``video``
             stored (T, C, H, W) uint8, mp4 at 256px; camera poses at
             ``{save_dir}/{split}_poses/{stem}.pt`` (T, 18) raw ->
             (T, 16) = cols [:4] + [6:] (realestate10k.py:44-47,
             273-279, 341-360). Splits: training/test.
K600         raw ``{split}/**.mp4`` plus preprocessed
             ``{split}_preprocessed_{res}_{type}/name.{type}``; npz key
             ``video`` (T, C, H, W) uint8 (kinetics_600.py:49-73,
             245-277).
DMLab        ``{split}/**/*.npz`` with ``video`` (T, H, W, C) uint8 and
             ``actions`` (T,) ints -> one-hot(3) (dmlab.py:25-104).
             Splits: training/validation.
Minecraft    ``{split}/**/*.mp4`` with a sibling ``{stem}.npz`` holding
             ``actions`` -> one-hot(4) (minecraft.py:99-104).
UCF-101      ``{save_dir}/{split}03.json`` listing ``video_path`` +
             ``label``; videos preprocessed like K600
             (ucf_101.py:99-116, 245-250). Label is the condition.
BAIR         ``softmotion30_44k/{train|test}/video_aux1/**/*.mp4``,
             unconditional (bair.py:53-71, 137-140).
Taichi       ``{split}/*.mp4``, unconditional (taichi.py:31-92).
===========  =========================================================
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from .video_dataset import VideoDataset, _mp4_length, _mp4_read, rescale_and_crop

__all__ = [
    "RealEstate10KDataset",
    "Kinetics600Dataset",
    "DMLabDataset",
    "MinecraftDataset",
    "UCF101Dataset",
    "BAIRDataset",
    "TaichiDataset",
    "LAYOUTS",
]


class RealEstate10KDataset(VideoDataset):
    """RE10K: npz (64px, CHW) / mp4 (256px) videos + .pt pose files."""

    def __init__(self, cfg, split="training", current_epoch=None):
        if split == "validation":
            split = "test"  # reference _ALL_SPLITS (realestate10k.py:41)
        super().__init__(cfg, split, current_epoch)

    def _split_dir(self) -> str:
        return os.path.join(self.save_dir, f"{self.split}_{self.resolution}")

    def _load_video(self, meta, start, end):
        path = meta["path"]
        if path.endswith(".npz"):
            with np.load(path) as z:
                video = z["video"][start:end]
            video = np.moveaxis(video, 1, -1)  # stored (T, C, H, W)
            return video.astype(np.float32) / 255.0
        return super()._load_video(meta, start, end)

    def _load_cond(self, meta, start, end):
        import torch

        stem = os.path.splitext(os.path.basename(meta["path"]))[0]
        path = os.path.join(self.save_dir, f"{self.split}_poses", stem + ".pt")
        raw = torch.load(path, weights_only=False, map_location="cpu")
        raw = np.asarray(raw)[start:end]  # (T, 18)
        # fx fy cx cy (drop 2 unused) + flattened 3x4 extrinsics
        return np.concatenate([raw[:, :4], raw[:, 6:]], axis=1).astype(np.float32)


class _PreprocessedVideoMixin:
    """K600/UCF-style preprocessed-video resolution dirs."""

    def _preprocessed_path(self, path: str) -> Optional[str]:
        kind = str(self.cfg.get("video_preprocessing") or "npz")
        parent = os.path.dirname(path)
        pre_dir = f"{parent}_preprocessed_{self.resolution}_{kind}"
        base = os.path.splitext(os.path.basename(path))[0] + "." + kind
        cand = os.path.join(pre_dir, base)
        return cand if os.path.exists(cand) else None

    def _load_video(self, meta, start, end):
        pre = self._preprocessed_path(meta["path"])
        if pre is None:
            return VideoDataset._load_video(self, meta, start, end)
        if pre.endswith(".npz"):
            with np.load(pre) as z:
                video = z["video"][start:end]  # stored (T, C, H, W)
            return np.moveaxis(video, 1, -1).astype(np.float32) / 255.0
        video = _mp4_read(pre, start, end)
        if video.shape[1] != self.resolution or video.shape[2] != self.resolution:
            video = rescale_and_crop(video, self.resolution)
        return video.astype(np.float32) / 255.0


class Kinetics600Dataset(_PreprocessedVideoMixin, VideoDataset):
    """K600: raw mp4 tree + preprocessed npz/mp4 resolution dirs."""


class DMLabDataset(VideoDataset):
    """DMLab: npz with HWC ``video`` + int ``actions`` -> one-hot(3)."""

    _action_classes = 3

    def __init__(self, cfg, split="training", current_epoch=None):
        if split == "test":
            split = "validation"  # reference dmlab.py:20
        super().__init__(cfg, split, current_epoch)

    def _load_cond(self, meta, start, end):
        with np.load(meta["path"]) as z:
            actions = np.asarray(z["actions"][start:end], np.int64)
        return np.eye(self._action_classes, dtype=np.float32)[actions]


class MinecraftDataset(VideoDataset):
    """Minecraft: mp4 videos + sibling npz action files -> one-hot(4)."""

    _action_classes = 4

    def __init__(self, cfg, split="training", current_epoch=None):
        if split == "test":
            split = "validation"
        super().__init__(cfg, split, current_epoch)

    def _keep_file(self, name: str) -> bool:
        # sibling .npz files hold actions, not videos
        return not name.endswith(".npz")

    def _load_cond(self, meta, start, end):
        path = os.path.splitext(meta["path"])[0] + ".npz"
        with np.load(path) as z:
            actions = np.asarray(z["actions"][start:end], np.int64)
        return np.eye(self._action_classes, dtype=np.float32)[actions]


class UCF101Dataset(_PreprocessedVideoMixin, VideoDataset):
    """UCF-101: {split}03.json index with per-video class labels."""

    def _load_metadata(self) -> List[Dict[str, Any]]:
        index = os.path.join(self.save_dir, f"{self.split}03.json")
        if not os.path.exists(index):
            # fall back to the class-directory tree layout
            return super()._load_metadata()
        with open(index) as f:
            video_list = json.load(f)
        metadata = []
        for v in video_list:
            rel = v["video_path"].replace("datasets/ucf101/", "")
            path = os.path.join(self.save_dir, rel)
            # lengths come from the preprocessed file when present
            src = self._preprocessed_path(path) or path
            if src.endswith(".npz"):
                with np.load(src) as z:
                    length = z["video"].shape[0]
            else:
                length = _mp4_length(src)
            metadata.append({"path": path, "length": length, "label": int(v["label"])})
        return metadata

    def _load_cond(self, meta, start, end):
        if "label" in meta:
            return np.asarray(meta["label"], dtype=np.int32).reshape(())
        return super()._load_cond(meta, start, end)


class BAIRDataset(VideoDataset):
    """BAIR robot-pushing: softmotion30_44k/{train|test}/video_aux1 tree."""

    def _split_dir(self) -> str:
        name = "train" if self.split == "training" else "test"
        return os.path.join(self.save_dir, "softmotion30_44k", name, "video_aux1")


class TaichiDataset(VideoDataset):
    """Taichi: flat {split}/*.mp4 (decoded with OpenCV instead of decord)."""


LAYOUTS = {
    "realestate10k": RealEstate10KDataset,
    "realestate10k_mini": RealEstate10KDataset,
    "realestate10k_ood": RealEstate10KDataset,
    "kinetics_600": Kinetics600Dataset,
    "dmlab": DMLabDataset,
    "minecraft": MinecraftDataset,
    "ucf_101": UCF101Dataset,
    "cond_ucf_101": UCF101Dataset,
    "cond_ucf_101_scaling": UCF101Dataset,
    "split_ucf_101": UCF101Dataset,
    "split_cond_ucf_101": UCF101Dataset,
    "bair": BAIRDataset,
    "taichi": TaichiDataset,
}
