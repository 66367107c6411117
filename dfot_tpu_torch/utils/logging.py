"""Metrics and video logging: local JSONL and GIF files, wandb if present.

Port of ``dfot_tpu/utils/logging.py`` (:22-120): scalar metrics as one JSON
object a line in ``metrics.jsonl``, mirrored to wandb where the package
imports and the config asks for it; sampled videos as side-by-side
prediction | ground-truth GIF grids with red borders on the context frames,
plus raw npz (and mp4, where OpenCV imports) dumps. ``log_video`` imports
PIL when it is called.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

__all__ = ["MetricsLogger", "log_video"]


class MetricsLogger:
    """JSONL metrics logger; mirrors to wandb when available + configured."""

    def __init__(self, output_dir: str, wandb_cfg: Optional[dict] = None, name: str = "",
                 enabled: bool = True):
        """``enabled=False`` (a process other than rank 0 of a multi-process
        run) makes a logger that writes nothing."""
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._file = None
        self._wandb = None
        if not enabled:
            return
        os.makedirs(output_dir, exist_ok=True)
        self._file = open(self.path, "a")
        if wandb_cfg and wandb_cfg.get("mode") != "disabled":
            try:
                import wandb  # optional
            except ImportError:
                return
            self._wandb = wandb.init(
                project=wandb_cfg.get("project"),
                entity=wandb_cfg.get("entity"),
                mode=wandb_cfg.get("mode", "offline"),
                name=name or None,
                dir=output_dir,
            )

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if self._file is None:
            return
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()


def _to_uint8(video: np.ndarray) -> np.ndarray:
    return (np.clip(video, 0.0, 1.0) * 255).astype(np.uint8)


def log_video(pred: np.ndarray, gt: np.ndarray, path: str, context_frames: int = 0,
              raw_dir: Optional[str] = None, fps: int = 8) -> None:
    """Save a pred|gt side-by-side GIF grid; red border marks context frames.

    pred, gt: (B, T, H, W, C) float in [0, 1].
    """
    from PIL import Image

    pred, gt = _to_uint8(np.asarray(pred)), _to_uint8(np.asarray(gt))
    B, T, H, W, C = pred.shape
    if C == 1:
        pred = np.repeat(pred, 3, axis=-1)
        gt = np.repeat(gt, 3, axis=-1)

    # red border on context frames of the prediction column
    framed = pred.copy()
    framed[:, :context_frames, :2] = [255, 0, 0]
    framed[:, :context_frames, -2:] = [255, 0, 0]
    framed[:, :context_frames, :, :2] = [255, 0, 0]
    framed[:, :context_frames, :, -2:] = [255, 0, 0]

    # grid: rows = batch, cols = pred | gt
    grid = np.concatenate([framed, gt], axis=3)  # (B, T, H, 2W, 3)
    grid = np.concatenate(list(grid), axis=1)  # (T, B*H, 2W, 3)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    frames = [Image.fromarray(grid[t]) for t in range(T)]
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=max(1000 // fps, 20), loop=0)
    if raw_dir:
        os.makedirs(raw_dir, exist_ok=True)
        base = os.path.splitext(os.path.basename(path))[0]
        np.savez_compressed(os.path.join(raw_dir, base + ".npz"), pred=pred, gt=gt)
        try:
            import cv2
        except ImportError:
            return
        Th, Tw = grid.shape[1:3]
        vw = cv2.VideoWriter(os.path.join(raw_dir, base + ".mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), fps, (Tw, Th))
        for t in range(T):
            vw.write(cv2.cvtColor(grid[t], cv2.COLOR_RGB2BGR))
        vw.release()
