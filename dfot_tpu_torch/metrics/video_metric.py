"""VideoMetric: the frame-wise half of the evaluation module.

Port of ``dfot_tpu/metrics/video_metric.py:VideoMetric`` (:34-190):

- context frames are overwritten with the ground truth before scoring,
- ``n_metrics_frames`` scores only the last frames,
- frame-wise metrics (mse, psnr, ssim) average over the non-context frames
  of each batch, and ``log`` averages the batches,
- ``log(prefix)`` names each value ``{prefix}/{metric}`` and resets.

The metrics that need frozen networks (``fvd``, ``fid``, ``is``,
``lpips``, ``fvmd``, ``vbench``, ``real_vbench``) are ROADMAP.md queue
item A15 and raise ``NotImplementedError``: the scores would not be the
ones asked for.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .functional import mse, psnr, ssim

__all__ = ["VideoMetric"]

FRAME_WISE = {"mse": mse, "psnr": psnr, "ssim": ssim}
UNPORTED = ("lpips", "fvd", "is", "fid", "fvmd", "vbench", "real_vbench")


class VideoMetric:
    def __init__(self, metric_types: Sequence[str] = ("mse", "psnr", "ssim"),
                 n_metrics_frames: Optional[int] = None):
        unknown = set(metric_types) - set(FRAME_WISE) - set(UNPORTED)
        if unknown:
            raise ValueError(f"unknown metrics {sorted(unknown)}")
        missing = [m for m in metric_types if m in UNPORTED]
        if missing:
            keep = [m for m in metric_types if m in FRAME_WISE]
            raise NotImplementedError(
                f"metrics {missing} need frozen networks that are not ported yet "
                f"(ROADMAP.md queue A15); leave them out with "
                f"++algorithm.logging.metrics=[{','.join(keep)}]"
            )
        self.metric_types = tuple(metric_types)
        self.n_metrics_frames = n_metrics_frames
        self.reset()

    def reset(self) -> None:
        self._frame_acc: Dict[str, List[float]] = {m: [] for m in FRAME_WISE}

    @torch.no_grad()
    def update(self, preds: torch.Tensor, targets: torch.Tensor,
               context_mask: Optional[np.ndarray] = None) -> None:
        """preds, targets (B, T, H, W, C) in [0, 1], on any one device;
        context_mask (B, T) bool marks the frames given as context (they are
        not scored, and the prediction's are overwritten by the ground
        truth)."""
        preds = torch.nan_to_num(preds.float().clamp(0, 1))
        targets = torch.nan_to_num(torch.as_tensor(targets, device=preds.device).float().clamp(0, 1))
        B, T = preds.shape[:2]
        if context_mask is None:
            context_mask = np.zeros((B, T), dtype=bool)
        ctx = torch.as_tensor(context_mask, device=preds.device)
        preds = torch.where(ctx[..., None, None, None], targets, preds)
        if self.n_metrics_frames is not None:
            preds = preds[:, -self.n_metrics_frames:]
            targets = targets[:, -self.n_metrics_frames:]
            context_mask = context_mask[:, -self.n_metrics_frames:]
        eval_mask = ~np.asarray(context_mask, dtype=bool)
        for name, fn in FRAME_WISE.items():
            if name in self.metric_types:
                self._acc_frame(name, fn(preds, targets), eval_mask)

    def _acc_frame(self, name: str, per_frame: torch.Tensor, eval_mask: np.ndarray) -> None:
        per_frame = per_frame.double().cpu().numpy()
        m = eval_mask.astype(np.float64)
        self._frame_acc[name].append(float((per_frame * m).sum() / np.clip(m.sum(), 1, None)))

    def log(self, prefix: str = "") -> Dict[str, float]:
        """Every configured metric's mean over the batches, then reset."""
        out = {}
        for m in ("mse", "psnr", "ssim"):
            if m in self.metric_types and self._frame_acc[m]:
                out[f"{prefix}/{m}" if prefix else m] = float(np.mean(self._frame_acc[m]))
        self.reset()
        return out
