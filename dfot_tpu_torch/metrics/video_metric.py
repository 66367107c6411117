"""VideoMetric: the evaluation module.

Port of ``dfot_tpu/metrics/video_metric.py:VideoMetric`` (:34-197):

- context frames are overwritten with the ground truth before scoring, and
  ``n_metrics_frames`` scores only the last frames;
- frame-wise metrics (mse, psnr, ssim, lpips) average over the non-context
  frames of each batch, and ``log`` averages the batches;
- video-wise metrics accumulate over the whole run: ``fvd`` (ground truth
  against predictions) and ``is`` (predictions) on I3D logits, videos under
  9 frames tiled to 9; ``fid`` on Inception features of every frame;
  ``fvmd`` on tracked-motion histograms of videos of 16 frames or more;
  ``vbench`` (predictions) and ``real_vbench`` (ground truth) through
  :class:`~dfot_tpu_torch.metrics.vbench.VBenchQuality`;
- ``log(prefix)`` names each value ``{prefix}/{metric}``, suffixed
  ``_uncalibrated`` where the frozen network behind it ran on the
  registry's random fallback weights, and resets.

The frame-wise metrics run on the inputs' device, the frozen networks on
the registry's (its ``frozen_math``: fp32, autocast and TF32 off); their
outputs come off the device as float64 into the host accumulators of
``metrics/frechet.py``. ``seconds`` holds the host seconds spent on each
metric since construction, each ending where its results are on the host
(the I3D pass under ``fvd``, or ``is`` where ``fvd`` is not asked for),
and under ``<metric>_host`` the host math of ``log`` apart: the Frechet
distances' matrix square roots, the Inception Score.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .frechet import FrechetDistance, InceptionScore
from .functional import mse, psnr, ssim
from .motion import motion_features
from .registry import SharedMetricModelRegistry
from .vbench import VBenchQuality

__all__ = ["VideoMetric"]

FRAME_WISE = ("mse", "psnr", "ssim", "lpips")
VIDEO_WISE = ("fvd", "is", "fid", "fvmd", "vbench", "real_vbench")
_PIXEL_FNS = {"mse": mse, "psnr": psnr, "ssim": ssim}

# vbench dims scored through VideoMetric (imaging_quality stays MUSIQ-gated)
_VBENCH_DIMS = (
    "subject_consistency", "background_consistency", "temporal_flickering",
    "motion_smoothness", "dynamic_degree", "aesthetic_quality",
)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.double().cpu().numpy()


class VideoMetric:
    def __init__(self, metric_types: Sequence[str] = ("fvd", "mse", "psnr", "ssim"),
                 registry: Optional[SharedMetricModelRegistry] = None,
                 n_metrics_frames: Optional[int] = None):
        unknown = set(metric_types) - set(FRAME_WISE) - set(VIDEO_WISE)
        if unknown:
            raise ValueError(f"unknown metrics {sorted(unknown)}")
        self.metric_types = tuple(metric_types)
        self.registry = registry or SharedMetricModelRegistry()
        self.n_metrics_frames = n_metrics_frames
        self.seconds: Dict[str, float] = {}
        self.reset()

    def reset(self) -> None:
        self._frame_acc: Dict[str, List[float]] = {m: [] for m in FRAME_WISE}
        self._fvd = FrechetDistance(400)
        self._fid = FrechetDistance(2048)
        self._fvmd = FrechetDistance(1024)
        self._is = InceptionScore()
        # vbench on predictions, real_vbench on ground truth (reference
        # video_metric.py:81, 213-215)
        self._vbench = {
            m: VBenchQuality(_VBENCH_DIMS, registry=self.registry)
            for m in ("vbench", "real_vbench")
            if m in self.metric_types
        }
        self._count = 0

    def _timed(self, name: str, t0: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0

    # ------------------------------------------------------------------
    @torch.no_grad()
    def update(self, preds, targets, context_mask: Optional[np.ndarray] = None) -> None:
        """preds, targets (B, T, H, W, C) in [0, 1], tensors on any one
        device (or arrays); context_mask (B, T) bool marks the frames given
        as context (they are not scored, and the prediction's are
        overwritten by the ground truth)."""
        preds = torch.as_tensor(preds)
        preds = torch.nan_to_num(preds.float().clamp(0, 1))
        targets = torch.as_tensor(targets, device=preds.device)
        targets = torch.nan_to_num(targets.float().clamp(0, 1))
        B, T = preds.shape[:2]
        if context_mask is None:
            context_mask = np.zeros((B, T), dtype=bool)
        ctx = torch.as_tensor(np.asarray(context_mask, bool), device=preds.device)
        preds = torch.where(ctx[..., None, None, None], targets, preds)
        if self.n_metrics_frames is not None:
            preds = preds[:, -self.n_metrics_frames:]
            targets = targets[:, -self.n_metrics_frames:]
            context_mask = np.asarray(context_mask)[:, -self.n_metrics_frames:]
        eval_mask = ~np.asarray(context_mask, dtype=bool)
        types = self.metric_types
        reg = self.registry

        for name, fn in _PIXEL_FNS.items():
            if name in types:
                t0 = time.perf_counter()
                self._acc_frame(name, fn(preds, targets), eval_mask)
                self._timed(name, t0)
        if "lpips" in types:
            t0 = time.perf_counter()
            frames = (-1,) + tuple(preds.shape[2:])
            d = reg.lpips()((preds * 2 - 1).reshape(frames), (targets * 2 - 1).reshape(frames))
            self._acc_frame("lpips", d.reshape(preds.shape[:2]), eval_mask)
            self._timed("lpips", t0)

        if "fvd" in types or "is" in types:
            t0 = time.perf_counter()
            i3d = reg.i3d()
            for vids, real in ((targets, True), (preds, False)):
                logits, _ = i3d(self._pad_to_min_frames(vids, 9))
                logits = _host(logits)
                if "fvd" in types:
                    self._fvd.update(logits, real)
                if "is" in types and not real:
                    self._is.update(logits)
            self._timed("fvd" if "fvd" in types else "is", t0)
        if "fid" in types:
            t0 = time.perf_counter()
            inc = reg.inception()
            for vids, real in ((targets, True), (preds, False)):
                self._fid.update(_host(inc(vids.reshape((-1,) + tuple(vids.shape[2:])))), real)
            self._timed("fid", t0)
        for name, vids in (("vbench", preds), ("real_vbench", targets)):
            if name in self._vbench:
                t0 = time.perf_counter()
                self._vbench[name].update(vids)
                self._timed(name, t0)
        if "fvmd" in types and preds.shape[1] >= 16:
            # Frechet video MOTION distance (reference fvmd.py requires
            # >= 16 frames and skips otherwise, :36-40): PIPs2 tracks with
            # pips.npz; otherwise the LK tracker stands in for it and the
            # score is flagged non-comparable
            t0 = time.perf_counter()
            track_fn = reg.pips()
            reg.comparable["fvmd"] = track_fn is not None
            for vids, real in ((targets, True), (preds, False)):
                self._fvmd.update(motion_features(vids, track_fn=track_fn, device=reg.device), real)
            self._timed("fvmd", t0)
        self._count += B

    def _acc_frame(self, name: str, per_frame: torch.Tensor, eval_mask: np.ndarray) -> None:
        per_frame = _host(per_frame)
        m = eval_mask.astype(np.float64)
        self._frame_acc[name].append(float((per_frame * m).sum() / np.clip(m.sum(), 1, None)))

    @staticmethod
    def _pad_to_min_frames(videos: torch.Tensor, min_frames: int) -> torch.Tensor:
        T = videos.shape[1]
        if T >= min_frames:
            return videos
        reps = -(-min_frames // T)
        return videos.repeat(1, reps, 1, 1, 1)[:, :min_frames]

    # metric -> frozen model whose weights decide value comparability
    _METRIC_MODELS = {
        "fvd": ("i3d",),
        "fid": ("inception",),
        "is": ("inception",),
        "lpips": ("lpips",),
        "fvmd": ("fvmd",),
    }

    def _key_fn(self, prefix: str):
        """Metric-name mapper that suffixes ``_uncalibrated`` when the
        backing frozen model ran with random fallback weights
        (registry.comparable[model] is False) — so an FVD scored without
        real I3D weights can never be mistaken for a published-table value."""

        def key(m: str) -> str:
            models = self._METRIC_MODELS.get(m, ())
            comp = self.registry.comparable
            if models and not all(comp.get(name, False) for name in models):
                m = f"{m}_uncalibrated"
            return f"{prefix}/{m}" if prefix else m

        return key

    # ------------------------------------------------------------------
    def log(self, prefix: str = "") -> Dict[str, float]:
        """Compute all configured metrics, then reset (reference :233-264)."""
        out: Dict[str, float] = {}
        key = self._key_fn(prefix)
        for m in FRAME_WISE:
            if m in self.metric_types and self._frame_acc[m]:
                out[key(m)] = float(np.mean(self._frame_acc[m]))
        for m, acc in (("fvd", self._fvd), ("fid", self._fid), ("fvmd", self._fvmd),
                       ("is", self._is)):
            if m in self.metric_types and self._count:
                t0 = time.perf_counter()
                out[key(m)] = acc.compute()
                self._timed(f"{m}_host", t0)
        for name, vb in self._vbench.items():
            if self._count:
                out.update(vb.log(prefix=f"{prefix}/{name}" if prefix else name))
        self.reset()
        return out
