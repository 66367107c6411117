"""VBench-style video quality dimensions (the quality-only suite).

Port of ``dfot_tpu/metrics/vbench.py``: per-dimension scores in [0, 1] and
their weighted mean. The native dimensions are numpy copies:
``temporal_flickering``, ``motion_smoothness`` and ``dynamic_degree`` (with
OpenCV, imported where they run, Farneback flow; without it the same
fallbacks as the JAX package) and ``imaging_quality``'s classical
sharpness and blockiness proxy. The model dimensions run the registry's
networks on its device: ``subject_consistency`` (DINO),
``background_consistency`` (CLIP-B/32) and ``aesthetic_quality`` (LAION
over CLIP-L/14), each under the registry's ``frozen_math``.

The network-backed variants of the flow and quality dimensions (AMT-S,
RAFT, MUSIQ) are ROADMAP.md queue A15c: ``update`` asks the registry for
them as the JAX package does, which gives None without their file and
raises ``NotImplementedError`` with it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .encoders import clip_preprocess, dino_preprocess
from .registry import frozen_math

__all__ = ["VBenchQuality"]

# reference weights (vbench.py): dimension -> weight in the quality score
_WEIGHTS = {
    "subject_consistency": 1.0,
    "background_consistency": 1.0,
    "temporal_flickering": 1.0,
    "motion_smoothness": 1.0,
    "dynamic_degree": 0.5,
    "aesthetic_quality": 1.0,
    "imaging_quality": 1.0,
}

_NATIVE = (
    "temporal_flickering", "motion_smoothness", "dynamic_degree",
    "imaging_quality",
)


def temporal_flickering(videos: np.ndarray) -> float:
    """1 - normalized mean absolute frame-to-frame difference (higher =
    less flicker). videos (B, T, H, W, C) in [0, 1]."""
    mafd = np.abs(np.diff(videos * 255.0, axis=1)).mean()
    return float(np.clip(1.0 - mafd / 255.0, 0.0, 1.0))


def motion_smoothness(videos: np.ndarray) -> float:
    """Interpolation residual: reconstruct every middle frame from its
    neighbors and score the error — the same consistency check the
    reference's AMT-S interpolator performs (vbench/motion_smoothness.py).
    With OpenCV available the middle frame is predicted by warping the
    first frame along half the a->c optical flow; otherwise the plain
    neighbor average is used."""
    B, T = videos.shape[:2]
    if T < 3:
        return 1.0
    try:
        import cv2
    except ImportError:
        interp = 0.5 * (videos[:, :-2] + videos[:, 2:])
        err = np.abs(interp - videos[:, 1:-1]).mean()
        return float(np.clip(1.0 - err, 0.0, 1.0))

    errs = []
    H, W = videos.shape[2:4]
    gx, gy = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    for b in range(B):
        u8 = (np.clip(videos[b], 0, 1) * 255).astype(np.uint8)
        gray = [
            cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) if f.shape[-1] == 3 else f[..., 0]
            for f in u8
        ]
        for t in range(0, T - 2):
            flow = cv2.calcOpticalFlowFarneback(
                gray[t], gray[t + 2], None, 0.5, 3, 15, 3, 5, 1.2, 0
            )
            # backward-warp: middle-frame pixel p came from ~p - flow/2 in
            # frame t (dst(p) = src(map(p)) in cv2.remap)
            map_x = gx - 0.5 * flow[..., 0]
            map_y = gy - 0.5 * flow[..., 1]
            pred = cv2.remap(
                u8[t], map_x, map_y, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE
            )
            if pred.ndim == 2:
                pred = pred[..., None]
            errs.append(np.abs(pred.astype(np.float32) - u8[t + 1]).mean() / 255.0)
    return float(np.clip(1.0 - np.mean(errs), 0.0, 1.0))


def imaging_quality(videos: np.ndarray) -> float:
    """No-reference per-frame imaging quality, [0, 1] (higher = better).

    Weight-free stand-in for MUSIQ (queue A15c; registry.musiq() is None
    without ``musiq.npz``): this classical proxy combines normalized Laplacian-variance sharpness with
    a blockiness penalty (8px-grid gradient excess, the classic JPEG
    artifact measure). Scores are flagged ``_uncalibrated``.
    """
    v = np.clip(np.asarray(videos, np.float32), 0, 1)
    B, T = v.shape[:2]
    gray = v.mean(-1) if v.shape[-1] > 1 else v[..., 0]
    # sharpness: variance of the 4-neighbour laplacian, saturating map
    lap = (
        4 * gray[..., 1:-1, 1:-1]
        - gray[..., :-2, 1:-1] - gray[..., 2:, 1:-1]
        - gray[..., 1:-1, :-2] - gray[..., 1:-1, 2:]
    )
    sharp = lap.var(axis=(-2, -1))  # (B, T)
    sharp = sharp / (sharp + 1e-3)
    # blockiness: gradient magnitude on the 8px grid vs off-grid
    gx = np.abs(np.diff(gray, axis=-1))
    on = gx[..., 7::8].mean(axis=(-2, -1))
    off = gx.mean(axis=(-2, -1)) + 1e-8
    blocky = np.clip(on / off - 1.0, 0.0, 1.0)
    return float(np.clip(sharp * (1.0 - blocky), 0.0, 1.0).mean())


def dynamic_degree(videos: np.ndarray, resolution: int = 224) -> float:
    """Fraction of dynamic videos, scored with the reference's exact rule
    (vbench/dynamic_degree.py): per consecutive-frame optical flow, frame
    score = mean of the top-5% flow magnitudes; a frame moves if score >
    6 * (res/256); a video is dynamic if >= round(4 * T/16) frames move.
    Flow comes from OpenCV Farneback (dense, weight-free) instead of RAFT.
    """
    B, T = videos.shape[:2]
    if T < 2:
        return 0.0
    try:
        import cv2
    except ImportError:  # temporal-gradient fallback
        energy = np.abs(np.diff(videos, axis=1)).mean(axis=(1, 2, 3, 4))
        return float((energy > 0.01).mean())

    thr = 6.0 * (resolution / 256.0)
    count_threshold = round(4 * (T / 16.0))
    dynamic = 0
    for b in range(B):
        gray = [
            cv2.cvtColor(
                cv2.resize(
                    (np.clip(videos[b, t], 0, 1) * 255).astype(np.uint8),
                    (resolution, resolution),
                ),
                cv2.COLOR_RGB2GRAY,
            )
            if videos.shape[-1] == 3
            else cv2.resize(
                (np.clip(videos[b, t, ..., 0], 0, 1) * 255).astype(np.uint8),
                (resolution, resolution),
            )
            for t in range(T)
        ]
        moving = 0
        for t in range(T - 1):
            flow = cv2.calcOpticalFlowFarneback(
                gray[t], gray[t + 1], None, 0.5, 3, 15, 3, 5, 1.2, 0
            )
            rad = np.sqrt((flow**2).sum(-1)).reshape(-1)
            k = max(1, int(rad.size * 0.05))
            score = np.sort(rad)[-k:].mean()
            moving += score > thr
        dynamic += moving >= count_threshold
    return float(dynamic / B)


class VBenchQuality:
    """Accumulates per-dimension scores over batches; log() returns the
    normalized weighted quality score plus per-dimension values."""

    def __init__(self, dimensions: Optional[Sequence[str]] = None, registry=None):
        self.dimensions = tuple(dimensions or _NATIVE)
        unknown = set(self.dimensions) - set(_WEIGHTS)
        if unknown:
            raise ValueError(f"unknown VBench dimensions {sorted(unknown)}")
        self.registry = registry
        self.reset()

    def reset(self) -> None:
        self._scores: Dict[str, list] = {d: [] for d in self.dimensions}

    def update(self, videos) -> None:
        """videos (B, T, H, W, C) in [0, 1]: an array or a tensor."""
        if isinstance(videos, torch.Tensor):
            videos = videos.detach().float().cpu().numpy()
        videos = np.clip(np.asarray(videos, np.float32), 0, 1)
        reg = self.registry
        for dim in self.dimensions:
            if dim == "temporal_flickering":
                self._scores[dim].append(temporal_flickering(videos))
            elif dim == "motion_smoothness":
                if reg is not None:
                    reg.amt()  # A15c: raises with amt.npz
                self._scores[dim].append(motion_smoothness(videos))
            elif dim == "dynamic_degree":
                if reg is not None:
                    reg.raft()
                self._scores[dim].append(dynamic_degree(videos))
            elif dim == "imaging_quality":
                if reg is not None:
                    reg.musiq()
                self._scores[dim].append(imaging_quality(videos))
            elif reg is not None and dim in (
                "subject_consistency", "background_consistency",
                "aesthetic_quality",
            ):
                self._scores[dim].append(self._model_dim(dim, videos))

    def _model_dim(self, dim: str, videos: np.ndarray) -> float:
        """Model-based dimensions (reference vbench/*.py). Scores are only
        comparable to published tables when the registry has real weights
        (``registry.comparable``)."""
        reg = self.registry
        B, T = videos.shape[:2]
        frames = torch.from_numpy(videos.reshape((B * T,) + videos.shape[2:])).to(reg.device)
        with frozen_math(reg.device):
            if dim == "aesthetic_quality":
                # LAION head on l2-normalized CLIP-L/14 (aesthetic_quality.py:22-25)
                feats = reg.clip_l14()(clip_preprocess(frames))
                feats = feats / feats.norm(dim=-1, keepdim=True).clamp_min(1e-12)
                scores = reg.laion()(feats).cpu().numpy().reshape(B, T)
                # 0-10 rating -> [0, 1] (aesthetic_quality.py:25); clamped so the
                # random-weights fallback also stays in range
                return float(np.clip(scores.mean(axis=1).mean() / 10.0, 0.0, 1.0))
            if dim == "subject_consistency":
                feats = reg.dino()(dino_preprocess(frames))
            else:  # background_consistency
                feats = reg.clip_b32()(clip_preprocess(frames))
        f = feats.cpu().numpy().reshape(B, T, -1)
        f = f / np.clip(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12, None)
        # mean of clamped consecutive-frame and first-frame cosine sims
        # (cosine_similarity_dimension.py:19-40)
        consec = np.clip((f[:, :-1] * f[:, 1:]).sum(-1), 0, None)
        first = np.clip((f[:, :1] * f[:, 1:]).sum(-1), 0, None)
        return float(((consec + first) / 2.0).mean())

    # dim -> registry models whose weights decide value comparability.
    # Flow-based dims use classical optical flow until RAFT weights are
    # supplied ("raft"); pure-pixel temporal_flickering is always comparable.
    _DIM_MODELS = {
        "motion_smoothness": ("amt",),  # reference interpolates with AMT-S
        "dynamic_degree": ("raft",),
        "imaging_quality": ("musiq",),  # classical proxy until MUSIQ lands
        "subject_consistency": ("dino",),
        "background_consistency": ("clip_b32",),
        "aesthetic_quality": ("clip_l14", "laion"),
    }

    def log(self, prefix: str = "vbench") -> Dict[str, float]:
        out: Dict[str, float] = {}
        total_w = 0.0
        acc = 0.0
        comp = self.registry.comparable if self.registry is not None else {}
        for dim, scores in self._scores.items():
            if not scores:
                continue
            val = float(np.mean(scores))
            models = self._DIM_MODELS.get(dim, ())
            name = dim
            if models and not all(comp.get(m, False) for m in models):
                name = f"{dim}_uncalibrated"
            out[f"{prefix}/{name}"] = val
            acc += _WEIGHTS[dim] * val
            total_w += _WEIGHTS[dim]
        if total_w > 0:
            out[f"{prefix}/quality_score"] = acc / total_w
        self.reset()
        return out
