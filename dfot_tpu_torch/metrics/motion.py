"""FVMD motion features: tracked-point velocity/acceleration histograms.

A copy of ``dfot_tpu/metrics/motion.py`` (numpy): a 20 x 20 point grid
tracked through 16-frame segments by a pyramidal Lucas-Kanade tracker, the
weight-free stand-in for PIPs2 that the JAX package takes without
``pips.npz``; each segment's velocity and acceleration fields binned into
HOG-style histograms (4-frame x 5 x 5-cell subcubes, 8 angle bins,
log2-magnitude weights) and concatenated into 1024-d features for a
Frechet distance. The one change: the videos are resized to the tracker's
256 px on ``device`` by ``metrics/resize.py``, with the weights of JAX's
``bilinear`` resize.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..diffusion.core import resolve_device
from .resize import resize

__all__ = ["lk_track", "motion_features", "calc_hist"]


# ---------------------------------------------------------------------------
# pyramidal Lucas-Kanade point tracker (weight-free PIPS substitute)
# ---------------------------------------------------------------------------


def _to_gray(frames: np.ndarray) -> np.ndarray:
    """(S, H, W, C) in [0, 1] -> (S, H, W) luminance."""
    if frames.shape[-1] == 1:
        return frames[..., 0]
    w = np.asarray([0.299, 0.587, 0.114], np.float32)[: frames.shape[-1]]
    return frames @ (w / w.sum())


def _pyr_down(im: np.ndarray) -> np.ndarray:
    """2x downsample with a small box blur; (S, H, W)."""
    k = np.asarray([0.25, 0.5, 0.25], np.float32)
    im = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), -1, im)
    im = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"), -2, im)
    return im[..., ::2, ::2]


def _bilinear(im: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Sample im (H, W) at float coords; clamped borders. ys/xs same shape."""
    H, W = im.shape
    ys = np.clip(ys, 0.0, H - 1.001)
    xs = np.clip(xs, 0.0, W - 1.001)
    y0 = np.floor(ys).astype(np.int32)
    x0 = np.floor(xs).astype(np.int32)
    fy = ys - y0
    fx = xs - x0
    v00 = im[y0, x0]
    v01 = im[y0, x0 + 1]
    v10 = im[y0 + 1, x0]
    v11 = im[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def _lk_step(
    prev: np.ndarray, nxt: np.ndarray, pts_prev: np.ndarray, guess: np.ndarray,
    window: int = 7, iters: int = 8,
) -> np.ndarray:
    """One-level LK: refine `guess` (N, 2 xy) so nxt[guess] matches
    prev[pts_prev]. All N points vectorized."""
    half = window // 2
    dy, dx = np.mgrid[-half : half + 1, -half : half + 1]
    dy = dy.reshape(-1).astype(np.float32)
    dx = dx.reshape(-1).astype(np.float32)

    gy, gx = np.gradient(prev)
    py = pts_prev[:, 1][:, None] + dy[None]
    px = pts_prev[:, 0][:, None] + dx[None]
    template = _bilinear(prev, py, px)  # (N, W2)
    Ix = _bilinear(gx, py, px)
    Iy = _bilinear(gy, py, px)
    # 2x2 normal matrix per point
    Gxx = (Ix * Ix).sum(-1) + 1e-4
    Gxy = (Ix * Iy).sum(-1)
    Gyy = (Iy * Iy).sum(-1) + 1e-4
    det = Gxx * Gyy - Gxy * Gxy

    pos = guess.astype(np.float32).copy()
    for _ in range(iters):
        qy = pos[:, 1][:, None] + dy[None]
        qx = pos[:, 0][:, None] + dx[None]
        err = _bilinear(nxt, qy, qx) - template  # (N, W2)
        bx = (Ix * err).sum(-1)
        by = (Iy * err).sum(-1)
        # solve G d = b
        ux = (Gyy * bx - Gxy * by) / det
        uy = (Gxx * by - Gxy * bx) / det
        pos[:, 0] -= ux
        pos[:, 1] -= uy
    return pos


def lk_track(
    frames: np.ndarray, pts0: np.ndarray, levels: int = 3,
    window: int = 7, iters: int = 8,
) -> np.ndarray:
    """Track pts0 (N, 2 xy) through frames (S, H, W[, C]) in [0, 1].

    Returns trajectories (S, N, 2). Coarse-to-fine pyramid per frame pair.
    """
    if frames.ndim == 4:
        frames = _to_gray(frames)
    frames = frames.astype(np.float32)
    pyramids = [frames]
    for _ in range(levels - 1):
        pyramids.append(_pyr_down(pyramids[-1]))

    S = frames.shape[0]
    trajs = np.empty((S, pts0.shape[0], 2), np.float32)
    trajs[0] = pts0
    for t in range(1, S):
        prev_pts = trajs[t - 1]
        guess = prev_pts / (2.0 ** (levels - 1))
        for lv in reversed(range(levels)):
            scale = 2.0**lv
            p_prev = prev_pts / scale
            pos = _lk_step(
                pyramids[lv][t - 1], pyramids[lv][t], p_prev, guess,
                window=window, iters=iters,
            )
            guess = pos * 2.0 if lv > 0 else pos
        H, W = frames.shape[1:3]
        trajs[t] = np.stack(
            [np.clip(guess[:, 0], 0, W - 1), np.clip(guess[:, 1], 0, H - 1)], -1
        )
    return trajs


# ---------------------------------------------------------------------------
# histogram features (reference motion_extractor.py:154-238, vectorized)
# ---------------------------------------------------------------------------


def _calc_velocity(trajs: np.ndarray) -> np.ndarray:
    """(S, N, 2) -> (S, N, 2); zero row prepended (reference :66-76)."""
    v = trajs[1:] - trajs[:-1]
    return np.concatenate([np.zeros_like(v[:1]), v], axis=0)


def _calc_acceleration(vel: np.ndarray) -> np.ndarray:
    a = vel[2:] - vel[1:-1]
    return np.concatenate([np.zeros_like(a[:2]), a], axis=0)


def calc_hist(
    vectors: np.ndarray, cell_size: int = 5, angle_bins: int = 8,
    cube_frames: int = 4, magnitude_bins: int = 256,
) -> np.ndarray:
    """(B, S, N, 2) velocity/acceleration fields -> (B, MS, MH, MW, bins)
    HOG histograms; matches the reference's count_subcube_hist exactly."""
    B, S, N, _ = vectors.shape
    H = int(round(np.sqrt(N)))
    v = vectors.reshape(B, S, H, H, 2)
    MH = H // cell_size
    MS = S // cube_frames
    v = v[:, : MS * cube_frames, : MH * cell_size, : MH * cell_size]
    v = v.reshape(B, MS, cube_frames, MH, cell_size, MH, cell_size, 2)
    v = v.transpose(0, 1, 3, 5, 2, 4, 6, 7)  # (B, MS, MH, MW, s, h, w, 2)

    angle = np.arctan2(v[..., 0], v[..., 1])
    abin = np.clip((angle + np.pi) // (2 * np.pi / angle_bins), 0, angle_bins - 1)
    mag = np.linalg.norm(v, axis=-1)
    mag = np.clip(mag, 0, magnitude_bins - 1) + 1.0
    mag = np.ceil(np.clip(np.log2(mag), 0, np.log2(magnitude_bins)))
    mag = mag / np.log2(magnitude_bins)

    flat_bins = abin.reshape(B * MS * MH * MH, -1).astype(np.int64)
    flat_mag = mag.reshape(B * MS * MH * MH, -1)
    hist = np.zeros((flat_bins.shape[0], angle_bins), np.float64)
    rows = np.repeat(np.arange(flat_bins.shape[0]), flat_bins.shape[1])
    np.add.at(hist, (rows, flat_bins.reshape(-1)), flat_mag.reshape(-1))
    return hist.reshape(B, MS, MH, MH, angle_bins)


def motion_features(
    videos: np.ndarray, resolution: int = 256, segment_length: int = 16,
    num_points: int = 400, levels: int = 3, track_fn=None, device=None,
) -> np.ndarray:
    """(B, T>=16, H, W, C) in [0, 1] -> (num_segments_total, 1024) features
    (velocity + acceleration histograms; reference MotionExtractor.forward).

    track_fn(frames (S, H, W, C) in [0, 1], pts0 (N, 2)) -> (S, N, 2)
    overrides the LK tracker — pass ``registry.pips()`` for the reference's
    PIPS2 tracking (published-table-comparable FVMD). ``videos`` is an
    array or a tensor; the resize runs on ``device`` (None: the card)."""
    B, T = videos.shape[:2]
    # resize to the tracker resolution (reference :121-131)
    x = torch.as_tensor(videos).to(device=resolve_device(device), dtype=torch.float32)
    v = resize(x, (B, T, resolution, resolution, videos.shape[-1]), "bilinear")
    v = v.cpu().numpy().astype(np.float32)

    side = int(round(np.sqrt(num_points)))
    lin = 8 + np.arange(side, dtype=np.float32) / (side - 1) * (resolution - 16)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    pts0 = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)  # (N, 2) xy

    vels, accs = [], []
    for b in range(B):
        for start in range(0, T - segment_length + 1, segment_length - 1):
            seg = v[b, start : start + segment_length]
            if track_fn is not None:
                trajs = np.asarray(track_fn(seg, pts0))
            else:
                trajs = lk_track(seg, pts0, levels)
            vel = _calc_velocity(trajs)
            vels.append(vel)
            accs.append(_calc_acceleration(vel))
    vels = np.stack(vels)  # (M, S, N, 2)
    accs = np.stack(accs)
    hv = calc_hist(vels).reshape(len(vels), -1)
    ha = calc_hist(accs).reshape(len(accs), -1)
    return np.concatenate([hv, ha], axis=-1)  # (M, 1024)
