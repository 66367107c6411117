"""Training-time clip augmentation (host-side numpy).

Port of ``dfot_tpu/data/augmentation.py``, the port's own copy (the JAX
package's module is reachable only through its package, which imports
JAX). Two families, mirroring the reference:

- The **EDM AugmentPipe** (reference utils/augmentation.py:154-414, used by
  UCF-101 via ``cfg.augmentation``, ucf_101.py:288): pixel blitting (x/y
  flip, integer 90-degree rotation, integer translation with reflection
  wrap), matrix-composed geometric warps (isotropic/anisotropic scaling,
  fractional rotation/translation executed through a sym6-wavelet 2x
  supersampled affine resample), and homogeneous color-matrix transforms
  (brightness, contrast, luma flip, hue rotation, saturation) with
  Gaussian/uniform-sampled magnitudes. One parameter set a clip, repeated
  over its frames: :meth:`AugmentPipe.sample` draws one
  :class:`AugmentParams` from the caller's ``np.random.RandomState`` in the
  JAX package's order, :meth:`AugmentPipe.apply` transforms all frames with
  it. It runs in the loader workers, as in the JAX package; the dataset
  seeds each clip's ``RandomState`` as the JAX dataset does
  (``data/video_dataset.py``), so the augmented clips are the JAX package's.

- RE10K-style temporal/viewpoint augmentation (reference
  realestate10k.yaml augmentation block): horizontal flip (with
  consistent camera-pose mirroring), time reversal, back-and-forth
  playback.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = ["AugmentPipe", "AugmentParams", "re10k_augment", "mirror_poses"]

# sym6 wavelet low-pass decomposition filter (standard published filter
# bank; reference utils/augmentation.py:62 'sym6')
_SYM6 = np.array(
    [
        0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
        -0.048311742585633, 0.4910559419267466, 0.787641141030194,
        0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
        0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
    ],
    dtype=np.float32,
)

_LUMA = np.array([1.0, 1.0, 1.0, 0.0], np.float32) / np.sqrt(3.0)


def _translate2d(tx, ty):
    m = np.eye(3, dtype=np.float32)
    m[0, 2], m[1, 2] = tx, ty
    return m


def _scale2d(sx, sy):
    return np.diag(np.array([sx, sy, 1.0], np.float32))


def _rotate2d(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _translate3d(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def _scale3d(s):
    return np.diag(np.array([s, s, s, 1.0], np.float32))


def _rotate3d(v, theta):
    """Rotation about axis v (reference rotate3d, augmentation.py:109-122)."""
    vx, vy, vz = float(v[0]), float(v[1]), float(v[2])
    s, c = np.sin(theta), np.cos(theta)
    cc = 1.0 - c
    return np.array(
        [
            [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s, 0],
            [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s, 0],
            [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c, 0],
            [0, 0, 0, 1],
        ],
        np.float32,
    )


def _corr1d(x: np.ndarray, w: np.ndarray, pad: int, axis: int, stride: int = 1):
    """Cross-correlation along ``axis`` with zero padding (torch conv2d
    semantics for a 1-D depthwise kernel)."""
    x = np.moveaxis(x, axis, -1)
    pads = [(0, 0)] * (x.ndim - 1) + [(pad, pad)]
    xp = np.pad(x, pads)
    win = np.lib.stride_tricks.sliding_window_view(xp, len(w), axis=-1)
    out = win[..., ::stride, :] @ w.astype(x.dtype)
    return np.moveaxis(out, -1, axis)


def _upsample2x(images: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Zero-stuff + low-pass along W then H (reference :324-329)."""
    N, C, H, W = images.shape
    pad = (len(w) + 1) // 2
    z = np.zeros_like(images)
    x = np.stack([images, z], axis=4).reshape(N, C, H, -1)[:, :, :, :-1]
    x = _corr1d(x, w[::-1], pad, axis=3)
    z = np.zeros_like(x)
    x = np.stack([x, z], axis=3).reshape(N, C, -1, x.shape[3])[:, :, :-1, :]
    return _corr1d(x, w[::-1], pad, axis=2)


def _downsample2x(images: np.ndarray, w: np.ndarray, crop: int) -> np.ndarray:
    """Low-pass + stride-2 decimation along W then H (reference :341-344)."""
    pad = (len(w) - 1) // 2
    x = _corr1d(images, w, pad, axis=3, stride=2)[:, :, :, crop:-crop]
    x = _corr1d(x, w, pad, axis=2, stride=2)[:, :, crop:-crop, :]
    return x


def _affine_grid_sample(images: np.ndarray, theta: np.ndarray, out_hw) -> np.ndarray:
    """torch affine_grid + grid_sample(bilinear, zeros, align_corners=False)
    (reference :336-338) in numpy. images (N, C, H, W); theta (N, 2, 3)."""
    N, C, H, W = images.shape
    oh, ow = out_hw
    # base grid, align_corners=False: pixel centers in [-1, 1]
    gx = (2.0 * np.arange(ow, dtype=np.float32) + 1.0) / ow - 1.0
    gy = (2.0 * np.arange(oh, dtype=np.float32) + 1.0) / oh - 1.0
    base = np.stack(
        [
            np.broadcast_to(gx[None, :], (oh, ow)),
            np.broadcast_to(gy[:, None], (oh, ow)),
            np.ones((oh, ow), np.float32),
        ],
        axis=-1,
    )  # (oh, ow, 3)
    g = np.einsum("nij,hwj->nhwi", theta.astype(np.float32), base)  # (N,oh,ow,2)
    # normalized -> input pixel coords (align_corners=False)
    ix = ((g[..., 0] + 1.0) * W - 1.0) / 2.0
    iy = ((g[..., 1] + 1.0) * H - 1.0) / 2.0
    x0 = np.floor(ix).astype(np.int64)
    y0 = np.floor(iy).astype(np.int64)
    fx = (ix - x0).astype(np.float32)
    fy = (iy - y0).astype(np.float32)

    def gather(yc, xc):
        valid = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
        ycl = np.clip(yc, 0, H - 1)
        xcl = np.clip(xc, 0, W - 1)
        out = images[np.arange(N)[:, None, None], :, ycl, xcl]  # (N,oh,ow,C)
        return out * valid[..., None]

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    wx, wy = fx[..., None], fy[..., None]
    out = (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )
    return np.moveaxis(out, -1, 1)  # (N, C, oh, ow)


@dataclasses.dataclass
class AugmentParams:
    """One gated parameter set, shared by every frame of the clip (the
    reference fork's execute_and_repeat semantics). Zeros = identity."""

    xflip: int = 0            # {0, 1}
    yflip: int = 0            # {0, 1}
    rotate_int: int = 0       # {0, 1, 2, 3} quarter turns
    translate_int: Tuple[int, int] = (0, 0)   # {0, 1}^2 raw draws
    scale: float = 0.0        # gated N(0, 1)
    rotate_frac: float = 0.0  # gated U(-pi, pi) * rotate_frac_max
    aniso: float = 0.0        # gated N(0, 1)
    aniso_angle: float = 0.0  # gated U(-pi, pi)
    translate_frac: Tuple[float, float] = (0.0, 0.0)  # gated N(0, 1)^2
    brightness: float = 0.0   # gated N(0, 1)
    contrast: float = 0.0     # gated N(0, 1)
    lumaflip: int = 0         # {0, 1}
    hue: float = 0.0          # gated U(-pi, pi) * hue_max
    saturation: float = 0.0   # gated N(0, 1)


class AugmentPipe:
    """Full EDM augmentation pipeline (reference utils/augmentation.py:154-414).

    All ops are disabled by default; per-op probability multipliers (times
    the overall ``p``) enable them — the UCF-101 recipe sets p=1.0 with
    per-op multipliers (configurations/dataset/ucf_101.yaml:15-26).
    ``__call__`` takes a channel-last (T, H, W, C) clip in [0, 1] and an
    ``np.random.RandomState``; values are NOT re-clipped (the reference
    feeds unclipped augmented pixels to the normalizer).
    """

    def __init__(
        self, p: float = 1.0,
        xflip: float = 0.0, yflip: float = 0.0, rotate_int: float = 0.0,
        translate_int: float = 0.0, translate_int_max: float = 0.125,
        scale: float = 0.0, rotate_frac: float = 0.0, aniso: float = 0.0,
        translate_frac: float = 0.0, scale_std: float = 0.2,
        rotate_frac_max: float = 1.0, aniso_std: float = 0.2,
        aniso_rotate_prob: float = 0.5, translate_frac_std: float = 0.125,
        brightness: float = 0.0, contrast: float = 0.0, lumaflip: float = 0.0,
        hue: float = 0.0, saturation: float = 0.0, brightness_std: float = 0.2,
        contrast_std: float = 0.5, hue_max: float = 1.0,
        saturation_std: float = 1.0,
    ):
        self.p = float(p)
        self.xflip, self.yflip = float(xflip), float(yflip)
        self.rotate_int, self.translate_int = float(rotate_int), float(translate_int)
        self.translate_int_max = float(translate_int_max)
        self.scale, self.rotate_frac = float(scale), float(rotate_frac)
        self.aniso, self.translate_frac = float(aniso), float(translate_frac)
        self.scale_std, self.rotate_frac_max = float(scale_std), float(rotate_frac_max)
        self.aniso_std = float(aniso_std)
        self.aniso_rotate_prob = float(aniso_rotate_prob)
        self.translate_frac_std = float(translate_frac_std)
        self.brightness, self.contrast = float(brightness), float(contrast)
        self.lumaflip, self.hue = float(lumaflip), float(hue)
        self.saturation = float(saturation)
        self.brightness_std, self.contrast_std = float(brightness_std), float(contrast_std)
        self.hue_max, self.saturation_std = float(hue_max), float(saturation_std)

    # -- parameter sampling (one draw per clip) -------------------------
    def sample(self, rng: np.random.RandomState) -> AugmentParams:
        def gate(mult, value):
            return value if rng.rand() < mult * self.p else type(value)(0)

        p = AugmentParams()
        if self.xflip > 0:
            p.xflip = int(gate(self.xflip, int(rng.randint(2))))
        if self.yflip > 0:
            p.yflip = int(gate(self.yflip, int(rng.randint(2))))
        if self.rotate_int > 0:
            p.rotate_int = int(gate(self.rotate_int, int(rng.randint(4))))
        if self.translate_int > 0:
            w = (int(rng.randint(2)), int(rng.randint(2)))
            if not rng.rand() < self.translate_int * self.p:
                w = (0, 0)
            p.translate_int = w
        if self.scale > 0:
            p.scale = float(gate(self.scale, float(rng.randn())))
        if self.rotate_frac > 0:
            w = (rng.rand() * 2 - 1) * np.pi * self.rotate_frac_max
            p.rotate_frac = float(gate(self.rotate_frac, float(w)))
        if self.aniso > 0:
            p.aniso = float(gate(self.aniso, float(rng.randn())))
            r = (rng.rand() * 2 - 1) * np.pi
            p.aniso_angle = float(r if rng.rand() < self.aniso_rotate_prob else 0.0)
        if self.translate_frac > 0:
            w = (float(rng.randn()), float(rng.randn()))
            if not rng.rand() < self.translate_frac * self.p:
                w = (0.0, 0.0)
            p.translate_frac = w
        if self.brightness > 0:
            p.brightness = float(gate(self.brightness, float(rng.randn())))
        if self.contrast > 0:
            p.contrast = float(gate(self.contrast, float(rng.randn())))
        if self.lumaflip > 0:
            p.lumaflip = int(gate(self.lumaflip, int(rng.randint(2))))
        if self.hue > 0:
            w = (rng.rand() * 2 - 1) * np.pi * self.hue_max
            p.hue = float(gate(self.hue, float(w)))
        if self.saturation > 0:
            p.saturation = float(gate(self.saturation, float(rng.randn())))
        return p

    # -- pure transform (parity-testable vs the torch pipe) -------------
    def apply(self, images: np.ndarray, prm: AugmentParams) -> np.ndarray:
        """images (N, C, H, W) float32; one parameter set for all N."""
        images = np.asarray(images, np.float32)
        N, C, H, W = images.shape

        # pixel blitting (reference :196-247)
        if prm.xflip == 1:
            images = images[:, :, :, ::-1]
        if prm.yflip == 1:
            images = images[:, :, ::-1, :]
        w = prm.rotate_int
        if w in (1, 2):
            images = images[:, :, :, ::-1]
        if w in (2, 3):
            images = images[:, :, ::-1, :]
        if w in (1, 3):
            images = images.swapaxes(2, 3)
            N, C, H, W = images.shape
        if prm.translate_int != (0, 0):
            tx = int(round(prm.translate_int[0] * W * self.translate_int_max))
            ty = int(round(prm.translate_int[1] * H * self.translate_int_max))
            x = np.arange(W)
            y = np.arange(H)
            xi = W - 1 - np.abs(W - 1 - (x - tx) % (W * 2 - 2))
            yi = H - 1 - np.abs(H - 1 - (y + ty) % (H * 2 - 2))
            images = images[:, :, yi[:, None], xi[None, :]]

        # geometric transform matrix (reference :253-301)
        G_inv = np.eye(3, dtype=np.float32)
        have_geom = False
        if prm.scale != 0.0:
            s = float(2.0 ** (prm.scale * self.scale_std))
            G_inv = G_inv @ _scale2d(1 / s, 1 / s)
            have_geom = True
        if prm.rotate_frac != 0.0:
            G_inv = G_inv @ _rotate2d(prm.rotate_frac)  # rotate2d_inv(-w)
            have_geom = True
        if prm.aniso != 0.0:
            s = float(2.0 ** (prm.aniso * self.aniso_std))
            r = prm.aniso_angle
            G_inv = G_inv @ _rotate2d(-r) @ _scale2d(1 / s, s) @ _rotate2d(r)
            have_geom = True
        if prm.translate_frac != (0.0, 0.0):
            G_inv = G_inv @ _translate2d(
                -prm.translate_frac[0] * W * self.translate_frac_std,
                -prm.translate_frac[1] * H * self.translate_frac_std,
            )
            have_geom = True

        # wavelet-supersampled affine resample (reference :303-344)
        if have_geom:
            Hz = _SYM6
            Hz_pad = len(Hz) // 4
            cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
            cp = np.array(
                [[-cx, -cy, 1], [cx, -cy, 1], [cx, cy, 1], [-cx, cy, 1]],
                np.float32,
            )
            cpt = G_inv @ cp.T  # (3, 4)
            margin = cpt[:2, :].reshape(2, -1)
            margin = np.concatenate([-margin, margin]).max(axis=1)
            margin = margin + np.array(
                [Hz_pad * 2 - cx, Hz_pad * 2 - cy] * 2, np.float32
            )
            margin = np.clip(margin, [0, 0, 0, 0], [W - 1, H - 1, W - 1, H - 1])
            mx0, my0, mx1, my1 = np.ceil(margin).astype(np.int32)
            images = np.pad(
                images, ((0, 0), (0, 0), (my0, my1), (mx0, mx1)), mode="reflect"
            )
            G_inv = _translate2d((mx0 - mx1) / 2.0, (my0 - my1) / 2.0) @ G_inv
            images = _upsample2x(images, Hz)
            G_inv = _scale2d(2, 2) @ G_inv @ _scale2d(0.5, 0.5)
            G_inv = _translate2d(-0.5, -0.5) @ G_inv @ _translate2d(0.5, 0.5)
            oh, ow = (H + Hz_pad * 2) * 2, (W + Hz_pad * 2) * 2
            ih, iw = images.shape[2], images.shape[3]
            G_full = (
                _scale2d(2.0 / iw, 2.0 / ih)
                @ G_inv
                @ _scale2d(ow / 2.0, oh / 2.0)
            )
            theta = np.broadcast_to(G_full[None, :2, :], (N, 2, 3))
            images = _affine_grid_sample(images, theta, (oh, ow))
            images = _downsample2x(images, Hz, Hz_pad)

        # color transform matrix (reference :350-413)
        M = np.eye(4, dtype=np.float32)
        have_color = False
        if prm.brightness != 0.0:
            M = _translate3d(np.full(3, prm.brightness * self.brightness_std)) @ M
            have_color = True
        if prm.contrast != 0.0:
            M = _scale3d(float(2.0 ** (prm.contrast * self.contrast_std))) @ M
            have_color = True
        if prm.lumaflip == 1:
            M = (np.eye(4, dtype=np.float32) - 2.0 * np.outer(_LUMA, _LUMA)) @ M
            have_color = True
        if prm.hue != 0.0:
            M = _rotate3d(_LUMA, prm.hue) @ M
            have_color = True
        if prm.saturation != 0.0:
            outer = np.outer(_LUMA, _LUMA)
            s = float(2.0 ** (prm.saturation * self.saturation_std))
            M = (outer + (np.eye(4, dtype=np.float32) - outer) * s) @ M
            have_color = True
        if have_color:
            flat = images.reshape(N, C, -1)
            if C == 3:
                flat = M[:3, :3].astype(flat.dtype) @ flat + M[:3, 3:].astype(flat.dtype)
            elif C == 1:
                Mm = M[:3, :].mean(axis=0, keepdims=True)
                flat = flat * Mm[:, :3].sum(axis=1, keepdims=True) + Mm[:, 3:]
            else:
                raise ValueError("image must have 1 or 3 channels")
            images = flat.reshape(N, C, images.shape[2], images.shape[3])

        return np.ascontiguousarray(images)

    # -- loader entry point ---------------------------------------------
    def __call__(self, video: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        """video (T, H, W, C) in [0, 1] -> augmented (T, H, W, C) float32."""
        if self.p <= 0:
            return np.asarray(video, np.float32)
        prm = self.sample(rng)
        nchw = np.moveaxis(np.asarray(video, np.float32), -1, 1)
        out = self.apply(nchw, prm)
        return np.ascontiguousarray(np.moveaxis(out, 1, -1))


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
