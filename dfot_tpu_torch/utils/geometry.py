"""Camera-pose conditioning: host pose normalization and device ray maps.

Port of ``dfot_tpu/utils/geometry.py``. The numerics-sensitive sequence-level
pose math (quaternion mean, SLERP infill, bounds scaling) stays on the host
in float32 numpy, a copy of the JAX package's: :class:`CameraPose`,
:func:`normalize_camera_conditions`, :func:`process_camera_conditions`.
The per-pixel expansion of the normalized (B, T, 16) vectors to ray maps
runs on the device (:func:`expand_pose_conditions`, the counterpart of
``expand_pose_conditions_jax``).

Conventions (the reference's):
- extrinsics are world->camera: x_cam = R x_world + T,
- intrinsics (fx, fy, px, py) in normalized pixel coordinates,
- rays: origin + unnormalized direction (6), Pluecker: unit direction +
  moment (6), NeRF encoding: sin/cos at 15 octaves each for origin and
  direction (6 * 2 * 15 = 180 channels).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = [
    "CameraPose",
    "Ray",
    "rotmat_to_quat",
    "quat_to_rotmat",
    "quat_slerp",
    "conditioning_dim",
    "process_camera_conditions",
    "normalize_camera_conditions",
    "expand_pose_conditions",
]


# ---------------------------------------------------------------------------
# quaternions (w-last xyzw convention, matching roma)
# ---------------------------------------------------------------------------


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4) xyzw."""
    R = np.asarray(R, dtype=np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    q = np.empty(R.shape[:-2] + (4,), dtype=np.float64)
    # branchless Shepperd's method: compute all four candidates, pick stable
    q0 = np.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], axis=-1)
    q1 = np.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], axis=-1)
    q2 = np.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], axis=-1)
    q3 = np.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], axis=-1)
    cands = np.stack([q0, q1, q2, q3], axis=-2)  # (..., 4, 4)
    scores = np.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = np.argmax(scores, axis=-1)
    q = np.take_along_axis(cands, best[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return q.astype(np.float32)


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Unit quaternions (..., 4) xyzw -> rotation matrices (..., 3, 3)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R.astype(np.float32)


def quat_slerp(q0: np.ndarray, q1: np.ndarray, steps: np.ndarray) -> np.ndarray:
    """Spherical interpolation from q0 to q1 at fractions ``steps`` (S,)."""
    q0 = q0 / np.linalg.norm(q0)
    q1 = q1 / np.linalg.norm(q1)
    dot = float(np.dot(q0, q1))
    if dot < 0:  # shortest path
        q1, dot = -q1, -dot
    dot = min(dot, 1.0)
    theta = math.acos(dot)
    if theta < 1e-6:
        out = q0[None] + steps[:, None] * (q1 - q0)[None]
    else:
        s0 = np.sin((1 - steps) * theta) / math.sin(theta)
        s1 = np.sin(steps * theta) / math.sin(theta)
        out = s0[:, None] * q0[None] + s1[:, None] * q1[None]
    return out / np.linalg.norm(out, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# rays
# ---------------------------------------------------------------------------


class Ray:
    """Batched rays (B, T, H, W, 3) origin + (B, T, H, W, 3) direction."""

    def __init__(self, origin: np.ndarray, direction: np.ndarray):
        self.origin = origin
        self.direction = direction

    def to_tensor(self, use_plucker: bool = False) -> np.ndarray:
        if not use_plucker:
            return np.concatenate([self.origin, self.direction], axis=-1)
        d = self.direction / np.linalg.norm(self.direction, axis=-1, keepdims=True)
        moment = np.cross(self.origin, d, axis=-1)
        return np.concatenate([d, moment], axis=-1)

    @staticmethod
    def _nerf_encoding(x: np.ndarray, freq: int) -> np.ndarray:
        scale = (2.0 ** np.arange(freq, dtype=np.float32)) * math.pi
        enc = x[..., None] * scale  # (..., 3, freq)
        enc = enc.reshape(*x.shape[:-1], 3 * freq)
        return np.sin(np.concatenate([enc, enc + 0.5 * math.pi], axis=-1))

    def to_pos_encoding(self, freq_origin: int = 15, freq_direction: int = 15) -> np.ndarray:
        """NeRF-style high-frequency encoding: (..., 6*(fo+fd)) channels."""
        return np.concatenate(
            [
                self._nerf_encoding(self.origin, freq_origin),
                self._nerf_encoding(self.direction, freq_direction),
            ],
            axis=-1,
        ).astype(np.float32)


# ---------------------------------------------------------------------------
# camera poses
# ---------------------------------------------------------------------------


class CameraPose:
    """Batched world->camera poses: R (B, T, 3, 3), T (B, T, 3), K (B, T, 4)."""

    def __init__(self, R: np.ndarray, T: np.ndarray, K: np.ndarray):
        self.R = R.astype(np.float32)
        self.T = T.astype(np.float32)
        self.K = K.astype(np.float32)

    @classmethod
    def from_vectors(cls, raw: np.ndarray) -> "CameraPose":
        """raw (B, T, 16): intrinsics (4) + flattened 3x4 extrinsics (12)."""
        raw = np.asarray(raw, dtype=np.float32)
        K, RT = raw[..., :4], raw[..., 4:16]
        RT = RT.reshape(*RT.shape[:-1], 3, 4)
        return cls(RT[..., :3, :3], RT[..., :3, 3], K)

    def _normalize_by(self, R_ref: np.ndarray, T_ref: np.ndarray) -> None:
        """Make (R_ref, T_ref) the world frame."""
        R_inv = np.swapaxes(R_ref, -1, -2)  # (B, 3, 3)
        self.R = np.einsum("btij,bjk->btik", self.R, R_inv)
        self.T = self.T - np.einsum("btij,bj->bti", self.R, T_ref)

    def normalize_by_first(self) -> None:
        self._normalize_by(self.R[:, 0], self.T[:, 0])

    def normalize_by_mean(self) -> None:
        q = rotmat_to_quat(self.R)  # (B, T, 4)
        q_mean = q.mean(axis=1)
        R_mean = quat_to_rotmat(q_mean)
        T_world = np.einsum("btji,btj->bti", self.R, self.T).mean(axis=1)
        T_mean = np.einsum("bij,bj->bi", R_mean, T_world)
        self._normalize_by(R_mean, T_mean)

    def scale_within_bounds(self, bounds: float = 1.0) -> None:
        max_vals = np.abs(self.T).max(axis=1, keepdims=True)
        self.T = self.T * (bounds / np.clip(max_vals, 1e-6, None))

    def replace_with_interpolation(self, mask: np.ndarray) -> None:
        """SLERP/lerp invalid poses (mask True) from nearest valid frames
        (reference geometry_utils.py:170-215)."""
        q = rotmat_to_quat(self.R)
        T = self.T.copy()
        for b in range(mask.shape[0]):
            m = mask[b]
            if not m.any() or m.all():
                continue
            valid = np.flatnonzero(~m)
            if valid[0] != 0:
                q[b, : valid[0]] = q[b, valid[0]]
                T[b, : valid[0]] = T[b, valid[0]]
            if valid[-1] != m.shape[0] - 1:
                q[b, valid[-1] + 1 :] = q[b, valid[-1]]
                T[b, valid[-1] + 1 :] = T[b, valid[-1]]
            for lt, rt in zip(valid[:-1], valid[1:]):
                if rt - lt == 1:
                    continue
                steps = np.linspace(0, 1, rt - lt + 1, dtype=np.float32)
                q[b, lt : rt + 1] = quat_slerp(q[b, lt], q[b, rt], steps)
                T[b, lt : rt + 1] = (1 - steps[:, None]) * T[b, lt] + steps[:, None] * T[b, rt]
        self.R = quat_to_rotmat(q)
        self.T = T

    def extrinsics(self, flatten: bool = False) -> np.ndarray:
        ext = np.concatenate([self.R, self.T[..., None]], axis=-1)  # (B, T, 3, 4)
        return ext.reshape(*ext.shape[:-2], 12) if flatten else ext

    def rays(self, resolution: int) -> Ray:
        """Per-pixel rays in world coordinates (reference
        geometry_utils.py:243-305)."""
        coords = np.arange(resolution, dtype=np.float32) + 0.5
        coord_w, coord_h = np.meshgrid(coords, coords, indexing="xy")
        K = self.K * resolution  # (B, T, 4)
        fx, fy, px, py = [K[..., i][..., None, None] for i in range(4)]
        x = (coord_w[None, None] - px) / fx
        y = (coord_h[None, None] - py) / fy
        z = np.ones_like(x)
        direction = np.stack([x, y, z], axis=-1)  # (B, T, H, W, 3)
        R_inv = np.swapaxes(self.R, -1, -2)
        direction = np.einsum("btij,bthwj->bthwi", R_inv, direction)
        origin = -np.einsum("btij,btj->bti", R_inv, self.T)
        origin = np.broadcast_to(
            origin[:, :, None, None, :], direction.shape
        ).copy()
        return Ray(origin, direction)


def conditioning_dim(conditioning_type: str) -> int:
    """Channel count of each pose-conditioning format
    (reference dfot_video_pose.py:47-61)."""
    return {"global": 12, "ray": 6, "plucker": 6, "ray_encoding": 180}[conditioning_type]


def process_camera_conditions(
    raw: np.ndarray,
    conditioning_type: str,
    normalize_by: str = "first",
    bound: Optional[float] = None,
    resolution: int = 256,
    interpolation_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Raw (B, T, 16) pose vectors -> model conditioning.

    Returns (B, T, 12) for 'global', (B, T, H, W, C) channel-last maps for
    ray formats (reference dfot_video_pose.py:64-110, fp32 throughout).
    """
    poses = CameraPose.from_vectors(raw)
    if interpolation_mask is not None:
        poses.replace_with_interpolation(interpolation_mask)
    if normalize_by == "first":
        poses.normalize_by_first()
    elif normalize_by == "mean":
        poses.normalize_by_mean()
    else:
        raise ValueError(f"unknown pose normalization {normalize_by}")
    if bound is not None:
        poses.scale_within_bounds(bound)

    if conditioning_type == "global":
        return poses.extrinsics(flatten=True)
    rays = poses.rays(resolution)
    if conditioning_type == "ray_encoding":
        return rays.to_pos_encoding()
    return rays.to_tensor(use_plucker=conditioning_type == "plucker").astype(np.float32)


def normalize_camera_conditions(
    raw: np.ndarray,
    normalize_by: str = "first",
    bound: Optional[float] = None,
    interpolation_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Host half of the pose pipeline: the numerics-sensitive sequence-level
    normalization (quaternion mean, SLERP infill, bounds scaling) on the
    compact (B, T, 16) vectors. The per-pixel ray expansion happens on the
    device (:func:`expand_pose_conditions`): the 180-channel ray-encoding
    maps are 47 MB a 256 px frame in fp32, which the host would otherwise build and
    upload every window."""
    poses = CameraPose.from_vectors(raw)
    if interpolation_mask is not None:
        poses.replace_with_interpolation(interpolation_mask)
    if normalize_by == "first":
        poses.normalize_by_first()
    elif normalize_by == "mean":
        poses.normalize_by_mean()
    else:
        raise ValueError(f"unknown pose normalization {normalize_by}")
    if bound is not None:
        poses.scale_within_bounds(bound)
    return np.concatenate([poses.K, poses.extrinsics(flatten=True)], axis=-1)


def expand_pose_conditions(pose16: torch.Tensor, conditioning_type: str,
                           resolution: int) -> torch.Tensor:
    """Normalized (B, T, 16) pose vectors [fx, fy, px, py, R|T row-major]
    -> (B, T, H, W, C) fp32 conditioning maps ('ray', 'plucker' or the
    flagship's 180-channel 'ray_encoding'). All-zero rows are window padding
    and give zero maps."""
    pose16 = pose16.float()
    dev = pose16.device
    valid = (pose16 != 0.0).any(dim=-1)[..., None, None, None]
    K = pose16[..., :4] * resolution
    RT = pose16[..., 4:16].reshape(pose16.shape[:-1] + (3, 4))
    R, T = RT[..., :3], RT[..., 3]
    coords = torch.arange(resolution, dtype=torch.float32, device=dev) + 0.5
    coord_h, coord_w = torch.meshgrid(coords, coords, indexing="ij")
    fx, fy, px, py = (K[..., i][..., None, None] for i in range(4))
    fx = torch.where(fx == 0.0, 1.0, fx)
    fy = torch.where(fy == 0.0, 1.0, fy)
    x = (coord_w - px) / fx
    y = (coord_h - py) / fy
    direction = torch.stack([x, y, torch.ones_like(x)], dim=-1)  # (B, T, H, W, 3)
    R_inv = R.transpose(-1, -2)
    direction = torch.einsum("btij,bthwj->bthwi", R_inv, direction)
    origin = -torch.einsum("btij,btj->bti", R_inv, T)
    origin = origin[:, :, None, None, :].expand(direction.shape)

    if conditioning_type == "ray":
        out = torch.cat([origin, direction], dim=-1)
    elif conditioning_type == "plucker":
        norm = direction.norm(dim=-1, keepdim=True)
        d = direction / torch.where(norm == 0.0, 1.0, norm)
        out = torch.cat([d, torch.linalg.cross(origin, d, dim=-1)], dim=-1)
    elif conditioning_type == "ray_encoding":
        scale = (2.0 ** torch.arange(15, dtype=torch.float32, device=dev)) * math.pi

        def enc(v):
            e = (v[..., None] * scale).reshape(v.shape[:-1] + (45,))
            return torch.sin(torch.cat([e, e + 0.5 * math.pi], dim=-1))

        out = torch.cat([enc(origin), enc(direction)], dim=-1)
    else:
        raise ValueError(f"unknown conditioning type {conditioning_type!r}")
    return torch.where(valid, out, 0.0)
