"""Camera-pose conditioning on the device: pose vectors -> ray maps.

Port of ``dfot_tpu/utils/geometry.py:expand_pose_conditions_jax``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["expand_pose_conditions"]


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
