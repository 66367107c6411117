"""PIPs2 point tracking (Zheng et al. 2023), the tracker of FVMD.

Port of ``dfot_tpu/metrics/pips.py``: query points ``trajs0`` (S, N, 2) in
pixels and frames ``rgbs`` (S, H, W, 3) in [-1, 1] -> trajectories (S, N,
2). No batch axis (upstream requires B = 1).

- An instance-norm ResNet encodes every frame once to 1/8 resolution; each
  stage's output is resized with aligned corners (:func:`resize_align_corners`,
  RAFT's sampler on the same float32 grid as JAX) and the stages are fused.
- Each iteration samples point features at frames t, t - 2 and t - 4
  (``inds2``, ``inds4``), correlates each set against every frame's feature
  pyramid in a (2r+1)^2 window (RAFT's lookup and its window quirk) and
  maps the windows and the sin-cos embedded flow to coordinate deltas with
  a 1-D ResNet over time.
- :func:`bilinear_sample2d` is not ``grid_sample``: indices are clamped to
  the edge while the corner weights stay raw (``pips2.py:624-700``).
- Frame 0 stays locked to the query points, and with ``beautify`` the
  delta is halved once ``itr > 3 * iters // 4``.

The submodules carry upstream's torch names (``fnet.layer2.0.downsample.0``,
``delta_block.first_block_conv.conv``, ``delta_block.basicblock_list.3.
conv1.conv``, ``delta_block.dense``), so that ``dfot_tpu.metrics.pips.
import_pips_params`` of the state dict gives the JAX tree; ``utils/weights.
py:pips_state_dict_from_flax`` goes the other way. Upstream's unused
``norm`` (a ``GroupNorm`` that ``import_pips_params`` drops) is left out.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .raft import bilinear_sample, instance_norm, window_offsets

__all__ = ["Pips", "bilinear_sample2d", "resize_align_corners"]


def resize_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``F.interpolate(bilinear, align_corners=True)`` of (B, C, H, W):
    output pixel i samples input coordinate i * (in - 1) / (out - 1)."""
    B, C, H, W = x.shape
    oh, ow = out_hw
    ys = torch.arange(oh, dtype=torch.float32, device=x.device) * ((H - 1) / max(oh - 1, 1))
    xs = torch.arange(ow, dtype=torch.float32, device=x.device) * ((W - 1) / max(ow - 1, 1))
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy], -1)[None].expand(B, oh, ow, 2)
    return bilinear_sample(x.permute(0, 2, 3, 1), coords).permute(0, 3, 1, 2)


def bilinear_sample2d(fmap: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Edge-clamped indices, raw corner weights. fmap (B, C, H, W); x, y (B,
    N) pixel coordinates -> (B, N, C)."""
    B, C, H, W = fmap.shape
    flat = fmap.reshape(B, C, H * W).transpose(1, 2)
    x0, y0 = torch.floor(x), torch.floor(y)

    def gather(xi, yi):
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))

    w00 = ((x0 + 1 - x) * (y0 + 1 - y))[..., None]
    w01 = ((x - x0) * (y0 + 1 - y))[..., None]
    w10 = ((x0 + 1 - x) * (y - y0))[..., None]
    w11 = ((x - x0) * (y - y0))[..., None]
    return (w00 * gather(x0, y0) + w01 * gather(x0 + 1, y0)
            + w10 * gather(x0, y0 + 1) + w11 * gather(x0 + 1, y0 + 1))


class ResidualBlock2d(nn.Module):
    """pips2.py:141-200 with instance norms (no parameters)."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride=stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """pips2.py:203-305: four residual stages, each resized to 1/8 and
    fused."""

    def __init__(self, output_dim: int = 128, stride: int = 8):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        cin, dims = 64, ((64, 1), (96, 2), (128, 2), (128, 2))
        for i, (dim, s) in enumerate(dims, 1):
            self.add_module(f"layer{i}", nn.Sequential(ResidualBlock2d(cin, dim, s),
                                                       ResidualBlock2d(dim, dim, 1)))
            cin = dim
        self.conv2 = nn.Conv2d(sum(d for d, _ in dims), output_dim * 2, 3, padding=1)
        self.conv3 = nn.Conv2d(output_dim * 2, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_hw = (x.shape[2] // self.stride, x.shape[3] // self.stride)
        x = F.relu(instance_norm(self.conv1(x)))
        feats = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            feats.append(resize_align_corners(x, out_hw))
        x = F.relu(instance_norm(self.conv2(torch.cat(feats, 1))))
        return self.conv3(x)


class _Conv1dSame(nn.Module):
    """Upstream's 1-D convolution wrapper (its ``conv``), kernel 3, padding 1."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResidualBlock1d(nn.Module):
    """pips2.py:44-118: a pre-norm residual block over time, (B, C, S); the
    identity grows to the new width with zero channels on both sides."""

    def __init__(self, cin: int, cout: int, is_first_block: bool = False):
        super().__init__()
        self.cin, self.cout, self.is_first_block = cin, cout, is_first_block
        self.conv1 = _Conv1dSame(cin, cout)
        self.conv2 = _Conv1dSame(cout, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = x if self.is_first_block else F.relu(instance_norm(x))
        out = self.conv2(F.relu(instance_norm(self.conv1(out))))
        if self.cout != self.cin:
            ch1 = (self.cout - self.cin) // 2
            x = F.pad(x, (0, 0, ch1, self.cout - self.cin - ch1))
        return out + x


def posemb_sincos_2d_xy(xy: torch.Tensor, C: int, temperature: float = 10000.0) -> torch.Tensor:
    """pips2.py:724-743 with ``cat_coords``: xy (B, S, 2) -> (B, S, C + 2)."""
    omega = torch.arange(C // 4, dtype=torch.float32, device=xy.device) / (C // 4 - 1)
    omega = 1.0 / (temperature**omega)
    x = xy[..., 0, None] * omega
    y = xy[..., 1, None] * omega
    return torch.cat([torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y), xy], -1)


class DeltaBlock(nn.Module):
    """pips2.py:308-390: a 1-D ResNet over (points, time) mapping the
    correlation windows and the embedded flow to 2-D deltas. Upstream's
    ``first_block_norm`` and ``final_norm`` are never applied, here neither."""

    def __init__(self, latent_dim: int = 128, corr_planes: int = 3 * 4 * 49, n_block: int = 8):
        super().__init__()
        self.latent_dim = latent_dim
        self.first_block_conv = _Conv1dSame(corr_planes + latent_dim + 2, 128)
        blocks = []
        for i in range(n_block):
            if i == 0:
                cin = cout = 128
            else:
                cin = int(128 * 2 ** ((i - 1) // 2))
                cout = cin * 2 if i % 2 == 0 else cin
            blocks.append(ResidualBlock1d(cin, cout, is_first_block=(i == 0)))
        self.basicblock_list = nn.ModuleList(blocks)
        self.dense = nn.Linear(cout, 2)

    def forward(self, fcorr: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """fcorr (N, S, corr_planes), flow (N, S, 2) -> (N, S, 2)."""
        x = torch.cat([fcorr, posemb_sincos_2d_xy(flow, self.latent_dim)], -1).transpose(1, 2)
        x = F.relu(self.first_block_conv(x))
        for block in self.basicblock_list:
            x = block(x)
        return self.dense(F.relu(x).transpose(1, 2))


def fmap_pyramid(fmaps: torch.Tensor, num_levels: int = 4) -> list:
    """(S, C, H, W) -> levels of (S, C, h, w), each the 2x2 average pool of
    the one before."""
    pyr = [fmaps]
    for _ in range(num_levels - 1):
        fmaps = F.avg_pool2d(fmaps, 2, stride=2)
        pyr.append(fmaps)
    return pyr


def corr_sample(pyramid: list, feats: torch.Tensor, coords: torch.Tensor,
                radius: int) -> torch.Tensor:
    """pips2.py:431-472: feats (S, N, C) against every level, sampled in a
    (2r+1)^2 window around coords (S, N, 2) -> (S, N, levels * (2r+1)^2)."""
    S, N, C = feats.shape
    delta = window_offsets(radius, coords.device)[None]
    out = []
    for i, fmaps in enumerate(pyramid):
        h, w = fmaps.shape[2:]
        corr = torch.einsum("snc,schw->snhw", feats, fmaps) / math.sqrt(C)
        window = coords.reshape(S * N, 1, 1, 2) / (2**i) + delta
        out.append(bilinear_sample(corr.reshape(S * N, h, w, 1), window).reshape(S, N, -1))
    return torch.cat(out, -1)


class Pips(nn.Module):
    """trajs0 (S, N, 2) in pixels, rgbs (S, H, W, 3) in [-1, 1] -> (S, N, 2)."""

    def __init__(self, stride: int = 8, latent_dim: int = 128, corr_levels: int = 4,
                 corr_radius: int = 3, iters: int = 16, beautify: bool = True):
        super().__init__()
        self.stride, self.latent_dim = stride, latent_dim
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.iters, self.beautify = iters, beautify
        self.fnet = BasicEncoder(latent_dim, stride)
        self.delta_block = DeltaBlock(latent_dim, 3 * corr_levels * (2 * corr_radius + 1) ** 2)

    def forward(self, trajs0: torch.Tensor, rgbs: torch.Tensor) -> torch.Tensor:
        S = trajs0.shape[0]
        fmaps = self.fnet(rgbs.permute(0, 3, 1, 2))
        pyramid = fmap_pyramid(fmaps, self.corr_levels)
        coords0 = trajs0 / float(self.stride)
        # frame 0's features at the query points, shared across time
        feats1 = bilinear_sample2d(fmaps[:1], coords0[:1, :, 0], coords0[:1, :, 1])
        feats1 = feats1.expand(S, -1, -1)
        inds2 = torch.as_tensor(np.clip(np.arange(S) - 2, 0, None), device=rgbs.device)
        inds4 = torch.as_tensor(np.clip(np.arange(S) - 4, 0, None), device=rgbs.device)

        coords = coords0
        for itr in range(self.iters):
            feats2 = feats4 = feats1
            if itr >= 1:
                c2, c4 = coords[inds2], coords[inds4]
                feats2 = bilinear_sample2d(fmaps[inds2], c2[..., 0], c2[..., 1])
                feats4 = bilinear_sample2d(fmaps[inds4], c4[..., 0], c4[..., 1])
            fcorrs = torch.cat([corr_sample(pyramid, f, coords, self.corr_radius)
                                for f in (feats1, feats2, feats4)], -1)
            flows = coords[1:] - coords[:-1]
            flows = torch.cat([flows, flows[-1:]], 0)
            delta = self.delta_block(fcorrs.transpose(0, 1), flows.transpose(0, 1)).transpose(0, 1)
            if self.beautify and itr > 3 * self.iters // 4:
                delta = delta * 0.5
            coords = torch.cat([coords0[:1], (coords + delta)[1:]], 0)
        return coords * float(self.stride)
