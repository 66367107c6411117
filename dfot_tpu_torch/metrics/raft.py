"""RAFT optical flow (Teed & Deng 2020), the flow network of VBench's
``dynamic_degree``.

Port of ``dfot_tpu/metrics/raft.py``: images (B, H, W, 3) in [0, 255], H
and W multiples of 8 -> flow (B, H, W, 2) in pixels. The full-size
configuration only (hidden and context 128, a 4-level correlation pyramid,
radius 4), as the published ``raft-things.pth``.

- The convolutions run NCHW; the correlation lookup and the convex
  upsampling run on channels-last tensors, as in JAX.
- The all-pairs correlation is one (B, h*w, h*w) product, average-pooled
  into the pyramid.
- :func:`bilinear_sample` is ``grid_sample(align_corners=True,
  padding_mode="zeros")`` in pixel coordinates, written as JAX writes it: four
  gathers with in-bounds masks. This also works on a pyramid level one pixel
  wide, where the normalized grid of ``grid_sample`` divides by zero.
- The lookup adds the window's ``(dy, dx)`` offsets to the ``(x, y)``
  centroids, as upstream does (``corr.py:31-37``).
- The refinement loop runs ``iters`` times, and the upsampling mask is
  computed in the last iteration only, the only one JAX's scan keeps.

The submodules carry upstream's torch names (``fnet.layer2.0.downsample.0``,
``update_block.encoder.convc1``, ``update_block.flow_head.conv1``,
``update_block.mask.0``), so that ``dfot_tpu.metrics.raft.import_raft_params``
of the state dict gives the JAX tree; ``utils/weights.py:
raft_state_dict_from_flax`` goes the other way. ``cnet``'s norms are
eval-mode ``BatchNorm2d``; ``fnet``'s are parameter-free instance norms.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["RAFT", "bilinear_sample", "all_pairs", "pool_pyramid", "corr_pyramid", "corr_lookup",
           "upsample_flow", "instance_norm"]


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """``InstanceNorm1d``/``2d`` with torch's defaults (no affine, eps 1e-5)."""
    return F.instance_norm(x, eps=1e-5)


class _InstanceNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x)


def _norm(norm_fn: str, planes: int) -> nn.Module:
    return nn.BatchNorm2d(planes) if norm_fn == "batch" else _InstanceNorm()


class ResidualBlock(nn.Module):
    """extractor.py:5-57: two 3x3 convolutions and a strided 1x1 shortcut."""

    def __init__(self, cin: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride=stride), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """extractor.py:121-194: a 7x7/2 stem, three residual stages to 1/8
    resolution, a 1x1 output convolution."""

    def __init__(self, output_dim: int, norm_fn: str):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm_fn, 64)
        cin = 64
        for i, (dim, stride) in enumerate(((64, 1), (96, 2), (128, 2)), 1):
            self.add_module(f"layer{i}", nn.Sequential(ResidualBlock(cin, dim, norm_fn, stride),
                                                       ResidualBlock(dim, dim, norm_fn, 1)))
            cin = dim
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class BasicMotionEncoder(nn.Module):
    """update.py:94-112."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """update.py:35-73: a horizontal (1x5) then a vertical (5x1) GRU."""

    def __init__(self, hidden: int = 128, input_dim: int = 256):
        super().__init__()
        for suffix, k, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in ("z", "r", "q"):
                self.add_module(f"conv{gate}{suffix}",
                                nn.Conv2d(hidden + input_dim, hidden, k, padding=pad))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for suffix in ("1", "2"):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, cin: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """update.py:131-154: motion encoder, GRU, flow head and upsampling mask."""

    def __init__(self, corr_planes: int, hidden: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(nn.Conv2d(hidden, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, self.flow_head(net)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """``grid_sample(align_corners=True, padding_mode="zeros")`` in pixel
    coordinates. img (N, H, W, C); coords (N, h, w, 2) as (x, y) -> (N, h,
    w, C)."""
    N, H, W, C = img.shape
    flat = img.reshape(N, H * W, C)
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    out = 0.0
    for xi, wx in ((x0, x0 + 1 - x), (x0 + 1, x - x0)):
        for yi, wy in ((y0, y0 + 1 - y), (y0 + 1, y - y0)):
            inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
            idx = idx.reshape(N, -1, 1)
            v = torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(coords.shape[:-1] + (C,))
            out = out + v * (wx * wy * inb)[..., None]
    return out


def all_pairs(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """fmaps (B, D, h, w) -> (B, h*w, h*w) correlations over sqrt(D)."""
    B, D, h, w = fmap1.shape
    corr = torch.einsum("bdx,bdy->bxy", fmap1.reshape(B, D, h * w), fmap2.reshape(B, D, h * w))
    return corr / math.sqrt(D)


def pool_pyramid(corr: torch.Tensor, h: int, w: int, num_levels: int) -> list:
    """(B, h*w, h*w) correlations -> levels of (B*h*w, h', w', 1), each the
    2x2 average pool of the one before."""
    level = corr.reshape(-1, 1, h, w)
    pyramid = [level]
    for _ in range(num_levels - 1):
        level = F.avg_pool2d(level, 2, stride=2)
        pyramid.append(level)
    return [c.permute(0, 2, 3, 1) for c in pyramid]


def corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4) -> list:
    """All-pairs correlation (corr.py:46-54) and its average-pooled pyramid:
    fmaps (B, D, h, w) -> levels of (B*h*w, h', w', 1)."""
    return pool_pyramid(all_pairs(fmap1, fmap2), *fmap1.shape[2:], num_levels)


def window_offsets(radius: int, device) -> torch.Tensor:
    """(2r+1, 2r+1, 2): upstream's ``meshgrid(dy, dx)`` stacked (dy, dx),
    later added to (x, y) centroids, so the first offset moves x."""
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dy, dx], dim=-1)


def corr_lookup(pyramid: list, coords: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """corr.py:23-44: a (2r+1)^2 window around each coordinate at every
    level. coords (B, h, w, 2) -> (B, h, w, levels * (2r+1)^2)."""
    B, h, w, _ = coords.shape
    delta = window_offsets(radius, coords.device)[None]
    out = []
    for i, corr in enumerate(pyramid):
        window = coords.reshape(B * h * w, 1, 1, 2) / (2**i) + delta
        out.append(bilinear_sample(corr, window).reshape(B, h, w, -1))
    return torch.cat(out, dim=-1)


def upsample_flow(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex 8x upsampling (raft.py:67-78): flow (B, h, w, 2), mask (B, h,
    w, 64 * 9) -> (B, 8h, 8w, 2)."""
    B, h, w, _ = flow.shape
    mask = torch.softmax(mask.reshape(B, h, w, 1, 9, 8, 8), dim=4)
    pad = F.pad(8 * flow, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([pad[:, i:i + h, j:j + w] for i in range(3) for j in range(3)], dim=4)
    up = (mask * patches[..., None, None]).sum(dim=4)  # (B, h, w, 2, 8, 8)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    """(B, H, W, 3) x 2 in [0, 255] -> flow (B, H, W, 2) in pixels."""

    def __init__(self, iters: int = 20, corr_levels: int = 4, corr_radius: int = 4,
                 hidden_dim: int = 128, context_dim: int = 128):
        super().__init__()
        self.iters, self.corr_levels, self.corr_radius = iters, corr_levels, corr_radius
        self.hidden_dim = hidden_dim
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(corr_levels * (2 * corr_radius + 1) ** 2, hidden_dim)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        image1 = (2 * (image1 / 255.0) - 1.0).permute(0, 3, 1, 2)
        image2 = (2 * (image2 / 255.0) - 1.0).permute(0, 3, 1, 2)
        fmap1, fmap2 = self.fnet(torch.cat([image1, image2])).chunk(2)
        pyramid = corr_pyramid(fmap1, fmap2, self.corr_levels)
        cnet = self.cnet(image1)
        net = torch.tanh(cnet[:, :self.hidden_dim])
        inp = F.relu(cnet[:, self.hidden_dim:])

        B, _, h, w = fmap1.shape
        gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=image1.device),
                                torch.arange(w, dtype=torch.float32, device=image1.device),
                                indexing="ij")
        coords0 = torch.stack([gx, gy], dim=-1)[None].expand(B, h, w, 2)
        coords1 = coords0
        for _ in range(self.iters):
            corr = corr_lookup(pyramid, coords1, self.corr_radius).permute(0, 3, 1, 2)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, delta = self.update_block(net, inp, corr, flow)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
        mask = 0.25 * self.update_block.mask(net)
        return upsample_flow(coords1 - coords0, mask.permute(0, 2, 3, 1))
