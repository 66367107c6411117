"""AMT-S frame interpolation (Li et al. 2023), the interpolator of VBench's
``motion_smoothness``.

Port of ``dfot_tpu/metrics/amt.py``: frames (B, H, W, 3) in [0, 1], H and W
multiples of 16, and a time embedding ``embt`` (B,) -> the frame between
them (B, H, W, 3). One coarse-to-fine pass: an IFRNet pyramid encoder and
decoder chain, a bidirectional RAFT correlation lookup with an update block
at each of three levels, then multi-flow warping combined by a small
convolution head.

- ``_resize`` is ``jax.image.resize(..., "linear", antialias=False)`` to
  ``int(round(H * scale))`` (``metrics/resize.py``; upstream's
  ``F.interpolate(bilinear, align_corners=False)``).
- ``warp`` samples with the border clamped (``amt/utils.py:6-26``) through
  RAFT's :func:`~dfot_tpu_torch.metrics.raft.bilinear_sample`; the lookup
  keeps RAFT's window quirk (the first offset moves x).
- The decoders' upsampling is ``nn.ConvTranspose2d(4, 2, 1)`` under
  upstream's names (``decoder4.convblock.2``): JAX's ``ConvT4x4`` holds
  the same kernel flipped and transposed (``import_amt_params:convT_w``).
- Every convolution pads symmetrically, as JAX's explicit paddings do.

The submodules carry upstream's torch names (``feat_encoder.layer2.0.
downsample.0``, ``encoder.pyramid1.0.0``, ``decoder4.convblock.1.conv1.0``,
``update4.gru.0``, ``comb_block.2``), so that ``dfot_tpu.metrics.amt.
import_amt_params`` of the state dict gives the JAX tree; ``utils/weights.
py:amt_state_dict_from_flax`` goes the other way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .raft import all_pairs, bilinear_sample, corr_lookup, instance_norm, pool_pyramid
from .resize import resize

__all__ = ["AMT_S"]


def _resize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, round(H * scale), round(W * scale)), half-pixel
    centres, no antialiasing."""
    B, C, H, W = x.shape
    return resize(x, (B, C, int(round(H * scale)), int(round(W * scale))), "linear",
                  antialias=False)


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward warp with border padding: img (B, C, H, W), flow (B, 2, H,
    W) in pixels."""
    B, _, H, W = img.shape
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=img.device),
                            torch.arange(W, dtype=torch.float32, device=img.device),
                            indexing="ij")
    x = (gx + flow[:, 0]).clamp(0.0, W - 1.0)
    y = (gy + flow[:, 1]).clamp(0.0, H - 1.0)
    return bilinear_sample(img.permute(0, 2, 3, 1), torch.stack([x, y], -1)).permute(0, 3, 1, 2)


def convrelu(cin: int, cout: int, kernel: int = 3, stride: int = 1, padding: int = 1):
    """ifrnet.py ``convrelu``: a convolution and a per-channel PReLU."""
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, stride, padding), nn.PReLU(cout))


class BottleneckBlock(nn.Module):
    """feat_enc.py:5-63 with instance norms (no parameters)."""

    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes // 4, 1)
        self.conv2 = nn.Conv2d(planes // 4, planes // 4, 3, stride=stride, padding=1)
        self.conv3 = nn.Conv2d(planes // 4, planes, 1)
        self.downsample = None
        if stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, planes, 1, stride=stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(instance_norm(self.conv1(x)))
        y = F.relu(instance_norm(self.conv2(y)))
        y = F.relu(instance_norm(self.conv3(y)))
        if self.downsample is not None:
            x = instance_norm(self.downsample(x))
        return F.relu(x + y)


class SmallEncoder(nn.Module):
    """feat_enc.py:121-194 with instance norms: 1/8-resolution features."""

    def __init__(self, output_dim: int = 84):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 7, stride=2, padding=3)
        cin = 32
        for i, (dim, stride) in enumerate(((32, 1), (64, 2), (96, 2)), 1):
            self.add_module(f"layer{i}", nn.Sequential(BottleneckBlock(cin, dim, stride),
                                                       BottleneckBlock(dim, dim, 1)))
            cin = dim
        self.conv2 = nn.Conv2d(96, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(instance_norm(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class ResBlock(nn.Module):
    """ifrnet.py:38-95: a residual block whose last ``side`` channels take a
    narrow convolution of their own."""

    def __init__(self, channels: int, side: int):
        super().__init__()
        self.side = side
        self.conv1 = convrelu(channels, channels)
        self.conv2 = convrelu(side, side)
        self.conv3 = convrelu(channels, channels)
        self.conv4 = convrelu(side, side)
        self.conv5 = nn.Conv2d(channels, channels, 3, 1, 1)
        self.prelu = nn.PReLU(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.side
        out = self.conv1(x)
        side = self.conv2(out[:, -s:])
        out = self.conv3(torch.cat([out[:, :-s], side], 1))
        side = self.conv4(out[:, -s:])
        out = self.conv5(torch.cat([out[:, :-s], side], 1))
        return self.prelu(x + out)


class PyramidEncoder(nn.Module):
    """ifrnet.py ``Encoder``: four stride-2 stages of two ``convrelu``."""

    def __init__(self, channels: Sequence[int] = (20, 32, 44, 56)):
        super().__init__()
        cin = 3
        for i, ch in enumerate(channels, 1):
            self.add_module(f"pyramid{i}", nn.Sequential(convrelu(cin, ch, 3, 2, 1),
                                                         convrelu(ch, ch, 3, 1, 1)))
            cin = ch
        self.levels = len(channels)

    def forward(self, x: torch.Tensor) -> list:
        feats = []
        for i in range(1, self.levels + 1):
            x = getattr(self, f"pyramid{i}")(x)
            feats.append(x)
        return feats


def _decoder_block(cin: int, width: int, skip: int, cout: int) -> nn.Sequential:
    return nn.Sequential(convrelu(cin, width), ResBlock(width, skip),
                         nn.ConvTranspose2d(width, cout, 4, 2, 1))


class InitDecoder(nn.Module):
    """ifrnet.py:123-138."""

    def __init__(self, in_ch: int, out_ch: int, skip_ch: int):
        super().__init__()
        self.convblock = _decoder_block(in_ch * 2 + 1, in_ch * 2, skip_ch, out_ch + 4)

    def forward(self, f0, f1, embt):
        B, _, h, w = f0.shape
        out = self.convblock(torch.cat([f0, f1, embt.reshape(B, 1, 1, 1).expand(B, 1, h, w)], 1))
        return out[:, :2], out[:, 2:4], out[:, 4:]


class IntermediateDecoder(nn.Module):
    """ifrnet.py:141-159."""

    def __init__(self, in_ch: int, out_ch: int, skip_ch: int):
        super().__init__()
        self.convblock = _decoder_block(in_ch * 3 + 4, in_ch * 3, skip_ch, out_ch + 4)

    def forward(self, ft_, f0, f1, flow0_in, flow1_in):
        x = torch.cat([ft_, warp(f0, flow0_in), warp(f1, flow1_in), flow0_in, flow1_in], 1)
        out = self.convblock(x)
        flow0 = out[:, :2] + 2.0 * _resize(flow0_in, 2.0)
        flow1 = out[:, 2:4] + 2.0 * _resize(flow1_in, 2.0)
        return flow0, flow1, out[:, 4:]


class MultiFlowDecoder(nn.Module):
    """multi_flow.py:57-84."""

    def __init__(self, in_ch: int, skip_ch: int, num_flows: int = 3):
        super().__init__()
        self.num_flows = num_flows
        self.convblock = _decoder_block(in_ch * 3 + 4, in_ch * 3, skip_ch, 8 * num_flows)

    def forward(self, ft_, f0, f1, flow0, flow1):
        n = self.num_flows
        x = torch.cat([ft_, warp(f0, flow0), warp(f1, flow1), flow0, flow1], 1)
        d0, d1, mask, img_res = torch.split(self.convblock(x), [2 * n, 2 * n, n, 3 * n], dim=1)
        flow0 = d0 + 2.0 * _resize(flow0, 2.0).repeat(1, n, 1, 1)
        flow1 = d1 + 2.0 * _resize(flow1, 2.0).repeat(1, n, 1, 1)
        return flow0, flow1, torch.sigmoid(mask), img_res


class SmallUpdateBlock(nn.Module):
    """amt/raft.py:37-99: convolutions in place of a GRU, a feature head and
    a flow head; with ``scale_factor`` the update runs at the correlation's
    resolution and its outputs are resized back."""

    def __init__(self, cdim: int, corr_planes: int, hidden_dim: int = 76, flow_dim: int = 20,
                 corr_dim: int = 64, fc_dim: int = 68, scale_factor: Optional[float] = None):
        super().__init__()
        self.scale_factor = scale_factor
        self.convc1 = nn.Conv2d(corr_planes, corr_dim, 1)
        self.convf1 = nn.Conv2d(4, flow_dim * 2, 7, padding=3)
        self.convf2 = nn.Conv2d(flow_dim * 2, flow_dim, 3, padding=1)
        self.conv = nn.Conv2d(corr_dim + flow_dim, fc_dim, 3, padding=1)

        def head(cin, cout):
            return nn.Sequential(nn.Conv2d(cin, hidden_dim, 3, 1, 1), nn.LeakyReLU(0.1),
                                 nn.Conv2d(hidden_dim, cout, 3, 1, 1))

        self.gru = head(fc_dim + 4 + cdim, hidden_dim)
        self.feat_head = head(hidden_dim, cdim)
        self.flow_head = head(hidden_dim, 4)

    def forward(self, net, flow, corr):
        lrelu = lambda v: F.leaky_relu(v, 0.1)
        if self.scale_factor is not None:
            net = _resize(net, 1.0 / self.scale_factor)
        cor = lrelu(self.convc1(corr))
        flo = lrelu(self.convf2(lrelu(self.convf1(flow))))
        inp = lrelu(self.conv(torch.cat([cor, flo], 1)))
        out = self.gru(torch.cat([inp, flow, net], 1))
        delta_net = self.feat_head(out)
        delta_flow = self.flow_head(out)
        if self.scale_factor is not None:
            delta_net = _resize(delta_net, self.scale_factor)
            delta_flow = self.scale_factor * _resize(delta_flow, self.scale_factor)
        return delta_net, delta_flow


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class AMT_S(nn.Module):
    """(B, H, W, 3) x 2 in [0, 1] and embt (B,) -> (B, H, W, 3)."""

    def __init__(self, corr_radius: int = 3, corr_levels: int = 4, num_flows: int = 3,
                 channels: Sequence[int] = (20, 32, 44, 56), skip_channels: int = 20):
        super().__init__()
        self.corr_radius, self.corr_levels, self.num_flows = corr_radius, corr_levels, num_flows
        ch = channels
        corr_planes = 2 * corr_levels * (2 * corr_radius + 1) ** 2
        self.feat_encoder = SmallEncoder(84)
        self.encoder = PyramidEncoder(ch)
        self.decoder4 = InitDecoder(ch[3], ch[2], skip_channels)
        self.decoder3 = IntermediateDecoder(ch[2], ch[1], skip_channels)
        self.decoder2 = IntermediateDecoder(ch[1], ch[0], skip_channels)
        self.decoder1 = MultiFlowDecoder(ch[0], skip_channels, num_flows)
        self.update4 = SmallUpdateBlock(ch[2], corr_planes)
        self.update3 = SmallUpdateBlock(ch[1], corr_planes, scale_factor=2.0)
        self.update2 = SmallUpdateBlock(ch[0], corr_planes, scale_factor=4.0)
        self.comb_block = nn.Sequential(nn.Conv2d(3 * num_flows, 6 * num_flows, 3, 1, 1),
                                        nn.PReLU(6 * num_flows),
                                        nn.Conv2d(6 * num_flows, 3, 3, 1, 1))

    def forward(self, img0: torch.Tensor, img1: torch.Tensor, embt: torch.Tensor) -> torch.Tensor:
        img0, img1 = img0.permute(0, 3, 1, 2), img1.permute(0, 3, 1, 2)
        mean_ = torch.cat([img0, img1], 3).mean(dim=(1, 2, 3), keepdim=True)
        img0, img1 = img0 - mean_, img1 - mean_
        B, _, h, w = img0.shape
        gy, gx = torch.meshgrid(torch.arange(h // 8, dtype=torch.float32, device=img0.device),
                                torch.arange(w // 8, dtype=torch.float32, device=img0.device),
                                indexing="ij")
        coord = torch.stack([gx, gy], -1)[None].expand(B, h // 8, w // 8, 2)

        fmap0, fmap1 = self.feat_encoder(torch.cat([img0, img1])).chunk(2)
        corr = all_pairs(fmap0, fmap1)
        pyr = pool_pyramid(corr, h // 8, w // 8, self.corr_levels)
        pyr_T = pool_pyramid(corr.transpose(1, 2), h // 8, w // 8, self.corr_levels)
        feats = [f.chunk(2) for f in self.encoder(torch.cat([img0, img1]))]
        (f0_1, f1_1), (f0_2, f1_2), (f0_3, f1_3), (f0_4, f1_4) = feats

        embt = embt.to(torch.float32).reshape(B)
        t1_scale = 1.0 / embt.reshape(B, 1, 1, 1)
        t0_scale = 1.0 / (1.0 - embt.reshape(B, 1, 1, 1))

        def corr_scale_lookup(flow0, flow1, downsample):
            if downsample != 1:
                inv = 1.0 / downsample
                flow0 = inv * _resize(flow0, inv)
                flow1 = inv * _resize(flow1, inv)
            corr0 = corr_lookup(pyr, coord + _channels_last(flow1) * t1_scale, self.corr_radius)
            corr1 = corr_lookup(pyr_T, coord + _channels_last(flow0) * t0_scale, self.corr_radius)
            return (torch.cat([corr0, corr1], -1).permute(0, 3, 1, 2),
                    torch.cat([flow0, flow1], 1))

        def update(block, up_flow0, up_flow1, ft_, downsample):
            corr, flow = corr_scale_lookup(up_flow0, up_flow1, downsample)
            d_ft, d_flow = block(ft_, flow, corr)
            return up_flow0 + d_flow[:, :2], up_flow1 + d_flow[:, 2:], ft_ + d_ft

        # level 4 (1/16) -> 3 -> 2 -> the full-resolution multi-flow decoder
        up_flow0, up_flow1, ft_ = self.decoder4(f0_4, f1_4, embt)
        up_flow0, up_flow1, ft_ = update(self.update4, up_flow0, up_flow1, ft_, 1)
        up_flow0, up_flow1, ft_ = self.decoder3(ft_, f0_3, f1_3, up_flow0, up_flow1)
        up_flow0, up_flow1, ft_ = update(self.update3, up_flow0, up_flow1, ft_, 2)
        up_flow0, up_flow1, ft_ = self.decoder2(ft_, f0_2, f1_2, up_flow0, up_flow1)
        up_flow0, up_flow1, ft_ = update(self.update2, up_flow0, up_flow1, ft_, 4)
        up_flow0, up_flow1, mask, img_res = self.decoder1(ft_, f0_1, f1_1, up_flow0, up_flow1)

        # multi_flow_combine (multi_flow.py:11-54)
        warps = []
        for k in range(self.num_flows):
            w0 = warp(img0, up_flow0[:, 2 * k:2 * k + 2])
            w1 = warp(img1, up_flow1[:, 2 * k:2 * k + 2])
            mk = mask[:, k:k + 1]
            warps.append(mk * w0 + (1 - mk) * w1 + mean_ + img_res[:, 3 * k:3 * k + 3])
        pred = torch.stack(warps).mean(0) + self.comb_block(torch.cat(warps, 1))
        return _channels_last(pred.clamp(0.0, 1.0))
