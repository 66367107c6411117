"""Causal 3D video VAE (temporal factor 4).

Port of ``dfot_tpu/vae/video_vae.py``: causal 3D convs (left-only temporal
padding that repeats the first frame), GroupNorm per frame, two stride-2
causal temporal downsamples, spatial down- and upsampling as in the image
VAE, and temporal upsampling by repeat-and-trim (2T - 1), so T = 1 + 4k
frames give 1 + k tokens and token 0 depends on frame 0 alone.
Channel-first (B, C, T, H, W); GroupNorm in fp32. Submodules carry the flax
names, so ``utils/weights.py`` maps the JAX package's parameters onto them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .distribution import DiagonalGaussian

__all__ = ["VideoVAEConfig", "VideoVAE", "CausalConv3d", "FrameGroupNorm"]


class CausalConv3d(nn.Module):
    """3D conv with causal (left-only) temporal padding: the first frame
    repeated (``same``) or zeros (``constant``)."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int, int] = (3, 3, 3),
                 strides: Tuple[int, int, int] = (1, 1, 1), first_padding_mode: str = "same"):
        super().__init__()
        kt, kh, kw = kernel
        self.pad_t = kt - 1
        self.first_padding_mode = first_padding_mode
        self.conv = nn.Conv3d(cin, cout, kernel, stride=strides, padding=(0, kh // 2, kw // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_t:
            first = x[:, :, :1]
            if self.first_padding_mode != "same":
                first = torch.zeros_like(first)
            x = torch.cat([first.expand(-1, -1, self.pad_t, -1, -1), x], dim=2)
        return self.conv(x)


class FrameGroupNorm(nn.Module):
    """GroupNorm(32, eps 1e-6) of each frame on its own, in fp32: statistics
    over the time axis would let future frames in."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.gn = nn.GroupNorm(num_groups, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        G = self.gn.num_groups
        xf = x.float().reshape(B, G, C // G, T, H, W)
        mean = xf.mean(dim=(2, 4, 5), keepdim=True)
        var = (xf - mean).pow(2).mean(dim=(2, 4, 5), keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.gn.eps)).reshape(B, C, T, H, W)
        y = y * self.gn.weight.view(1, C, 1, 1, 1) + self.gn.bias.view(1, C, 1, 1, 1)
        return y.to(x.dtype)


class FrameConv2d(nn.Conv2d):
    """A 2D conv applied to every frame of (B, C, T, H, W), as a 3D conv of
    temporal extent 1 over the same (O, I, kh, kw) weight."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight.unsqueeze(2), self.bias, stride=(1,) + self.stride,
                        padding=(0,) + self.padding)


class ResBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0,
                 first_padding_mode: str = "same"):
        super().__init__()
        self.norm1 = FrameGroupNorm(in_ch)
        self.conv1 = CausalConv3d(in_ch, out_ch, first_padding_mode=first_padding_mode)
        self.norm2 = FrameGroupNorm(out_ch)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = CausalConv3d(out_ch, out_ch, first_padding_mode=first_padding_mode)
        self.shortcut = nn.Conv3d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


def _temporal_up(x: torch.Tensor) -> torch.Tensor:
    """T -> 2T - 1: every token twice, the leading copy dropped, so token 0
    still decodes frame 0 alone."""
    return x.repeat_interleave(2, dim=2)[:, :, 1:]


@dataclasses.dataclass(frozen=True)
class VideoVAEConfig:
    """The fields of ``configurations/algorithm/video_vae.yaml``."""

    hidden_size: int = 128
    z_channels: int = 8
    embed_dim: int = 8
    hidden_size_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    dropout: float = 0.0
    resolution: int = 128
    temporal_length: int = 17
    is_causal: bool = True
    first_padding_mode: str = "same"
    in_channels: int = 3

    @property
    def temporal_downsampling_factor(self) -> int:
        return 2 ** min(2, len(self.hidden_size_mult) - 1)

    @property
    def spatial_downsampling_factor(self) -> int:
        return 2 ** (len(self.hidden_size_mult) - 1)

    @classmethod
    def from_config(cls, cfg) -> "VideoVAEConfig":
        m = cfg.model
        return cls(hidden_size=m.hidden_size, z_channels=m.z_channels, embed_dim=m.embed_dim,
                   hidden_size_mult=tuple(m.hidden_size_mult), num_res_blocks=m.num_res_blocks,
                   dropout=m.dropout, resolution=m.resolution,
                   temporal_length=m.temporal_length, is_causal=m.is_causal,
                   first_padding_mode=m.first_padding_mode)


class VideoEncoder(nn.Module):
    """(B, C, T, H, W) with T = 1 + 4k -> (B, 2 * embed_dim, 1 + k, H/8, W/8)."""

    def __init__(self, c: VideoVAEConfig):
        super().__init__()
        self.c = c
        mode = c.first_padding_mode
        self.conv_in = CausalConv3d(c.in_channels, c.hidden_size, first_padding_mode=mode)
        ch = c.hidden_size
        n_levels = len(c.hidden_size_mult)
        for i, mult in enumerate(c.hidden_size_mult):
            for j in range(c.num_res_blocks):
                self.add_module(f"down_{i}_{j}",
                                ResBlock3D(ch, c.hidden_size * mult, c.dropout, mode))
                ch = c.hidden_size * mult
            if i != n_levels - 1:
                self.add_module(f"sdown_{i}", FrameConv2d(ch, ch, 3, stride=2))
                if i < 2:  # two temporal halvings: factor 4
                    self.add_module(f"tdown_{i}", CausalConv3d(
                        ch, ch, kernel=(3, 1, 1), strides=(2, 1, 1), first_padding_mode=mode))
        self.mid_1 = ResBlock3D(ch, ch, c.dropout, mode)
        self.mid_2 = ResBlock3D(ch, ch, c.dropout, mode)
        self.norm_out = FrameGroupNorm(ch)
        self.conv_out = CausalConv3d(ch, 2 * c.z_channels, first_padding_mode=mode)
        self.quant_conv = nn.Conv3d(2 * c.z_channels, 2 * c.embed_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        h = self.conv_in(x)
        n_levels = len(c.hidden_size_mult)
        for i in range(n_levels):
            for j in range(c.num_res_blocks):
                h = getattr(self, f"down_{i}_{j}")(h)
            if i != n_levels - 1:
                # the stride-2 'SAME' conv pads (0, 1) on even frames
                h = getattr(self, f"sdown_{i}")(F.pad(h, (0, 1, 0, 1)))
                if i < 2:
                    h = getattr(self, f"tdown_{i}")(h)
        h = self.mid_2(self.mid_1(h))
        h = self.conv_out(F.silu(self.norm_out(h)))
        return self.quant_conv(h)


class VideoDecoder(nn.Module):
    def __init__(self, c: VideoVAEConfig):
        super().__init__()
        self.c = c
        mode = c.first_padding_mode
        self.post_quant_conv = nn.Conv3d(c.embed_dim, c.z_channels, 1)
        ch = c.hidden_size * c.hidden_size_mult[-1]
        self.conv_in = CausalConv3d(c.z_channels, ch, first_padding_mode=mode)
        self.mid_1 = ResBlock3D(ch, ch, c.dropout, mode)
        self.mid_2 = ResBlock3D(ch, ch, c.dropout, mode)
        for i in reversed(range(len(c.hidden_size_mult))):
            for j in range(c.num_res_blocks):
                self.add_module(f"up_{i}_{j}", ResBlock3D(
                    ch, c.hidden_size * c.hidden_size_mult[i], c.dropout, mode))
                ch = c.hidden_size * c.hidden_size_mult[i]
            if i != 0:
                self.add_module(f"sup_{i}", FrameConv2d(ch, ch, 3, padding=1))
        self.norm_out = FrameGroupNorm(ch)
        self.conv_out = CausalConv3d(ch, c.in_channels, first_padding_mode=mode)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        c = self.c
        h = self.conv_in(self.post_quant_conv(z))
        h = self.mid_2(self.mid_1(h))
        for i in reversed(range(len(c.hidden_size_mult))):
            for j in range(c.num_res_blocks):
                h = getattr(self, f"up_{i}_{j}")(h)
            if i != 0:
                # spatial 2x at every up, temporal 2x at the last two
                h = F.interpolate(h, scale_factor=(1, 2, 2), mode="nearest")
                h = getattr(self, f"sup_{i}")(h)
                if 1 <= i <= 2:
                    h = _temporal_up(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VideoVAE(nn.Module):
    """Causal chunk-wise video tokenizer with a KL latent
    (``dfot_tpu/vae/video_vae.py:232``)."""

    def __init__(self, cfg: VideoVAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = VideoEncoder(cfg)
        self.decoder = VideoDecoder(cfg)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian.from_parameters(self.encoder(x), dim=1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)
