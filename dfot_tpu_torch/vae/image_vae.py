"""SD-style KL image autoencoder (per-frame latents).

Port of ``dfot_tpu/vae/image_vae.py``: the CompVis encoder and decoder
(conv stem, ``ch_mult`` levels of ResNet blocks with optional single-head
attention, mid res-attn-res, symmetric decoder), the 1x1 quant and
post-quant convs and a diagonal-Gaussian posterior. Channel-first (NCHW);
GroupNorm(32) runs in fp32, as in JAX. Submodules carry the flax names
(``down_1_0``, ``mid_attn``, ...) so ``utils/weights.py`` maps the JAX
package's parameters onto them one for one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .distribution import DiagonalGaussian

__all__ = ["ImageVAEConfig", "Encoder", "Decoder", "ImageVAE"]


def _at_least_fp32(x: torch.Tensor) -> torch.dtype:
    """fp32 for half-precision tensors, the tensor's own dtype from fp32 up."""
    return torch.promote_types(x.dtype, torch.float32)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm of 32 groups, eps 1e-6, computed in fp32 (or wider)."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.to(_at_least_fp32(x)), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


def _conv(cin: int, cout: int, k: int = 3) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, padding=k // 2)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch)
        self.conv1 = _conv(in_ch, out_ch)
        self.norm2 = GroupNorm32(out_ch)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = _conv(out_ch, out_ch)
        self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over the H*W positions
    (``dfot_tpu/vae/image_vae.py:49``): fp32 softmax."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = nn.Linear(channels, channels)
        self.k = nn.Linear(channels, channels)
        self.v = nn.Linear(channels, channels)
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = self.q(h), self.k(h), self.v(h)
        w = torch.matmul(q, k.transpose(1, 2))
        w = w.to(_at_least_fp32(w)) * (C ** -0.5)
        w = torch.softmax(w, dim=-1).to(x.dtype)
        h = self.proj_out(torch.matmul(w, v))
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class Downsample(nn.Module):
    """Pad (0, 1) on the bottom and right, then a stride-2 valid conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


@dataclasses.dataclass(frozen=True)
class ImageVAEConfig:
    """The ddconfig of ``configurations/algorithm/image_vae.yaml``."""

    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = ()
    dropout: float = 0.0
    resolution: int = 256
    z_channels: int = 4
    double_z: bool = True
    embed_dim: int = 4

    @property
    def downsampling_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    @classmethod
    def from_config(cls, cfg) -> "ImageVAEConfig":
        dd = cfg.ddconfig
        return cls(in_channels=dd.in_channels, out_ch=dd.out_ch, ch=dd.ch,
                   ch_mult=tuple(dd.ch_mult), num_res_blocks=dd.num_res_blocks,
                   attn_resolutions=tuple(dd.attn_resolutions), dropout=dd.dropout,
                   resolution=dd.resolution, z_channels=dd.z_channels, double_z=dd.double_z,
                   embed_dim=cfg.embed_dim)


class Encoder(nn.Module):
    def __init__(self, c: ImageVAEConfig):
        super().__init__()
        self.c = c
        self.conv_in = _conv(c.in_channels, c.ch)
        ch, res = c.ch, c.resolution
        for i, mult in enumerate(c.ch_mult):
            for j in range(c.num_res_blocks):
                self.add_module(f"down_{i}_{j}", ResnetBlock(ch, c.ch * mult, c.dropout))
                ch = c.ch * mult
                if res in c.attn_resolutions:
                    self.add_module(f"down_attn_{i}_{j}", AttnBlock(ch))
            if i != len(c.ch_mult) - 1:
                self.add_module(f"downsample_{i}", Downsample(ch))
                res //= 2
        self.mid_block_1 = ResnetBlock(ch, ch, c.dropout)
        self.mid_attn = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch, c.dropout)
        self.norm_out = GroupNorm32(ch)
        self.conv_out = _conv(ch, c.z_channels * (2 if c.double_z else 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.c
        h = self.conv_in(x)
        for i in range(len(c.ch_mult)):
            for j in range(c.num_res_blocks):
                h = getattr(self, f"down_{i}_{j}")(h)
                if hasattr(self, f"down_attn_{i}_{j}"):
                    h = getattr(self, f"down_attn_{i}_{j}")(h)
            if i != len(c.ch_mult) - 1:
                h = getattr(self, f"downsample_{i}")(h)
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, c: ImageVAEConfig):
        super().__init__()
        self.c = c
        ch = c.ch * c.ch_mult[-1]
        self.conv_in = _conv(c.z_channels, ch)
        self.mid_block_1 = ResnetBlock(ch, ch, c.dropout)
        self.mid_attn = AttnBlock(ch)
        self.mid_block_2 = ResnetBlock(ch, ch, c.dropout)
        res = c.resolution // c.downsampling_factor
        for i in reversed(range(len(c.ch_mult))):
            for j in range(c.num_res_blocks + 1):
                self.add_module(f"up_{i}_{j}", ResnetBlock(ch, c.ch * c.ch_mult[i], c.dropout))
                ch = c.ch * c.ch_mult[i]
                if res in c.attn_resolutions:
                    self.add_module(f"up_attn_{i}_{j}", AttnBlock(ch))
            if i != 0:
                self.add_module(f"upsample_{i}", Upsample(ch))
                res *= 2
        self.norm_out = GroupNorm32(ch)
        self.conv_out = _conv(ch, c.out_ch)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        c = self.c
        h = self.mid_block_2(self.mid_attn(self.mid_block_1(self.conv_in(z))))
        for i in reversed(range(len(c.ch_mult))):
            for j in range(c.num_res_blocks + 1):
                h = getattr(self, f"up_{i}_{j}")(h)
                if hasattr(self, f"up_attn_{i}_{j}"):
                    h = getattr(self, f"up_attn_{i}_{j}")(h)
            if i != 0:
                h = getattr(self, f"upsample_{i}")(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class ImageVAE(nn.Module):
    """KL autoencoder (``dfot_tpu/vae/image_vae.py:180``): ``encode`` (B, 3,
    H, W) in [-1, 1] -> a DiagonalGaussian over (B, embed_dim, H/f, W/f),
    ``decode`` back."""

    def __init__(self, cfg: ImageVAEConfig):
        super().__init__()
        self.cfg = cfg
        factor = 2 if cfg.double_z else 1
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(cfg.z_channels * factor, cfg.embed_dim * factor, 1)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian.from_parameters(self.quant_conv(self.encoder(x)), dim=1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))
