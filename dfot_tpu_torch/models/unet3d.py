"""U-Net3D video denoiser in PyTorch: per-frame spatial convs, FiLM from the
(noise, action) embedding, spatial attention at configured resolutions and
rotary temporal attention, causal or not.

Port of ``dfot_tpu/models/unet3d.py``. Tensors are channel-first inside,
(B, C, T, H, W), and every conv is a ``Conv3d`` of kernel (1, k, k) as
upstream has it, so GroupNorm spans (T, H, W) natively (the reference's
normalizer, which sees future frames even under causal attention);
``UNet3DSpec.frame_local_norm`` normalizes each frame alone instead. The
input and output are channel-last (B, T, H, W, C), as every backbone's.

Module and parameter names are the upstream torch names that
``dfot_tpu/utils/torch_ckpt.py:import_unet3d_params`` reads
(``init_conv``, ``down_blocks.{i}.0.{j}``, ``down_blocks.{i}.1.conv``,
``mid_block.{0-3}``, ``up_blocks.{i}.{j}`` with ``up_blocks.0`` the deepest
level, ``out.0``, ``out.1``, ``...wrapper.module.attn.to_qkv``). A level
without attention keeps the indices of its attention blocks (parameter-free
``Identity`` modules), as does a level without down- or upsampling.

Kernels: the spatial softmax attention goes by
:func:`dfot_tpu_torch.ops.attention.attention_route`: rows of H*W tokens, a
multiple of 64, with heads of 32 take the padded flash route (B1 forward, B4
and B5 backward on heads zero-padded to 64, with the true 1/sqrt(32)
scale). The temporal rows (T <= 16 frames) and the linear attention are
plain ops, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.qkv_prep import swap_pairs
from .embeddings import RandomDropoutCondEmbedding, RopeTables, StochasticTimeEmbedding, make_rope_1d

__all__ = ["UNet3DSpec", "UNet3D"]


class VideoGroupNorm(nn.GroupNorm):
    """GroupNorm of (B, C, T, H, W): statistics over (T, H, W) and the
    group's channels, or with ``frame_local`` over each frame's (H, W)."""

    def __init__(self, groups: int, channels: int, frame_local: bool = False):
        if channels % groups:
            raise ValueError(f"Number of groups ({groups}) does not divide the number of "
                             f"channels ({channels})")
        super().__init__(groups, channels, eps=1e-6)
        self.frame_local = frame_local

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.frame_local:
            return super().forward(x)
        B, C, T, H, W = x.shape
        y = super().forward(x.transpose(1, 2).reshape(B * T, C, H, W))
        return y.reshape(B, T, C, H, W).transpose(1, 2)


def _conv(cin: int, cout: int, k: int = 3, stride: int = 1) -> nn.Conv3d:
    """Per-frame k x k conv as upstream's Conv3d of kernel (1, k, k)."""
    return nn.Conv3d(cin, cout, (1, k, k), stride=(1, stride, stride), padding=(0, k // 2, k // 2))


class ResnetBlock(nn.Module):
    """GroupNorm, SiLU, conv; GroupNorm with FiLM from the embedding, SiLU,
    conv; 1x1x1 skip conv where the width changes."""

    def __init__(self, cin: int, cout: int, groups: int, emb_dim: Optional[int],
                 frame_local_norm: bool = False):
        super().__init__()
        self.in_layers = nn.Sequential(VideoGroupNorm(groups, cin, frame_local_norm), nn.SiLU(),
                                       _conv(cin, cout))
        if emb_dim is not None:
            self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, 2 * cout))
        self.out_layers = nn.Sequential(VideoGroupNorm(groups, cout, frame_local_norm), nn.SiLU(),
                                        _conv(cout, cout))
        if cin != cout:
            self.skip_conv = nn.Conv3d(cin, cout, 1)

    def forward(self, x: torch.Tensor, emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, C, T, H, W); emb (B, T, E) per frame."""
        h = self.in_layers(x)
        h = self.out_layers[0](h)
        if emb is not None and hasattr(self, "emb_layers"):
            mod = self.emb_layers(emb).transpose(1, 2)[..., None, None]  # (B, 2C, T, 1, 1)
            scale, shift = mod.chunk(2, dim=1)
            h = h * (1 + scale) + shift
        h = self.out_layers[2](self.out_layers[1](h))
        return (self.skip_conv(x) if hasattr(self, "skip_conv") else x) + h


class _Attn(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Linear(heads * dim_head, dim)

    def split(self, h: torch.Tensor):
        """(B, N, C) -> q, k, v of (B, heads, N, dim_head)."""
        B, N, _ = h.shape
        qkv = self.to_qkv(h).reshape(B, N, 3, self.heads, self.dim_head)
        return qkv.permute(2, 0, 3, 1, 4)

    def merge(self, o: torch.Tensor) -> torch.Tensor:
        B, H, N, D = o.shape
        return self.to_out(o.transpose(1, 2).reshape(B, N, H * D))


class _Wrapper(nn.Module):
    """Upstream's attention wrapper: its block is ``module``."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module


class _SpatialCore(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.attn = _Attn(dim, heads, dim_head)


class SpatialAttention(nn.Module):
    """Pre-LayerNorm residual attention over each frame's H*W tokens,
    softmax or linear (softmax(q) (softmax(k)^T v))."""

    def __init__(self, dim: int, heads: int, dim_head: int, use_linear: bool = False):
        super().__init__()
        self.use_linear = use_linear
        self.wrapper = _Wrapper(_SpatialCore(dim, heads, dim_head))
        # True: run the plain versions of the attention kernels
        self.plain = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        core = self.wrapper.module
        h = core.norm(x.permute(0, 2, 3, 4, 1).reshape(B * T, H * W, C))
        q, k, v = core.attn.split(h)
        if self.use_linear:
            q = q.softmax(dim=-1) * core.attn.dim_head ** -0.5
            ctx = torch.einsum("bhnd,bhne->bhde", k.softmax(dim=-2), v)
            o = torch.einsum("bhnd,bhde->bhne", q, ctx)
        else:
            o = attention(q, k, v, plain=self.plain)
        o = core.attn.merge(o).reshape(B, T, H, W, C).permute(0, 4, 1, 2, 3)
        return x + o


class _TemporalCore(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.attn_block = _SpatialCore(dim, heads, dim_head)


class TemporalAttention(nn.Module):
    """Pre-LayerNorm residual attention over each pixel's T frames with 1-D
    RoPE on q and k, causal or not."""

    def __init__(self, dim: int, heads: int, dim_head: int, causal: bool, rope: RopeTables):
        super().__init__()
        self.causal, self.rope = causal, rope
        self.wrapper = _Wrapper(_TemporalCore(dim, heads, dim_head))
        self.plain = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T, H, W = x.shape
        core = self.wrapper.module.attn_block
        h = core.norm(x.permute(0, 3, 4, 2, 1).reshape(B * H * W, T, C))
        q, k, v = core.attn.split(h)
        cos, sin = (t[:T] for t in self.rope.cast(x.device, q.dtype))
        q = q * cos + swap_pairs(q) * sin
        k = k * cos + swap_pairs(k) * sin
        o = attention(q, k, v, causal=self.causal, plain=self.plain)
        o = core.attn.merge(o).reshape(B, H, W, T, C).permute(0, 4, 3, 1, 2)
        return x + o


class Downsample(nn.Module):
    """Stride-2 3x3 per-frame conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = _conv(dim, dim, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest 2x in space, then a 3x3 per-frame conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = _conv(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest"))


@dataclasses.dataclass(frozen=True)
class UNet3DSpec:
    network_size: int = 64
    num_res_blocks: int = 2
    resnet_block_groups: int = 8
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    attn_resolutions: Tuple[int, ...] = (8, 16, 32, 64)
    attn_dim_head: int = 32
    attn_heads: int = 4
    use_linear_attn: bool = True
    use_init_temporal_attn: bool = True
    init_kernel_size: int = 7
    dropout: float = 0.0
    max_temporal_length: int = 16
    # per-frame GroupNorm statistics (the JAX package's extension; upstream
    # checkpoints are trained with False)
    frame_local_norm: bool = False

    @classmethod
    def from_config(cls, cfg, max_tokens: int) -> "UNet3DSpec":
        """From the ``algorithm.backbone`` node, as the JAX spec reads it."""
        return cls(
            network_size=cfg.network_size,
            num_res_blocks=cfg.num_res_blocks,
            resnet_block_groups=cfg.get("resnet_block_groups", 8),
            dim_mults=tuple(cfg.get("dim_mults", [1, 2, 4, 8])),
            attn_resolutions=tuple(cfg.attn_resolutions),
            attn_dim_head=cfg.get("attn_dim_head", 32),
            attn_heads=cfg.attn_heads,
            use_linear_attn=cfg.use_linear_attn,
            use_init_temporal_attn=cfg.use_init_temporal_attn,
            init_kernel_size=cfg.init_kernel_size,
            dropout=cfg.dropout,
            max_temporal_length=max_tokens,
            frame_local_norm=cfg.get("frame_local_norm", False),
        )


class UNet3D(nn.Module):
    """x (B, T, H, W, C) channel-last, noise_levels (B, T); returns fp32 in
    x's layout. ``attn_resolutions`` are image sizes in pixels: a level of
    ``resolution / 2^i`` pixels has attention where that size is listed."""

    def __init__(self, spec: UNet3DSpec, x_channels: int, resolution: int,
                 use_causal_mask: bool = True, external_cond_type: Optional[str] = None,
                 external_cond_dim: int = 0, external_cond_num_classes: Optional[int] = None,
                 external_cond_dropout: float = 0.0, use_fourier_noise_emb: bool = False):
        super().__init__()
        s = spec
        self.spec, self.x_channels = s, x_channels
        dim, nrb, g = s.network_size, s.num_res_blocks, s.resnet_block_groups
        dims = [dim] + [dim * m for m in s.dim_mults]
        n = len(s.dim_mults)
        attn_factors = {resolution // r for r in s.attn_resolutions}
        rope = RopeTables(make_rope_1d(s.attn_dim_head, s.max_temporal_length))
        emb_dim = dim * 4
        self.noise_level_pos_embedding = StochasticTimeEmbedding(max(dim, 32), emb_dim,
                                                                 use_fourier_noise_emb)
        if external_cond_dim:
            self.external_cond_embedding = RandomDropoutCondEmbedding(
                external_cond_dim, dim * 2, external_cond_dropout)
            emb_dim += dim * 2

        def res(cin, cout, emb=emb_dim):
            return ResnetBlock(cin, cout, g, emb, s.frame_local_norm)

        def attn_blocks(c, has_attn, use_linear):
            if not has_attn:
                return [nn.Identity(), nn.Identity()]
            return [SpatialAttention(c, s.attn_heads, s.attn_dim_head, use_linear),
                    TemporalAttention(c, s.attn_heads, s.attn_dim_head, use_causal_mask, rope)]

        k0 = s.init_kernel_size
        self.init_conv = _conv(x_channels, dim, k0)
        if s.use_init_temporal_attn:
            self.init_temporal_attn = TemporalAttention(dim, s.attn_heads, s.attn_dim_head,
                                                        use_causal_mask, rope)
        self.down_blocks = nn.ModuleList()
        for i in range(n):
            last = i == n - 1
            blocks = [res(dims[i] if j == 0 else dims[i + 1], dims[i + 1]) for j in range(nrb)]
            blocks += attn_blocks(dims[i + 1], 2 ** i in attn_factors,
                                  s.use_linear_attn and not last)
            self.down_blocks.append(nn.ModuleList([
                nn.ModuleList(blocks), nn.Identity() if last else Downsample(dims[i + 1])]))
        c = dims[-1]
        self.mid_block = nn.ModuleList([
            res(c, c), SpatialAttention(c, s.attn_heads, s.attn_dim_head, False),
            TemporalAttention(c, s.attn_heads, s.attn_dim_head, use_causal_mask, rope), res(c, c)])
        # up_blocks.0 is the deepest level
        self.up_blocks = nn.ModuleList()
        for idx, i in enumerate(reversed(range(n))):
            blocks = [res(2 * dims[i + 1] if j == 0 else dims[i], dims[i]) for j in range(nrb)]
            blocks += attn_blocks(dims[i], 2 ** i in attn_factors,
                                  s.use_linear_attn and idx > 0)
            blocks.append(nn.Identity() if idx == n - 1 else Upsample(dims[i]))
            self.up_blocks.append(nn.ModuleList(blocks))
        self.out = nn.Sequential(ResnetBlock(2 * dim, dim, g, None, s.frame_local_norm),
                                 nn.Conv3d(dim, x_channels, 1))

    def use_plain_kernels(self, plain: bool = True) -> None:
        """Route every attention through the plain versions of its kernels
        (True) or through the kernels (False)."""
        for m in self.modules():
            if isinstance(m, (SpatialAttention, TemporalAttention)):
                m.plain = plain

    def forward(self, x, noise_levels, external_cond=None, external_cond_mask=None
                ) -> torch.Tensor:
        nrb = self.spec.num_res_blocks
        emb = self.noise_level_pos_embedding(noise_levels)  # (B, T, 4 dim)
        if external_cond is not None and hasattr(self, "external_cond_embedding"):
            cond = self.external_cond_embedding(external_cond, external_cond_mask)
            emb = torch.cat([emb, cond.to(emb.dtype)], dim=-1)

        h0 = self.init_conv(x.permute(0, 4, 1, 2, 3).to(self.init_conv.weight.dtype))
        if self.spec.use_init_temporal_attn:
            h0 = self.init_temporal_attn(h0)

        def level(h, blocks):
            for j in range(nrb):
                h = blocks[j](h, emb)
            return blocks[nrb + 1](blocks[nrb](h))

        h, hs = h0, []
        for blocks, down in self.down_blocks:
            h = level(h, blocks)
            hs.append(h)
            h = down(h)
        res0, sattn, tattn, res1 = self.mid_block
        h = res1(tattn(sattn(res0(h, emb))), emb)
        for blocks in self.up_blocks:
            h = level(torch.cat([h, hs.pop()], dim=1), blocks)
            h = blocks[nrb + 2](h)
        h = self.out[0](torch.cat([h, h0], dim=1))
        return self.out[1](h).permute(0, 2, 3, 4, 1).float()
