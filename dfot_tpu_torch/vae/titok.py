"""TiTok-KL: a 1-D ViT tokenizer with a KL latent.

Port of ``dfot_tpu/vae/titok.py`` under the upstream torch names that
``dfot_tpu/vae/titok.py:import_titok_params`` reads:

- the encoder: a patchify conv, a CLS token and learned position
  embeddings, ``num_latent_tokens`` learned latent queries appended,
  open_clip ``ResidualAttentionBlock``s, ``ln_post`` over the latent tokens
  and a 1x1 conv to the diagonal-Gaussian moments, (B, N, 2 token_size);
- the decoder: the latent tokens embedded after [CLS | grid mask tokens],
  a ViT, then 1x1 -> tanh -> 1x1 to 1024 logits a patch;
- the pixel path: a softmax over the logits, the 1x1 ``pixel_quantize_conv``
  to 256 channels and a MaskGIT-VQGAN CNN decoder, with MaskGIT's shortcut
  quirk (a ResnetBlock applies its 1x1 ``nin_shortcut`` to the block's
  output, not its input).

Its attention is the JAX package's einsum chain (fp32 scores and softmax),
as matmuls: no attention kernel runs here. Images are (B, 3, H, W);
``encode`` returns a posterior over (B, N, token_size), split on the last
axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .distribution import DiagonalGaussian

__all__ = ["TiTokConfig", "TiTokKL"]

_VIT_SIZES = {"small": (512, 8, 8), "base": (768, 12, 12), "large": (1024, 24, 16)}


@dataclasses.dataclass(frozen=True)
class TiTokConfig:
    """TiTok_KL's constructor arguments (``dfot_tpu/vae/titok.py:TiTokConfig``)."""

    image_size: int = 256
    token_size: int = 12
    use_l2_norm: bool = True
    vit_enc_model_size: str = "large"
    vit_dec_model_size: str = "large"
    vit_enc_patch_size: int = 16
    vit_dec_patch_size: int = 16
    num_latent_tokens: int = 32
    pixel_hidden_channels: int = 128
    pixel_channel_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    pixel_num_res_blocks: int = 2
    pixel_z_channels: int = 256
    pixel_quantize_dim: int = 1024
    group_norm_groups: int = 32
    # (width, layers, heads) for small models; None: the model-size table
    vit_override: Optional[Tuple[int, int, int]] = None

    def vit(self, which: str) -> Tuple[int, int, int]:
        if self.vit_override is not None:
            return tuple(self.vit_override)
        return _VIT_SIZES[self.vit_enc_model_size if which == "enc" else self.vit_dec_model_size]

    @classmethod
    def from_config(cls, cfg) -> "TiTokConfig":
        kw = {}
        for f in dataclasses.fields(cls):
            v = cfg.get(f.name)
            if v is not None:
                kw[f.name] = tuple(v) if isinstance(v, (list, tuple)) else v
        return cls(**kw)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed ``in_proj``,
    ``out_proj``): fp32 scores and softmax, the weights cast back."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, C = x.shape
        d = C // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).reshape(
            B, L, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        s = torch.matmul(q, k.transpose(-1, -2)).float() * d ** -0.5
        a = torch.softmax(s, dim=-1).to(x.dtype)
        return self.out_proj(torch.matmul(a, v).transpose(1, 2).reshape(B, L, C))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.c_fc = nn.Linear(dim, hidden)
        self.c_proj = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = MultiheadAttention(dim, heads)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


def _embedding(*shape, width: int) -> nn.Parameter:
    return nn.Parameter(width ** -0.5 * torch.randn(*shape))


def _conv1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv over the last axis of a channel-last tensor."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class _TiTokEncoder(nn.Module):
    def __init__(self, c: TiTokConfig):
        super().__init__()
        width, layers, heads = c.vit("enc")
        p, self.grid = c.vit_enc_patch_size, c.image_size // c.vit_enc_patch_size
        self.patch_embed = nn.Conv2d(3, width, p, stride=p)
        self.class_embedding = _embedding(1, width, width=width)
        self.positional_embedding = _embedding(self.grid ** 2 + 1, width, width=width)
        self.latent_token_positional_embedding = _embedding(c.num_latent_tokens, width, width=width)
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.conv_out = nn.Conv2d(width, 2 * c.token_size, 1)

    def forward(self, x: torch.Tensor, latent_tokens: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = self.patch_embed(x).flatten(2).transpose(1, 2)  # (B, g*g, W)
        h = torch.cat([self.class_embedding.expand(B, 1, -1).to(h.dtype), h], 1)
        h = h + self.positional_embedding[: h.shape[1]].to(h.dtype)
        lat = latent_tokens + self.latent_token_positional_embedding.to(h.dtype)
        h = self.ln_pre(torch.cat([h, lat.expand(B, -1, -1)], 1))
        for block in self.transformer:
            h = block(h)
        return _conv1x1(self.ln_post(h[:, 1 + self.grid ** 2:]), self.conv_out)  # (B, N, 2z)


class _TiTokDecoder(nn.Module):
    def __init__(self, c: TiTokConfig):
        super().__init__()
        width, layers, heads = c.vit("dec")
        self.grid = c.image_size // c.vit_dec_patch_size
        self.decoder_embed = nn.Linear(c.token_size, width)
        self.mask_token = _embedding(1, 1, width, width=width)
        self.class_embedding = _embedding(1, width, width=width)
        self.positional_embedding = _embedding(self.grid ** 2 + 1, width, width=width)
        self.latent_token_positional_embedding = _embedding(c.num_latent_tokens, width, width=width)
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.ffn = nn.Sequential(nn.Conv2d(width, 2 * width, 1), nn.Tanh(),
                                 nn.Conv2d(2 * width, c.pixel_quantize_dim, 1))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, N, token_size) -> (B, g*g, 1024) logits."""
        B, N, _ = z.shape
        g2 = self.grid ** 2
        x = self.decoder_embed(z)
        mask = torch.cat([self.class_embedding.expand(B, 1, -1),
                          self.mask_token.expand(B, g2, -1)], 1).to(x.dtype)
        mask = mask + self.positional_embedding[: g2 + 1].to(x.dtype)
        x = x + self.latent_token_positional_embedding[:N].to(x.dtype)
        x = self.ln_pre(torch.cat([mask, x], 1))
        for block in self.transformer:
            x = block(x)
        x = self.ln_post(x[:, 1:1 + g2])
        return _conv1x1(torch.tanh(_conv1x1(x, self.ffn[0])), self.ffn[2])


def _group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps).to(x.dtype)


class _MaskGitResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.norm2 = nn.GroupNorm(groups, cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.nin_shortcut = nn.Conv2d(cout, cout, 1, bias=False) if cin != cout else None

    def forward(self, x):
        h = self.conv1(F.silu(_group_norm(x, self.norm1)))
        h = self.conv2(F.silu(_group_norm(h, self.norm2)))
        # MaskGIT's quirk: the 1x1 shortcut takes the block's OUTPUT
        return h + (self.nin_shortcut(h) if self.nin_shortcut is not None else x)


class _MaskGitUpBlock(nn.Module):
    def __init__(self, block_idx: int, hidden: int, mult: Tuple[int, ...], num_res_blocks: int,
                 groups: int):
        super().__init__()
        block_in = hidden * (mult[-1] if block_idx == len(mult) - 1 else mult[block_idx + 1])
        block_out = hidden * mult[block_idx]
        self.block = nn.ModuleList()
        for _ in range(num_res_blocks):
            self.block.append(_MaskGitResBlock(block_in, block_out, groups))
            block_in = block_out
        self.upsample_conv = nn.Conv2d(block_out, block_out, 3, padding=1) if block_idx else None

    def forward(self, x):
        for blk in self.block:
            x = blk(x)
        if self.upsample_conv is not None:
            x = self.upsample_conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        return x


class _PixelDecoder(nn.Module):
    def __init__(self, c: TiTokConfig):
        super().__init__()
        mult, hidden = c.pixel_channel_mult, c.pixel_hidden_channels
        block_in = hidden * mult[-1]
        self.conv_in = nn.Conv2d(c.pixel_z_channels, block_in, 3, padding=1)
        self.mid = nn.ModuleList(_MaskGitResBlock(block_in, block_in, c.group_norm_groups)
                                 for _ in range(c.pixel_num_res_blocks))
        self.up = nn.ModuleList(
            _MaskGitUpBlock(i, hidden, mult, c.pixel_num_res_blocks, c.group_norm_groups)
            for i in range(len(mult)))
        self.norm_out = nn.GroupNorm(c.group_norm_groups, hidden * mult[0], eps=1e-6)
        self.conv_out = nn.Conv2d(hidden * mult[0], 3, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        for blk in self.mid:
            h = blk(h)
        for up in reversed(self.up):  # block n-1 first
            h = up(h)
        return self.conv_out(F.silu(_group_norm(h, self.norm_out)))


class TiTokKL(nn.Module):
    """``encode``: (B, 3, H, W) -> a DiagonalGaussian over (B, N,
    token_size); ``decode``: (B, N, token_size) -> (B, 3, H, W)."""

    def __init__(self, cfg: TiTokConfig):
        super().__init__()
        self.cfg = cfg
        width = cfg.vit("enc")[0]
        self.latent_tokens = _embedding(cfg.num_latent_tokens, width, width=width)
        self.encoder = _TiTokEncoder(cfg)
        self.decoder = _TiTokDecoder(cfg)
        self.pixel_quantize_conv = nn.Conv2d(cfg.pixel_quantize_dim, cfg.pixel_z_channels, 1)
        self.pixel_decoder = _PixelDecoder(cfg)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian.from_parameters(self.encoder(x, self.latent_tokens), dim=-1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        if self.cfg.use_l2_norm:  # over the token_size channel
            z = z / z.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        logits = self.decoder(z)
        latent = _conv1x1(torch.softmax(logits, dim=-1), self.pixel_quantize_conv)
        g = self.decoder.grid
        return self.pixel_decoder(latent.transpose(1, 2).reshape(z.shape[0], -1, g, g))
