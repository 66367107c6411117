"""Frozen image encoders of the VBench dimensions: CLIP and DINO.

Port of ``dfot_tpu/metrics/encoders.py``:

- :class:`CLIPVisionEncoder`, the CLIP visual tower (OpenAI ViT-B/32 and
  ViT-L/14): patch conv -> CLS + positional embeddings -> ``ln_pre`` ->
  pre-norm blocks with QuickGELU -> ``ln_post`` of the CLS token ``@ proj``.
  Its state-dict names are OpenAI's ``visual.*`` names without the
  ``visual.`` prefix (``transformer.resblocks.0.attn.in_proj_weight``), so
  ``import_clip_vision_params`` reads them with the prefix put back.
- :class:`DINOEncoder`, DINO ViT-B/16 in timm's names (``patch_embed.proj``,
  ``blocks.0.attn.qkv``, ``norm``); the CLS feature after the last norm.
- :func:`clip_preprocess` and :func:`dino_preprocess`: the 224 px cubic
  resize of ``metrics/resize.py`` (Keys a = -0.5, antialiased when it
  downsamples), then each model's normalization.

Both take (B, 224, 224, 3) channels last, as the JAX modules. Their
attention is a plain chain of matmuls and a softmax in fp32, as the JAX
package's einsums (no Pallas kernel there, none here).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .resize import resize

__all__ = ["CLIPVisionConfig", "CLIPVisionEncoder", "DINOConfig", "DINOEncoder", "CLIP_B32",
           "CLIP_L14", "DINO_B16", "clip_preprocess", "dino_preprocess"]

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _resize_normalize(x: torch.Tensor, size: int, mean, std) -> torch.Tensor:
    x = resize(x, (x.shape[0], size, size, 3), "cubic")
    mean = torch.tensor(mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(std, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def clip_preprocess(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    return _resize_normalize(x, size, CLIP_MEAN, CLIP_STD)


def dino_preprocess(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    return _resize_normalize(x, size, IMAGENET_MEAN, IMAGENET_STD)


def _attend(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Packed (B, L, 3C) q, k, v -> (B, L, C): softmax(q k^T / sqrt(d)) v."""
    B, L, C3 = qkv.shape
    d = C3 // (3 * heads)
    q, k, v = qkv.view(B, L, 3, heads, d).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q, k.transpose(-1, -2)).float() * d**-0.5
    a = torch.softmax(s, dim=-1).to(qkv.dtype)
    return torch.matmul(a, v).transpose(1, 2).reshape(B, L, C3 // 3)


# ---------------------------------------------------------------------------
# CLIP visual tower (OpenAI names)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512


CLIP_B32 = CLIPVisionConfig()
CLIP_L14 = CLIPVisionConfig(patch_size=14, width=1024, layers=24, heads=16, output_dim=768)


class _InProjAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameter names (``in_proj_weight``,
    ``in_proj_bias``, ``out_proj``)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        return self.out_proj(_attend(F.linear(x, self.in_proj_weight, self.in_proj_bias),
                                     self.heads))


class _CLIPMLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.c_fc = nn.Linear(dim, 4 * dim)
        self.c_proj = nn.Linear(4 * dim, dim)

    def forward(self, x):
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))  # QuickGELU


class _CLIPBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = _InProjAttention(dim, heads)
        self.ln_2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _CLIPMLP(dim)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, dim: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(_CLIPBlock(dim, heads) for _ in range(layers))


class CLIPVisionEncoder(nn.Module):
    """(B, 224, 224, 3) CLIP-normalized -> (B, output_dim) image embedding."""

    def __init__(self, cfg: CLIPVisionConfig = CLIP_B32):
        super().__init__()
        c = self.cfg = cfg
        grid = c.image_size // c.patch_size
        scale = c.width**-0.5
        self.conv1 = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size, bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn(c.width))
        self.positional_embedding = nn.Parameter(scale * torch.randn(grid * grid + 1, c.width))
        self.ln_pre = nn.LayerNorm(c.width, eps=1e-5)
        self.transformer = _Transformer(c.width, c.layers, c.heads)
        self.ln_post = nn.LayerNorm(c.width, eps=1e-5)
        self.proj = nn.Parameter(scale * torch.randn(c.width, c.output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = self.conv1(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(h.dtype).expand(B, 1, -1)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(h.dtype)
        h = self.ln_pre(h)
        for block in self.transformer.resblocks:
            h = block(h)
        return self.ln_post(h[:, 0]) @ self.proj


# ---------------------------------------------------------------------------
# DINO ViT (timm names)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12


DINO_B16 = DINOConfig()


class _QKVAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        return self.proj(_attend(self.qkv(x), self.heads))


class _DINOMLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _DINOBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _QKVAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _DINOMLP(dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DINOEncoder(nn.Module):
    """(B, 224, 224, 3) ImageNet-normalized -> (B, width) CLS feature."""

    def __init__(self, cfg: DINOConfig = DINO_B16):
        super().__init__()
        c = self.cfg = cfg
        grid = c.image_size // c.patch_size
        self.patch_embed = _PatchEmbed(c.patch_size, c.width)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width))
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, grid * grid + 1, c.width))
        self.blocks = nn.ModuleList(_DINOBlock(c.width, c.heads) for _ in range(c.layers))
        self.norm = nn.LayerNorm(c.width, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        h = self.patch_embed.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        h = torch.cat([self.cls_token.to(h.dtype).expand(B, -1, -1), h], dim=1)
        h = h + self.pos_embed.to(h.dtype)
        for block in self.blocks:
            h = block(h)
        return self.norm(h)[:, 0]
