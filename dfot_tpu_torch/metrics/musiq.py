"""MUSIQ, the multi-scale image quality transformer of VBench's
``imaging_quality`` (Ke et al. 2021, the ``musiq_spaq`` configuration).

Port of ``dfot_tpu/metrics/musiq.py``: images (B, H, W, 3) in [0, 1] -> (B,)
scores from 0 to 100.

- The image and its aspect-preserving resizes to a longer side of 384 and
  224 (``jax.image.resize(..., "bilinear")``, antialiased:
  ``metrics/resize.py``) are cut into 32 x 32 patches (:func:`multiscale_tokens`;
  the hash-grid and scale indices and the ``valid`` mask are host numpy, as
  in JAX).
- Each patch runs through a weight-standardized 7x7/2 convolution (the
  kernel standardized over (in, kh, kw) with the biased variance and
  ``+1e-10``), ``GroupNorm(32, eps=1e-6)``, a ReLU and a 3x3/2 max-pool,
  both with flax's ``SAME`` padding, which pads (2, 3) and (0, 1) on these
  even sizes, not (3, 3) and (1, 1). The 8 x 8 x 64 result is flattened in
  (h, w, c) order, as flax's NHWC, and projected to 384.
- The tokens get the hash-grid and scale embeddings, a CLS token, 14
  pre-norm blocks (6 heads, the masked scores filled with -1e9, the tanh
  GELU of flax), a final LayerNorm and a linear head on the CLS token.

The parameter names are ones ``dfot_tpu.metrics.musiq.import_musiq_params``
maps (``conv_root``, ``gn_root``, ``embedding``, ``cls_token``, ``pos_emb``,
``scale_emb``, ``blocks.<i>.norm1``, ``.attn.qkv``, ``.attn.out``,
``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``, ``encoder_norm``, ``head``), so that
it gives the JAX tree from this state dict; ``utils/weights.py:
musiq_state_dict_from_flax`` goes the other way.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .i3d import same_pads
from .resize import resize

__all__ = ["MUSIQ", "multiscale_tokens", "scale_sizes"]


class StdConv(nn.Conv2d):
    """A weight-standardized convolution without bias, flax ``SAME`` padding."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__(cin, cout, kernel, stride=stride, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mean) / torch.sqrt(var + 1e-10)
        x = F.pad(x, same_pads(x.shape[2:], self.kernel_size, self.stride))
        return F.conv2d(x, w, stride=self.stride)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        d = C // self.heads
        q, k, v = (t.reshape(B, N, self.heads, d).transpose(1, 2) for t in self.qkv(x).chunk(3, -1))
        att = torch.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
        att = torch.where(mask[:, None, None, :], att, torch.full_like(att, -1e9))
        o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(att, dim=-1), v)
        return self.out(o.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Block(nn.Module):
    """Pre-norm ViT block: x + MHA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp_dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), mask)
        return x + self.mlp(self.norm2(x))


def scale_sizes(H: int, W: int, longer_sides: Sequence[int]) -> list:
    """The native size and one (h, w) per longer side, aspect kept."""
    sizes = [(H, W)]
    for L in longer_sides:
        if H >= W:
            sizes.append((L, max(1, round(W * L / H))))
        else:
            sizes.append((max(1, round(H * L / W)), L))
    return sizes


def multiscale_tokens(images: torch.Tensor, patch: int, grid: int, longer_sides: Sequence[int]):
    """images (B, H, W, C) -> (patches (B, N, patch, patch, C), hse_idx (N,),
    scale_idx (N,), valid (N,)); the indices and the mask are numpy.

    Each scale is zero-padded to a patch multiple and cut row by row; a
    patch's hash index is ``min(row * G // rows, G - 1) * G + min(col * G //
    cols, G - 1)``, and it is valid when its top-left corner lies inside the
    unpadded image."""
    B, H, W, C = images.shape
    all_patches, hse, scale_idx, valid = [], [], [], []
    for s, (h, w) in enumerate(scale_sizes(H, W, longer_sides)):
        img = images if s == 0 else resize(images, (B, h, w, C), "bilinear")
        ph, pw = (-h) % patch, (-w) % patch
        if ph or pw:
            img = F.pad(img, (0, 0, 0, pw, 0, ph))
        rows, cols = (h + ph) // patch, (w + pw) // patch
        p = img.reshape(B, rows, patch, cols, patch, C).transpose(2, 3)
        all_patches.append(p.reshape(B, rows * cols, patch, patch, C))
        r = np.arange(rows)[:, None] * np.ones((1, cols), np.int64)
        c = np.ones((rows, 1), np.int64) * np.arange(cols)[None]
        hse.append((np.minimum(r * grid // rows, grid - 1) * grid
                    + np.minimum(c * grid // cols, grid - 1)).reshape(-1))
        scale_idx.append(np.full(rows * cols, s, np.int64))
        valid.append(((r * patch < h) & (c * patch < w)).reshape(-1))
    return (torch.cat(all_patches, 1), np.concatenate(hse), np.concatenate(scale_idx),
            np.concatenate(valid))


class MUSIQ(nn.Module):
    """(B, H, W, 3) in [0, 1] -> (B,) quality scores (0-100)."""

    def __init__(self, hidden: int = 384, layers: int = 14, heads: int = 6, mlp_dim: int = 1152,
                 patch: int = 32, grid: int = 10, num_scales: int = 3,
                 longer_sides: Tuple[int, ...] = (384, 224), num_class: int = 1,
                 root_dim: int = 64):
        super().__init__()
        self.patch, self.grid, self.longer_sides = patch, grid, tuple(longer_sides)
        self.num_class = num_class
        self.conv_root = StdConv(3, root_dim, 7, 2)
        self.gn_root = nn.GroupNorm(32, root_dim, eps=1e-6)
        self.embedding = nn.Linear(root_dim * (patch // 4) ** 2, hidden)
        self.pos_emb = nn.Parameter(torch.zeros(grid * grid, hidden))
        self.scale_emb = nn.Parameter(torch.zeros(num_scales, hidden))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.blocks = nn.ModuleList(Block(hidden, heads, mlp_dim) for _ in range(layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.head = nn.Linear(hidden, num_class)

    def encode_patches(self, patches: torch.Tensor) -> torch.Tensor:
        """(n, P, P, 3) -> (n, hidden): the ResNet root stem and the projection."""
        h = F.relu(self.gn_root(self.conv_root(patches.permute(0, 3, 1, 2))))
        h = F.pad(h, same_pads(h.shape[2:], (3, 3), (2, 2)), value=float("-inf"))
        h = F.max_pool2d(h, 3, 2)
        return self.embedding(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B = images.shape[0]
        patches, hse_idx, scale_idx, valid = multiscale_tokens(
            images * 2.0 - 1.0, self.patch, self.grid, self.longer_sides)
        N = patches.shape[1]
        tok = self.encode_patches(patches.reshape((B * N,) + tuple(patches.shape[2:])))
        dev = images.device
        tok = (tok.reshape(B, N, -1) + self.pos_emb[torch.as_tensor(hse_idx, device=dev)]
               + self.scale_emb[torch.as_tensor(scale_idx, device=dev)])
        tok = torch.cat([self.cls_token.expand(B, 1, -1), tok], 1)
        mask = torch.as_tensor(np.concatenate([[True], valid]), device=dev)[None].expand(B, -1)
        for block in self.blocks:
            tok = block(tok, mask)
        out = self.head(self.encoder_norm(tok)[:, 0])
        return out[:, 0] if self.num_class == 1 else out
