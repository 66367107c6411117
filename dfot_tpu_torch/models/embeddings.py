"""Embedding modules: noise level, labels, vector conditions, patches, RoPE
and sinusoidal position tables.

Port of ``dfot_tpu/models/embeddings.py``, the difference-DiT's twin-stream
RoPE (``make_rope_3d(..., double_merge=...)``) included. Module and parameter names are the
upstream torch names, so an upstream state dict loads as is
(``noise_level_pos_embedding.*``, ``external_cond_embedding.*``). The RoPE and
sinusoidal tables are host numpy, copies of the JAX package's (whose module
imports flax).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "timestep_embedding",
    "TimestepEmbedding",
    "FourierEmbedding",
    "StochasticTimeEmbedding",
    "LabelEmbedding",
    "RandomDropoutCondEmbedding",
    "PatchEmbed",
    "patchify",
    "get_nd_sincos_pos_embed",
    "DeviceTable",
    "RopeTables",
    "RoPE",
    "make_rope_nd",
    "make_rope_1d",
    "make_rope_2d",
    "make_rope_3d",
    "apply_rope",
]


def timestep_embedding(
    t: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal embedding of (possibly fractional) timesteps, (..., dim)."""
    half = dim // 2
    # frequencies in float64 on the host, as the JAX package computes them
    exponent = -math.log(max_period) * np.arange(half, dtype=np.float64)
    freqs = np.exp(exponent / (half - downscale_freq_shift)).astype(np.float32)
    emb = t.float()[..., None] * torch.as_tensor(freqs, device=t.device)
    emb = torch.cat([emb.sin(), emb.cos()], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[..., half:], emb[..., :half]], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP (``linear_1``, ``linear_2``)."""

    def __init__(self, in_dim: int, emb_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, emb_dim)
        self.linear_2 = nn.Linear(emb_dim, emb_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.linear_1.weight.dtype)
        return self.linear_2(F.silu(self.linear_1(x)))


class FourierEmbedding(nn.Module):
    """EDM2 random Fourier features of continuous noise levels. ``freqs``
    and ``phases`` are fixed buffers (carried by checkpoints)."""

    def __init__(self, dim: int, bandwidth: float = 1.0):
        super().__init__()
        # fixed-seed draws, as the JAX package draws from fixed keys (the
        # values differ from its; weights loaded later replace both)
        freqs = torch.randn(dim, generator=torch.Generator().manual_seed(0), device="cpu")
        phases = torch.rand(dim, generator=torch.Generator().manual_seed(1), device="cpu")
        device = torch.empty(0).device  # the device the module is being built on
        self.register_buffer("freqs", (2 * math.pi * freqs * bandwidth).to(device))
        self.register_buffer("phases", (2 * math.pi * phases).to(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float()[..., None] * self.freqs.float() + self.phases.float()
        return (torch.cos(y) * math.sqrt(2.0)).to(x.dtype)


class StochasticTimeEmbedding(nn.Module):
    """Noise-level embedding: sinusoidal or Fourier features (``timesteps``)
    then a SiLU MLP (``embedding``).

    With ``p`` > 0 (sinusoidal features only) the module owns a learned
    "unknown level" token: in training mode each position takes it with
    probability ``p`` (a draw from the device's global generator, which the
    train step seeds), in eval mode wherever ``mask`` is True. The UViT
    builds it with ``p`` = 0."""

    def __init__(self, dim: int, emb_dim: int, use_fourier: bool = False, p: float = 0.0):
        super().__init__()
        self.dim, self.p = dim, p
        self.timesteps = FourierEmbedding(dim) if use_fourier else None
        if p > 0.0 and not use_fourier:
            self.unknown_token = nn.Parameter(torch.randn(1, dim))
        self.embedding = TimestepEmbedding(dim, emb_dim)

    def forward(self, noise_levels: torch.Tensor, mask=None) -> torch.Tensor:
        if self.timesteps is not None:
            emb = self.timesteps(noise_levels)
        else:
            emb = timestep_embedding(noise_levels, self.dim)
            if self.p > 0.0:
                if self.training or self.p == 1.0 or mask is None:
                    mask = torch.rand(emb.shape[:-1], device=emb.device) < self.p
                emb = torch.where(mask[..., None], self.unknown_token.to(emb.dtype), emb)
        return self.embedding(emb)


class LabelEmbedding(nn.Module):
    """Class-label embedding table; with ``dropout_prob`` > 0 it has one more
    row, the null class of classifier-free guidance: in training mode each
    label takes it with that probability (a draw from the device's global
    generator), in eval mode wherever ``mask`` is True."""

    def __init__(self, num_classes: int, emb_dim: int, dropout_prob: float = 0.0):
        super().__init__()
        self.num_classes, self.dropout_prob = num_classes, dropout_prob
        self.embedding_table = nn.Embedding(num_classes + int(dropout_prob > 0), emb_dim)

    def forward(self, labels: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        labels = labels.long()
        if self.dropout_prob > 0:
            if self.training:
                mask = torch.rand(labels.shape, device=labels.device) < self.dropout_prob
            if mask is not None:
                labels = torch.where(mask, self.num_classes, labels)
        return self.embedding_table(labels)


class RandomDropoutCondEmbedding(nn.Module):
    """Embedding of a continuous condition (actions) by a SiLU MLP
    (``embedding``), zeroed for a whole sample with probability
    ``dropout_prob`` in training mode and wherever ``mask`` is True."""

    def __init__(self, in_dim: int, emb_dim: int, dropout_prob: float = 0.0):
        super().__init__()
        self.dropout_prob = dropout_prob
        self.embedding = TimestepEmbedding(in_dim, emb_dim)

    def forward(self, cond: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.embedding(cond)
        if self.dropout_prob > 0 and self.training:
            mask = torch.rand(emb.shape[:1], device=emb.device) < self.dropout_prob
        if mask is not None:
            mask = mask.reshape(mask.shape + (1,) * (emb.ndim - mask.ndim))
            emb = torch.where(mask, 0.0, emb)
        return emb


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., H/p * W/p, p*p*C) patch rows in (p_h, p_w, C)
    order."""
    *lead, H, W, C = x.shape
    x = x.reshape(*lead, H // p, p, W // p, p, C).transpose(-4, -3)
    return x.reshape(*lead, (H // p) * (W // p), p * p * C)


def conv_as_patch_matrix(weight: torch.Tensor) -> torch.Tensor:
    """A stride == kernel Conv2d weight (D, C, p, p) as the (D, p*p*C)
    matrix that acts on :func:`patchify` rows."""
    D, C, p, _ = weight.shape
    return weight.permute(0, 2, 3, 1).reshape(D, p * p * C)


class PatchEmbed(nn.Module):
    """Patchify + linear projection; the weight keeps the upstream stride-p
    Conv2d shape (``proj``) and is applied as one matmul on patch rows."""

    def __init__(self, patch_size: int, in_channels: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., H, W, C) channel-last -> (..., H/p * W/p, dim)."""
        w = self.proj.weight
        x = patchify(x.to(w.dtype), self.patch_size)
        return F.linear(x, conv_as_patch_matrix(w), self.proj.bias)


def get_nd_sincos_pos_embed(embed_dim: int, shape: Sequence[int]) -> np.ndarray:
    """N-D sinusoidal position table, (prod(shape), embed_dim) float32:
    per-axis sin || cos tables of embed_dim / ndim channels, concatenated. The
    grid is ``np.meshgrid``'s default 'xy' indexing, which swaps the first
    two axes: the published tables are built so."""
    ndim = len(shape)
    assert embed_dim % (2 * ndim) == 0
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape]), axis=0)

    def _1d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate(
        [_1d(embed_dim // ndim, grid[i]) for i in range(ndim)], axis=1
    ).astype(np.float32)


class DeviceTable:
    """A host numpy table with one copy per (device, dtype), made at first
    use."""

    def __init__(self, table: np.ndarray):
        self._np = np.asarray(table, dtype=np.float32)
        self._dev: Dict[tuple, torch.Tensor] = {}

    def __len__(self) -> int:
        return len(self._np)

    def on(self, device, dtype=torch.float32) -> torch.Tensor:
        key = (device, dtype)
        if key not in self._dev:
            self._dev[key] = torch.as_tensor(self._np, device=device).to(dtype)
        return self._dev[key]


# ---------------------------------------------------------------------------
# Rotary position embeddings (axial, N-dimensional), host numpy tables
# ---------------------------------------------------------------------------


class RoPE:
    """Precomputed rotary tables: cos/sin of shape (N_flat, dim), numpy."""

    __slots__ = ("cos", "sin", "sizes")

    def __init__(self, cos: np.ndarray, sin: np.ndarray, sizes: Tuple[int, ...]):
        self.cos = np.asarray(cos, dtype=np.float32)
        self.sin = np.asarray(sin, dtype=np.float32)
        self.sizes = sizes


class RopeTables:
    """RoPE tables on the device (fp32, sign folded into sin), shared by the
    blocks that rotate alike, with one copy per device made at first use."""

    def __init__(self, rope: RoPE):
        # rotate_half's (-1, +1) pair sign folded into the sin table
        sin = np.array(rope.sin, copy=True)
        sin[..., 0::2] = -sin[..., 0::2]
        self._np = (rope.cos, sin)
        self._dev: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._cast: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        if device not in self._dev:
            self._dev[device] = tuple(
                torch.as_tensor(t, dtype=torch.float32, device=device) for t in self._np
            )
        return self._dev[device]

    def cast(self, device, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """(cos, signed sin) in ``dtype``, for blocks that fold no learned
        scale into them; cached."""
        key = (device, dtype)
        if key not in self._cast:
            self._cast[key] = tuple(t.to(dtype).contiguous() for t in self.on(device))
        return self._cast[key]


def _axis_freqs(dim: int, seq_len: int, theta: float) -> np.ndarray:
    """Per-axis angles (seq_len, dim), each frequency repeated twice for the
    adjacent-pair rotation convention."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    angles = np.outer(np.arange(seq_len, dtype=np.float64), freqs)
    return np.repeat(angles, 2, axis=-1)


def make_rope_nd(dims: Sequence[int], sizes: Sequence[int], theta: float = 10000.0) -> RoPE:
    """Axial RoPE over an N-D grid, flattened row-major to (prod(sizes), sum(dims))."""
    grids = []
    for i, (dim, size) in enumerate(zip(dims, sizes)):
        ang = _axis_freqs(dim, size, theta)
        shape = [1] * len(sizes) + [dim]
        shape[i] = size
        grids.append(np.broadcast_to(ang.reshape(shape), tuple(sizes) + (dim,)))
    angles = np.concatenate(grids, axis=-1).reshape(-1, sum(dims))
    return RoPE(np.cos(angles), np.sin(angles), tuple(sizes))


def make_rope_1d(dim: int, seq_len: int, theta: float = 10000.0) -> RoPE:
    return make_rope_nd((dim,), (seq_len,), theta)


def make_rope_2d(dim: int, sizes: Tuple[int, int], theta: float = 10000.0) -> RoPE:
    assert dim % 2 == 0
    return make_rope_nd((dim // 2, dim // 2), sizes, theta)


def make_rope_3d(dim: int, sizes: Tuple[int, int, int], theta: float = 10000.0,
                 double_merge: Optional[str] = None) -> RoPE:
    """3-axis split: head_dim // 2 frequencies across (T, H, W), H and W
    getting equal counts (the reference's uneven-dim rule).

    ``double_merge`` (``"concat"`` | ``"interleaved"``) doubles the table for
    the difference-DiT's twin (difference, frame) streams, which share their
    positions: ``concat`` lays the two copies out one after the other along
    time, ``interleaved`` repeats each frame's rows. A sequence shorter than
    the table takes its first rows, as every table here."""
    assert dim % 2 == 0
    half = dim // 2
    r = half % 3
    if r == 0:
        parts = (half // 3,) * 3
    elif r == 1:
        parts = (half // 3 + 1, half // 3, half // 3)
    else:
        parts = (half // 3, half // 3 + 1, half // 3 + 1)
    rope = make_rope_nd(tuple(p * 2 for p in parts), sizes, theta)
    if double_merge is None:
        return rope
    cos, sin = (t.reshape(sizes[0], -1, dim) for t in (rope.cos, rope.sin))
    if double_merge == "concat":
        cos, sin = np.concatenate([cos, cos]), np.concatenate([sin, sin])
    elif double_merge == "interleaved":
        cos, sin = np.repeat(cos, 2, axis=0), np.repeat(sin, 2, axis=0)
    else:
        raise ValueError(f"unknown double-rope merge {double_merge}")
    return RoPE(cos.reshape(-1, dim), sin.reshape(-1, dim), rope.sizes)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Adjacent-pair rotation: (x0, x1) -> (-x1, x0), interleaved."""
    x = x.reshape(x.shape[:-1] + (-1, 2))
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(x.shape[:-2] + (-1,))


def apply_rope(x: torch.Tensor, rope: RoPE) -> torch.Tensor:
    """Rotate (..., N, D) queries/keys with the first N rows of the table."""
    n = x.shape[-2]
    cos = torch.as_tensor(rope.cos[:n], dtype=x.dtype, device=x.device)
    sin = torch.as_tensor(rope.sin[:n], dtype=x.dtype, device=x.device)
    return x * cos + _rotate_half(x) * sin
