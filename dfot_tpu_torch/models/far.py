"""FAR-DiT, the frame-autoregressive DiT, in PyTorch.

Port of ``dfot_tpu/models/far.py``: linear patch embedding, 3-axis RoPE over
(frame, row, column) token ids, AdaLN-Zero-single blocks, frame-level causal
attention with an ALiBi-like bias (``slope_scale`` times the frame
distance), a continuous AdaLN output head. Video (B, T, H, W, C)
channel-last in and out, (B, T*P, C) tokens inside; a token's features are
its patch in (C, p, p) order.

Module and parameter names are the upstream torch names that
``dfot_tpu/utils/torch_ckpt.py:import_far_params`` reads
(``x_embedder``, ``timestep_embedder``, ``transformer_blocks.N.norm1.linear``,
``...attn.to_q`` / ``to_k`` / ``to_v`` / ``norm_q`` / ``to_out.0``,
``...mlp.net.0.proj`` / ``net.2``, ``norm_out.linear``, ``proj_out``). The
three projections run as one matmul on their concatenated weights, the
packed projection of the JAX model.

The attention is einsums, the bias and a softmax on fp32 scores, as in the
JAX package, which gives it no Pallas kernel: this model launches none of
the port's kernels. With ``use_gradient_checkpointing`` every block runs
under :func:`dfot_tpu_torch.models.remat.remat` (its attention output is the
tensor the ``attn`` policies keep).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .embeddings import LabelEmbedding, RopeTables, TimestepEmbedding, make_rope_nd, timestep_embedding
from .remat import attn_out, remat, saved_ops
from .uvit import RMSNorm
from ..ops.qkv_prep import swap_pairs

__all__ = ["FARSpec", "FARBlock", "FARDiT"]

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class FARSpec:
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    patch_size: int = 2
    axes_dims_rope: Tuple[int, int, int] = (16, 24, 24)
    slope_scale: float = 0.0
    max_temporal_length: int = 16
    use_gradient_checkpointing: bool = False
    remat_policy: Optional[str] = None

    @classmethod
    def from_config(cls, cfg, max_tokens: int) -> "FARSpec":
        """From the ``algorithm.backbone`` node, as the JAX spec reads it."""
        return cls(
            hidden_size=cfg.hidden_size,
            depth=cfg.depth,
            num_heads=cfg.num_heads,
            mlp_ratio=cfg.mlp_ratio,
            patch_size=cfg.patch_size,
            axes_dims_rope=tuple(cfg.get("axes_dims_rope", (16, 24, 24))),
            slope_scale=cfg.get("slope_scale", 0.0),
            max_temporal_length=max_tokens,
            use_gradient_checkpointing=cfg.get("use_gradient_checkpointing", False),
            remat_policy=cfg.get("remat_policy"),
        )


class _AdaNorm(nn.Module):
    """SiLU + linear (``linear``) giving ``n`` modulation tensors."""

    def __init__(self, dim: int, n: int):
        super().__init__()
        self.n = n
        self.linear = nn.Linear(dim, n * dim)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, c: torch.Tensor):
        return self.linear(F.silu(c)).chunk(self.n, dim=-1)


def _modulate(x, shift, scale):
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS) * (1 + scale) + shift


class FARAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        d = dim // num_heads
        self.to_q, self.to_k, self.to_v = (nn.Linear(dim, dim) for _ in range(3))
        self.norm_q, self.norm_k = RMSNorm(d), RMSNorm(d)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x: torch.Tensor, rope: RopeTables, bias: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H, d = self.num_heads, C // self.num_heads
        w = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
        b = torch.cat([self.to_q.bias, self.to_k.bias, self.to_v.bias])
        q, k, v = F.linear(x, w, b).reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
        q, k = self.norm_q(q), self.norm_k(k)
        cos, sin = (t[:N] for t in rope.cast(x.device, q.dtype))
        q = q * cos + swap_pairs(q) * sin
        k = k * cos + swap_pairs(k) * sin
        # frame-causal mask and slope bias on fp32 scores
        s = torch.einsum("bhnd,bhmd->bhnm", q, k).float() / math.sqrt(d) + bias
        a = s.softmax(dim=-1).to(v.dtype)
        with attn_out():
            o = torch.einsum("bhnm,bhmd->bhnd", a, v)
        return self.to_out[0](o.transpose(1, 2).reshape(B, N, C))


class _GeluProj(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.proj = nn.Linear(dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(_GeluProj(dim, hidden), nn.Identity(), nn.Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class FARBlock(nn.Module):
    """AdaLN-Zero-single attention and FF with frame-causal biased attention.
    The FF is always 4x wide: upstream builds it without ``mlp_ratio``."""

    def __init__(self, dim: int, num_heads: int, rope: RopeTables):
        super().__init__()
        self.rope = rope
        self.norm1 = _AdaNorm(dim, 3)
        self.attn = FARAttention(dim, num_heads)
        self.norm2 = _AdaNorm(dim, 3)
        self.mlp = FeedForward(dim, int(dim * 4.0))

    def forward(self, x: torch.Tensor, c: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.norm1(c)
        x = x + gate * self.attn(_modulate(x, shift, scale), self.rope, bias)
        shift, scale, gate = self.norm2(c)
        return x + gate * self.mlp(_modulate(x, shift, scale))


class FARDiT(nn.Module):
    def __init__(self, spec: FARSpec, x_channels: int, resolution: Tuple[int, int],
                 external_cond_type: Optional[str] = None, external_cond_dim: int = 0,
                 external_cond_num_classes: Optional[int] = None,
                 external_cond_dropout: float = 0.1, use_fourier_noise_emb: bool = False):
        super().__init__()
        s = spec
        self.spec, self.x_channels = s, x_channels
        self.external_cond_type = external_cond_type
        p, D = s.patch_size, s.hidden_size
        self.grid = (resolution[0] // p, resolution[1] // p)
        head_dim = D // s.num_heads
        if sum(s.axes_dims_rope) != head_dim:
            raise ValueError(
                f"axes_dims_rope {s.axes_dims_rope} must sum to the head dim {head_dim} "
                f"(hidden_size {D} / num_heads {s.num_heads}); set "
                "++algorithm.backbone.axes_dims_rope")
        if s.use_gradient_checkpointing:
            saved_ops(s.remat_policy)  # an unknown name raises here
        rope = RopeTables(make_rope_nd(s.axes_dims_rope, (s.max_temporal_length,) + self.grid))
        self.x_embedder = nn.Linear(x_channels * p * p, D)
        self.timestep_embedder = TimestepEmbedding(256, D)
        if external_cond_type is not None:
            self.external_cond_embedding = LabelEmbedding(external_cond_num_classes, D,
                                                          external_cond_dropout)
        self.transformer_blocks = nn.ModuleList(
            FARBlock(D, s.num_heads, rope) for _ in range(s.depth))
        self.norm_out = _AdaNorm(D, 2)
        self.proj_out = nn.Linear(D, p * p * x_channels)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)
        self._bias: Dict[tuple, torch.Tensor] = {}

    def causal_bias(self, T: int, P: int, device) -> torch.Tensor:
        """(1, 1, T*P, T*P) fp32: 0 plus ``slope_scale`` times the frame
        distance (key frame minus query frame) where the key's frame is not
        after the query's, -1e30 where it is."""
        key = (T, P, device)
        if key not in self._bias:
            frame = np.arange(T * P) // P
            allowed = frame[:, None] >= frame[None, :]
            rel = self.spec.slope_scale * (frame[None, :] - frame[:, None])
            bias = np.where(allowed, rel, -1e30).astype(np.float32)
            self._bias[key] = torch.as_tensor(bias[None, None], device=device)
        return self._bias[key]

    def forward(self, x, noise_levels, external_cond=None, external_cond_mask=None
                ) -> torch.Tensor:
        s = self.spec
        B, T, H, W, C = x.shape
        p, (gh, gw) = s.patch_size, self.grid
        P = gh * gw
        tok = x.reshape(B, T, gh, p, gw, p, C).permute(0, 1, 2, 4, 6, 3, 5)
        h = self.x_embedder(tok.reshape(B, T * P, C * p * p).to(self.x_embedder.weight.dtype))

        emb = self.timestep_embedder(timestep_embedding(noise_levels, 256,
                                                        downscale_freq_shift=1.0))
        if external_cond is not None and self.external_cond_type is not None:
            cond = self.external_cond_embedding(external_cond, external_cond_mask)
            if cond.ndim == 2:
                cond = cond[:, None]
            emb = emb + cond.to(emb.dtype)
        c = emb.repeat_interleave(P, dim=1)  # (B, T*P, D)

        bias = self.causal_bias(T, P, x.device)
        for block in self.transformer_blocks:
            if s.use_gradient_checkpointing and torch.is_grad_enabled():
                h = remat(s.remat_policy)(block, h, c, bias)
            else:
                h = block(h, c, bias)

        scale, shift = self.norm_out(c)
        out = self.proj_out(F.layer_norm(h, h.shape[-1:], eps=LN_EPS) * (1 + scale) + shift)
        out = out.reshape(B, T, gh, gw, C, p, p).permute(0, 1, 2, 5, 3, 6, 4)
        return out.reshape(B, T, H, W, C).float()
