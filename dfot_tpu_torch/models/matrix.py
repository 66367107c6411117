"""Matrix attention in PyTorch: factorized column x row attention over frames.

Port of ``dfot_tpu/models/matrix.py`` (``MatrixAttention``,
``MatrixDiTBlock``). A frame's tokens form an (N patches x D channels)
matrix; learned projections U (over the patch axis) and V (over the
channels) embed it, attention runs over the frame axis with each (n, d)
head matrix (or, with ``multi_token``, each of its n rows) as one element,
and U and V map back.

The block is a chain of products that the JAX package computes outside any
Pallas kernel, and so it launches none of the port's kernels here: the
products are ``torch.einsum`` (cuBLAS on the card), and the block's
LayerNorm + modulate is the plain chain, as in JAX (not kernel B8).

Parameters keep the upstream names and the flax layouts, which
``dfot_tpu/utils/torch_ckpt.py:import_dit3d_params`` carries over as they
are: ``qkv_u`` (N, E_col), ``proj_u`` (E_col, N), ``qkv_v`` (D, 3 E_row),
``proj_v`` (E_row, D), and with ``use_bias`` ``qkv_bias`` (E_col, 3 E_row)
and ``proj_bias`` (N, D). ``fixed_u="identity"`` has no U parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.qkv_prep import swap_pairs
from .embeddings import RopeTables

__all__ = ["MatrixAttention", "MatrixDiTBlock"]

LN_EPS = 1e-6


def _rotate(x: torch.Tensor, rope: RopeTables) -> torch.Tensor:
    """RoPE over the second-to-last axis of x (..., L, D), the table's first
    L rows (sign of the pair rotation folded into its sin)."""
    cos, sin = (t[: x.shape[-2]] for t in rope.cast(x.device, x.dtype))
    return x * cos + swap_pairs(x) * sin


class MatrixAttention(nn.Module):
    """x (B, L, N, D) -> (B, L, N, D): attention over the L frames with
    ``num_col_heads`` x ``num_row_heads`` heads of (E_col / c) x (E_row / r)
    matrices. ``rope``: temporal RoPE over the frames, on each head's
    flattened n * d row (``flatten_rope``) or on each of its n rows of d."""

    def __init__(self, col_dim: int, row_dim: int, embed_col_dim: int, embed_row_dim: int,
                 num_col_heads: int = 4, num_row_heads: int = 4, multi_token: bool = False,
                 flatten_rope: bool = False, use_bias: bool = False,
                 fixed_u: Optional[str] = None, rope: Optional[RopeTables] = None):
        super().__init__()
        if fixed_u not in (None, "identity"):
            raise ValueError(f"unknown fixed_u {fixed_u!r}")
        if fixed_u == "identity" and embed_col_dim != col_dim:
            raise ValueError(f"fixed_u='identity' needs embed_col_dim == {col_dim}")
        self.c, self.r = num_col_heads, num_row_heads
        self.n, self.d = embed_col_dim // num_col_heads, embed_row_dim // num_row_heads
        self.multi_token, self.flatten_rope, self.rope = multi_token, flatten_rope, rope
        self.fixed_u = fixed_u
        if fixed_u is None:
            self.qkv_u = nn.Parameter(torch.empty(col_dim, embed_col_dim))
            self.proj_u = nn.Parameter(torch.empty(embed_col_dim, col_dim))
        self.qkv_v = nn.Parameter(torch.empty(row_dim, 3 * embed_row_dim))
        self.proj_v = nn.Parameter(torch.empty(embed_row_dim, row_dim))
        self.use_bias = use_bias
        if use_bias:
            self.qkv_bias = nn.Parameter(torch.zeros(embed_col_dim, 3 * embed_row_dim))
            self.proj_bias = nn.Parameter(torch.zeros(col_dim, row_dim))
        for name in ("qkv_u", "proj_u", "qkv_v", "proj_v"):
            if hasattr(self, name):
                nn.init.xavier_uniform_(getattr(self, name))

    def _embed(self, u, x, v):
        """``einsum("nm,blnd,dk->blmk", u, x, v)``; u None is the identity."""
        if u is None:
            return torch.matmul(x, v)
        return torch.einsum("nm,blnd,dk->blmk", u, x, v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, N, D = x.shape
        c, r, n, d = self.c, self.r, self.n, self.d
        learned_u = self.fixed_u is None
        qkv = self._embed(self.qkv_u if learned_u else None, x, self.qkv_v)
        if self.use_bias:
            qkv = qkv + self.qkv_bias
        # (B, L, c*n, 3*r*d) -> (3, B, c, r, L, n, d)
        q, k, v = qkv.reshape(B, L, c, n, 3, r, d).permute(4, 0, 2, 5, 1, 3, 6)

        if self.rope is not None:
            if self.flatten_rope:
                q = _rotate(q.reshape(B, c, r, L, n * d), self.rope).reshape(q.shape)
                k = _rotate(k.reshape(B, c, r, L, n * d), self.rope).reshape(k.shape)
            else:  # per row n: RoPE over L on the last axis d
                q = _rotate(q.transpose(3, 4), self.rope).transpose(3, 4)
                k = _rotate(k.transpose(3, 4), self.rope).transpose(3, 4)

        # fp32 scores and softmax, cast back for the product with v
        if self.multi_token:
            qm, km, vm = (t.transpose(3, 4) for t in (q * d**-0.5, k, v))  # (B, c, r, n, L, d)
            s = torch.einsum("bcrnld,bcrnkd->bcrnlk", qm, km).float()
            a = F.softmax(s, dim=-1).to(vm.dtype)
            o = torch.einsum("bcrnlk,bcrnkd->bcrnld", a, vm).transpose(3, 4)
        else:
            s = torch.einsum("bcrlnd,bcrknd->bcrlk", q * (n * d) ** -0.5, k).float()
            a = F.softmax(s, dim=-1).to(v.dtype)
            o = torch.einsum("bcrlk,bcrknd->bcrlnd", a, v)

        # (B, c, r, L, n, d) -> (B, L, c*n, r*d)
        o = o.permute(0, 3, 1, 4, 2, 5).reshape(B, L, c * n, r * d)
        out = self._embed(self.proj_u if learned_u else None, o, self.proj_v)
        if self.use_bias:
            out = out + self.proj_bias
        return out


class MatrixDiTBlock(nn.Module):
    """AdaLN-Zero block whose mixer is :class:`MatrixAttention` over the
    frame axis. x, c: (B, T*P, C) tokens with token-wise conditioning, P =
    ``col_hidden_size`` patches a frame. As in the DiT block, the residual
    adds onto the normed, modulated tensor, not onto the block input."""

    def __init__(self, col_hidden_size: int, row_hidden_size: int, embed_col_dim: int,
                 embed_row_dim: int, num_col_heads: int, num_row_heads: int,
                 mlp_ratio: Optional[float] = 4.0, matrix_rope: Optional[RopeTables] = None,
                 flatten_matrix_rope: bool = False, matrix_multi_token: bool = False,
                 use_bias: bool = False, fixed_u: Optional[str] = None):
        from .dit import AdaModulation, Mlp

        super().__init__()
        C = row_hidden_size
        self.col_hidden_size = col_hidden_size
        self.norm1 = AdaModulation(C, 3)
        self.attn = MatrixAttention(
            col_hidden_size, row_hidden_size, embed_col_dim, embed_row_dim, num_col_heads,
            num_row_heads, matrix_multi_token, flatten_matrix_rope, use_bias, fixed_u,
            matrix_rope,
        )
        self.has_mlp = mlp_ratio is not None and mlp_ratio > 0
        if self.has_mlp:
            self.norm2 = AdaModulation(C, 3)
            self.mlp = Mlp(C, int(C * mlp_ratio))

    @staticmethod
    def _norm_modulate(x, shift, scale):
        """LayerNorm (no scale, no bias) + modulate, the plain chain."""
        return F.layer_norm(x, x.shape[-1:], eps=LN_EPS) * (1 + scale) + shift

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        B, TP, C = x.shape
        T = TP // self.col_hidden_size
        shift, scale, gate = self.norm1(c)
        h = self._norm_modulate(x, shift, scale)
        attn_out = self.attn(h.reshape(B, T, self.col_hidden_size, C)).reshape(B, TP, C)
        x = h + gate * attn_out
        if self.has_mlp:
            shift, scale, gate = self.norm2(c)
            h = self._norm_modulate(x, shift, scale)
            x = h + gate * self.mlp(h)
        return x
