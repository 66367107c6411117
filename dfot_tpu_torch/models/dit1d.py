"""DiT1D, a DiT over rows of 1-D latent tokens (TiTok tokens), in PyTorch.

Port of ``dfot_tpu/models/dit1d.py``: each frame is a row of N tokens
(``x_shape`` (C, 1, N), taichi's (4, 1, 32)); tokens are linearly embedded, a
fixed 1-D sin || cos table is added (or 1-D RoPE rotates q and k over the
flattened T*N sequence), and the whole sequence runs through DiT blocks with
one 6-chunk adaLN modulation a block from the per-frame conditioning, under
a frame-level causal mask.

Upstream quirks the JAX package reproduces, and so the port:

- ``share_norm`` blocks REPLACE the residual stream by the normed tensor
  before each sub-layer (``x = norm(x); x = x + gate * attn(...)``);
- ``reproduce`` blocks take every modulation from the first frame;
- the timestep embedding is the DiT's cos-first sinusoid;
- the final layer is a plain LayerNorm and a zero-initialized linear.

Module and parameter names are the upstream torch names that
``dfot_tpu/utils/torch_ckpt.py:import_dit1d_params`` reads (``x_embedder``,
``t_embedder.mlp.0``, ``blocks.N.adaLN_modulation.1``, ``blocks.N.attn.qkv``,
``...attn.q_norm``, ``blocks.N.mlp.fc1``, ``final_layer.1``). The attention
is einsums and a softmax on fp32 scores, as in the JAX package, which gives
it no Pallas kernel: this model launches none of the port's kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .dit import Mlp
from .embeddings import (
    DeviceTable,
    LabelEmbedding,
    RopeTables,
    get_nd_sincos_pos_embed,
    make_rope_1d,
    timestep_embedding,
)
from .remat import attn_out, remat, saved_ops
from ..ops.qkv_prep import swap_pairs

__all__ = ["DiT1DSpec", "DiT1DBlock", "DiT1D"]

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DiT1DSpec:
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    learn_sigma: bool = False
    merge_mode: str = "share_norm"  # share_norm | reproduce
    # None | temporal_causal | video_temporal_causal (the same with no
    # context tokens)
    causal_attn_mode: Optional[str] = "video_temporal_causal"
    use_rotary_emb: bool = False
    qk_norm: bool = False
    max_temporal_length: int = 16
    use_gradient_checkpointing: bool = False
    remat_policy: Optional[str] = None

    @classmethod
    def from_config(cls, cfg, max_tokens: int) -> "DiT1DSpec":
        """From the ``algorithm.backbone`` node, as the JAX spec reads it."""
        return cls(
            hidden_size=cfg.hidden_size,
            depth=cfg.depth,
            num_heads=cfg.num_heads,
            mlp_ratio=cfg.mlp_ratio,
            learn_sigma=cfg.get("learn_sigma", False),
            merge_mode=cfg.get("merge_mode", "share_norm"),
            causal_attn_mode=cfg.get("causal_attn_mode"),
            use_rotary_emb=cfg.get("use_rotary_emb", False),
            qk_norm=cfg.get("qk_norm", False),
            max_temporal_length=max_tokens,
            use_gradient_checkpointing=cfg.get("use_gradient_checkpointing", False),
            remat_policy=cfg.get("remat_policy"),
        )


def _ln(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS)


def _per_frame(x: torch.Tensor, n: int, fn) -> torch.Tensor:
    """``fn`` on x (B, T*n, D) viewed as (B, T, n, D), back to (B, T*n, D)."""
    B, TN, D = x.shape
    return fn(x.reshape(B, TN // n, n, D)).reshape(B, TN, D)


class DiT1DAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qk_norm: bool):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if qk_norm:  # torch LayerNorm defaults: eps 1e-5, affine
            d = dim // num_heads
            self.q_norm, self.k_norm = nn.LayerNorm(d), nn.LayerNorm(d)
        self.qk_norm = qk_norm

    def forward(self, x, rope: Optional[RopeTables], bias: Optional[torch.Tensor]):
        B, N, _ = x.shape
        # num_heads is this rank's share of the heads under tensor parallelism
        H, d = self.num_heads, self.head_dim
        C = H * d
        q, k, v = self.qkv(x).reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
        if self.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        if rope is not None:
            cos, sin = (t[:N] for t in rope.cast(x.device, q.dtype))
            q = q * cos + swap_pairs(q) * sin
            k = k * cos + swap_pairs(k) * sin
        s = torch.einsum("bhnd,bhmd->bhnm", q, k).float() / math.sqrt(d)
        if bias is not None:
            s = s + bias
        a = s.softmax(dim=-1).to(v.dtype)
        with attn_out():
            o = torch.einsum("bhnm,bhmd->bhnd", a, v)
        return self.proj(o.transpose(1, 2).reshape(B, N, C))


class DiT1DBlock(nn.Module):
    """One fused-adaLN DiT block over (B, T*N, D) with per-frame (B, T, D)
    conditioning."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, merge_mode: str,
                 n_tokens_per_frame: int, qk_norm: bool = False):
        super().__init__()
        if merge_mode not in ("share_norm", "reproduce"):
            raise NotImplementedError(f"merge_mode {merge_mode!r}")
        self.merge_mode, self.n = merge_mode, n_tokens_per_frame
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, 6 * dim))
        nn.init.zeros_(self.adaLN_modulation[1].weight)
        nn.init.zeros_(self.adaLN_modulation[1].bias)
        self.attn = DiT1DAttention(dim, num_heads, qk_norm)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, t: torch.Tensor, bias: Optional[torch.Tensor],
                rope: Optional[RopeTables] = None):
        mods = self.adaLN_modulation(t).chunk(6, dim=-1)
        if self.merge_mode == "share_norm":
            n = self.n
        else:  # whole-sample (first-frame) conditioning, standard residuals
            n, mods = x.shape[1], tuple(m[:, :1] for m in mods)
        sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = (m[:, :, None] for m in mods)

        def modulate(h, shift, scale):
            return _per_frame(h, n, lambda y: y * (1 + scale) + shift)

        def gate(h, g):
            return _per_frame(h, n, lambda y: y * g)

        if self.merge_mode == "share_norm":
            x = _ln(x)
            x = x + gate(self.attn(modulate(x, sh_msa, sc_msa), rope, bias), g_msa)
            x = _ln(x)
            return x + gate(self.mlp(modulate(x, sh_mlp, sc_mlp)), g_mlp)
        x = x + gate(self.attn(modulate(_ln(x), sh_msa, sc_msa), rope, bias), g_msa)
        return x + gate(self.mlp(modulate(_ln(x), sh_mlp, sc_mlp)), g_mlp)


class _TEmbedder(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(256, dim), nn.SiLU(), nn.Linear(dim, dim))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.mlp(t.to(self.mlp[0].weight.dtype))


class DiT1D(nn.Module):
    """x (B, T, 1, N, C) or (B, T, N, C); returns fp32 of x's shape."""

    def __init__(self, spec: DiT1DSpec, x_channels: int, n_tokens: int,
                 external_cond_type: Optional[str] = None, external_cond_dim: int = 0,
                 external_cond_num_classes: Optional[int] = None,
                 external_cond_dropout: float = 0.0, use_fourier_noise_emb: bool = False):
        super().__init__()
        s = spec
        if s.learn_sigma:
            # the loss takes C output channels; a 2C mean + sigma head has no
            # consumer (nor does the reference's loss split it)
            raise NotImplementedError("DiT1D learn_sigma=True has no downstream sigma consumer")
        if s.use_gradient_checkpointing:
            saved_ops(s.remat_policy)  # an unknown name raises here
        self.spec, self.x_channels, self.n_tokens = s, x_channels, n_tokens
        self.external_cond_type = external_cond_type
        D = s.hidden_size
        self.x_embedder = nn.Linear(x_channels, D)
        self.t_embedder = _TEmbedder(D)
        if external_cond_type == "label":
            self.external_cond_embedding = LabelEmbedding(external_cond_num_classes, D,
                                                          external_cond_dropout)
        self.pos_table = None
        self._rope: Dict[int, RopeTables] = {}
        if not s.use_rotary_emb:
            self.pos_table = DeviceTable(
                get_nd_sincos_pos_embed(D, (s.max_temporal_length * n_tokens,)))
        self.blocks = nn.ModuleList(
            DiT1DBlock(D, s.num_heads, s.mlp_ratio, s.merge_mode, n_tokens, s.qk_norm)
            for _ in range(s.depth))
        self.final_layer = nn.Sequential(nn.LayerNorm(D, eps=LN_EPS, elementwise_affine=False),
                                         nn.Linear(D, x_channels))
        nn.init.zeros_(self.final_layer[1].weight)
        nn.init.zeros_(self.final_layer[1].bias)
        self._bias: Dict[tuple, torch.Tensor] = {}

    def rope_tables(self, n: int) -> RopeTables:
        """1-D RoPE over the n = T*N flattened tokens."""
        if n not in self._rope:
            self._rope[n] = RopeTables(make_rope_1d(self.spec.hidden_size // self.spec.num_heads, n))
        return self._rope[n]

    def causal_bias(self, T: int, N: int, device) -> Optional[torch.Tensor]:
        """(1, 1, T*N, T*N) fp32: 0 where the key's frame is not after the
        query's, -inf where it is; None without a causal mode."""
        if self.spec.causal_attn_mode not in ("temporal_causal", "video_temporal_causal"):
            return None
        key = (T, N, device)
        if key not in self._bias:
            frame = np.arange(T * N) // N
            bias = np.where(frame[:, None] >= frame[None, :], 0.0, -np.inf).astype(np.float32)
            self._bias[key] = torch.as_tensor(bias[None, None], device=device)
        return self._bias[key]

    def forward(self, x, noise_levels, external_cond=None, external_cond_mask=None
                ) -> torch.Tensor:
        s = self.spec
        shape5 = x.ndim == 5
        if shape5:
            x = x[:, :, 0]
        B, T, N, C = x.shape
        h = self.x_embedder(x.to(self.x_embedder.weight.dtype)).reshape(B, T * N, -1)
        rope = None
        if s.use_rotary_emb:
            rope = self.rope_tables(T * N)
        else:
            h = h + self.pos_table.on(x.device, h.dtype)[: T * N]

        emb = self.t_embedder(timestep_embedding(noise_levels, 256, flip_sin_to_cos=True))
        if external_cond is not None and self.external_cond_type == "label":
            cond = self.external_cond_embedding(external_cond, external_cond_mask)
            if cond.ndim == 2:
                cond = cond[:, None]
            emb = emb + cond.to(emb.dtype)

        bias = self.causal_bias(T, N, x.device)
        for block in self.blocks:
            if s.use_gradient_checkpointing and torch.is_grad_enabled():
                h = remat(s.remat_policy)(block, h, emb, bias, rope)
            else:
                h = block(h, emb, bias, rope)
        out = self.final_layer(h).reshape(B, T, N, C).float()
        return out[:, :, None] if shape5 else out
