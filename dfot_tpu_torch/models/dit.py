"""DiT backbone family in PyTorch: token-wise AdaLN-Zero video transformers.

Port of ``dfot_tpu/models/dit.py``. Every token carries its own conditioning
(the (B, N, C) stream ``c``), so every frame can carry its own noise level:
the Diffusion Forcing mechanism. Variants: ``full`` (all T*P tokens in one
attention), ``factorized_encoder`` (alternating spatial and temporal blocks),
``factorized_attention`` (the same alternation, the spatial blocks with an
MLP of their own ratio), and the matrix-attention variants of
``models/matrix.py``: ``full_matrix_attention`` (every block a matrix block)
and ``factorized_matrix_attention`` (spatial blocks, then matrix blocks over
the whole (T, P) grid).

Layouts follow the JAX package: video (B, T, H, W, C) channel-last in and out,
(B, N, C) tokens inside. Module and parameter names are the upstream torch
names that ``dfot_tpu/utils/torch_ckpt.py:import_dit3d_params`` reads
(``patch_embedder``, ``noise_level_pos_embedding``, ``external_cond_embedding``,
``dit_base.blocks.N.norm1.modulation.1``, ``...attn.qkv``, ``...mlp.fc1``,
``dit_base.final_layer.norm_final`` / ``.linear``), so an upstream checkpoint
loads with ``load_state_dict``.

Kernels: every block's ``modulate(ln(x), shift, scale)`` is kernel B8
(``ops/ln_modulate.py``; B9 on the way back). A block's attention goes by
:func:`dfot_tpu_torch.ops.attention.attention_route`: long rows through the
packed route B2 -> B1 -> B3 (a head dim of 72 zero-padded to 128 inside B2),
rows of up to 32 tokens (the factorized variants' temporal and small spatial
attentions) through kernel B10. Matrix blocks launch no kernel.

Training follows PyTorch's idiom: ``model.train()`` switches on the condition
dropouts (draws from the device's global generator), ``model.eval()`` switches
them off; with ``use_gradient_checkpointing`` the blocks are recomputed in the
backward whenever gradients are enabled.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention, attention_route
from ..ops.ln_modulate import ln_modulate
from ..ops.qkv_prep import attention_from_packed_qkv, swap_pairs
from .embeddings import (
    DeviceTable,
    LabelEmbedding,
    PatchEmbed,
    RandomDropoutCondEmbedding,
    RopeTables,
    StochasticTimeEmbedding,
    get_nd_sincos_pos_embed,
    make_rope_1d,
    make_rope_2d,
    make_rope_3d,
)
from .matrix import MatrixDiTBlock
from .remat import remat, saved_ops

__all__ = [
    "Attention", "Mlp", "AdaModulation", "DiTBlock", "FinalLayer", "DiTSpec", "DiTBase",
    "DiT3D", "DiT3DPose", "norm_modulate",
]

LN_EPS = 1e-6


def norm_modulate(x, shift, scale, plain: bool = False) -> torch.Tensor:
    """``modulate(LayerNorm(x), shift, scale)``, LayerNorm without scale and
    bias. Token-wise conditioning (shift of x's shape) takes the fused kernel
    route; conditioning that broadcasts takes the LayerNorm + modulate chain."""
    if x.dtype != shift.dtype:
        x = x.to(shift.dtype)
    if shift.shape == x.shape:
        return ln_modulate(x, shift, scale, LN_EPS, plain=plain)
    return F.layer_norm(x, x.shape[-1:], eps=LN_EPS) * (1 + scale) + shift


class Attention(nn.Module):
    """Multi-head self-attention with optional RoPE (packed qkv matmul)."""

    def __init__(self, dim: int, num_heads: int, rope: Optional[RopeTables] = None,
                 causal: bool = False):
        super().__init__()
        self.num_heads, self.rope, self.causal = num_heads, rope, causal
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        # True: run the plain versions of the attention kernels
        self.plain = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H, D = self.num_heads, C // self.num_heads
        qkv = self.qkv(x)
        tabs = None if self.rope is None else self.rope.cast(x.device, qkv.dtype)
        # the output of either route is what the JAX model tags attn_out: the
        # route's last op (B3's or B10's) is what the attn remat policies keep
        if attention_route(N, D, self.causal) in ("flash", "padded_flash"):
            # one pass each for split + RoPE + pad and for slice + merge
            out = attention_from_packed_qkv(
                qkv, H, D, None if tabs is None else (tabs, tabs),
                causal=self.causal, plain=self.plain,
            )
            return self.proj(out)
        q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)  # each (B, H, N, D)
        if tabs is not None:
            cos, sin = tabs[0][:N], tabs[1][:N]
            q = q * cos + swap_pairs(q) * sin
            k = k * cos + swap_pairs(k) * sin
        out = attention(q, k, v, causal=self.causal, plain=self.plain)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class AdaModulation(nn.Module):
    """SiLU + linear (``modulation.1``, zero-initialized upstream) producing
    ``n_chunks`` modulation tensors from the conditioning stream."""

    def __init__(self, dim: int, n_chunks: int):
        super().__init__()
        self.n_chunks = n_chunks
        self.modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, n_chunks * dim))
        nn.init.zeros_(self.modulation[1].weight)
        nn.init.zeros_(self.modulation[1].bias)

    def forward(self, c: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.modulation(c).chunk(self.n_chunks, dim=-1)


class DiTBlock(nn.Module):
    """AdaLN-Zero transformer block with token-wise conditioning.

    The block REPLACES the residual stream by the normed, modulated tensor:
    ``h = modulate(ln(x)); x = h + gate * attn(h)``: the skip adds to h, not
    to the block's input (upstream checkpoints are trained so)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: Optional[float] = 4.0,
                 rope: Optional[RopeTables] = None, causal: bool = False):
        super().__init__()
        self.norm1 = AdaModulation(dim, 3)
        self.attn = Attention(dim, num_heads, rope, causal)
        self.has_mlp = mlp_ratio is not None and mlp_ratio > 0
        if self.has_mlp:
            self.norm2 = AdaModulation(dim, 3)
            self.mlp = Mlp(dim, int(dim * mlp_ratio))
        # True: run the plain version of the LayerNorm + modulate kernel
        self.plain = False

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale, gate = self.norm1(c)
        h = norm_modulate(x, shift, scale, self.plain)
        x = h + gate * self.attn(h)
        if self.has_mlp:
            shift, scale, gate = self.norm2(c)
            h = norm_modulate(x, shift, scale, self.plain)
            x = h + gate * self.mlp(h)
        return x


class FinalLayer(nn.Module):
    """AdaLN (``norm_final``) + projection (``linear``, zero-initialized
    upstream)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm_final = AdaModulation(dim, 2)
        self.linear = nn.Linear(dim, out_dim)
        nn.init.zeros_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)
        self.plain = False

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.norm_final(c)
        return self.linear(norm_modulate(x, shift, scale, self.plain))


@dataclasses.dataclass(frozen=True)
class DiTSpec:
    """Static architecture spec shared by the DiT variants."""

    hidden_size: int = 384
    depth: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    spatial_mlp_ratio: Optional[float] = None
    variant: str = "full"  # full | factorized_encoder | factorized_attention
    #        | full_matrix_attention | factorized_matrix_attention
    pos_emb_type: str = "rope_3d"
    patch_size: int = 2
    max_temporal_length: int = 16
    use_gradient_checkpointing: bool = False
    remat_policy: Optional[str] = None
    causal: bool = False
    # matrix-attention variants
    embed_col_dim: Optional[int] = None
    embed_row_dim: Optional[int] = None
    num_col_heads: Optional[int] = None
    num_row_heads: Optional[int] = None
    matrix_multi_token: bool = False
    flatten_matrix_rope: bool = False
    matrix_use_bias: bool = False
    fixed_u: Optional[str] = None
    use_temporal_rope: bool = False
    # difference-DiT double RoPE: concat | interleaved | None
    double_rope_merge: Optional[str] = None

    @classmethod
    def from_config(cls, bcfg, max_tokens: int, causal: bool) -> "DiTSpec":
        """From the ``algorithm.backbone`` config node, field for field as
        ``dfot_tpu/algorithms/dfot_video.py:_build_backbone`` reads it."""
        return cls(
            # matrix variants may leave hidden_size null; the effective width
            # is embed_row_dim
            hidden_size=bcfg.get("hidden_size") or bcfg.get("embed_row_dim"),
            depth=bcfg.depth,
            num_heads=bcfg.get("num_heads"),
            mlp_ratio=bcfg.mlp_ratio,
            spatial_mlp_ratio=bcfg.get("spatial_mlp_ratio"),
            variant=bcfg.variant,
            pos_emb_type=bcfg.pos_emb_type,
            patch_size=bcfg.patch_size,
            max_temporal_length=max_tokens,
            use_gradient_checkpointing=bcfg.get("use_gradient_checkpointing", False),
            remat_policy=bcfg.get("remat_policy"),
            causal=causal,
            embed_col_dim=bcfg.get("embed_col_dim"),
            embed_row_dim=bcfg.get("embed_row_dim"),
            num_col_heads=bcfg.get("num_col_heads"),
            num_row_heads=bcfg.get("num_row_heads"),
            matrix_multi_token=bcfg.get("matrix_multi_token") or False,
            flatten_matrix_rope=bcfg.get("flatten_matrix_rope") or False,
            matrix_use_bias=bcfg.get("use_bias") or False,
            fixed_u=bcfg.get("fixed_u"),
            use_temporal_rope=bcfg.get("use_temporal_rope", False),
            double_rope_merge=(
                bcfg.get("merge_type", "concat") if bcfg.name == "difference_dit3d" else None
            ),
        )


class _LearnedPosEmb(nn.Module):
    def __init__(self, max_tokens: int, dim: int):
        super().__init__()
        self.pos_emb = nn.Parameter(torch.randn(1, max_tokens, dim) * 0.02)


class DiTBase(nn.Module):
    """Shared transformer trunk over (B, N, C) tokens with (B, N, C)
    conditioning. ``num_patches``: tokens per frame."""

    def __init__(self, spec: DiTSpec, num_patches: int, spatial_grid: Tuple[int, int],
                 out_channels: int):
        super().__init__()
        s = spec
        if s.variant not in ("full", "factorized_encoder", "factorized_attention",
                             "full_matrix_attention", "factorized_matrix_attention"):
            raise ValueError(f"unknown DiT variant {s.variant!r}")
        if s.use_gradient_checkpointing:
            saved_ops(s.remat_policy)  # an unknown name raises here
        self.spec, self.num_patches = s, num_patches
        dim, head_dim = s.hidden_size, s.hidden_size // s.num_heads
        grid = tuple(spatial_grid)

        rope = None
        self.pos_emb = None
        self.pos_table = None           # (N, C), added once over (t p)
        self.spatial_pos_table = None   # (P, C), added per frame
        self.temporal_pos_table = None  # (T, C), added before the first temporal block
        if s.pos_emb_type == "rope_3d":
            if s.variant != "full":
                raise ValueError("rope_3d requires the full variant")
            rope = RopeTables(make_rope_3d(head_dim, (s.max_temporal_length,) + grid,
                                           double_merge=s.double_rope_merge))
        elif s.pos_emb_type == "rope_2d":
            rope = RopeTables(make_rope_2d(head_dim, grid))
        elif s.pos_emb_type == "learned_1d":
            self.pos_emb = _LearnedPosEmb(s.max_temporal_length * num_patches, dim)
        elif s.pos_emb_type == "sinusoidal_1d":
            self.pos_table = DeviceTable(
                get_nd_sincos_pos_embed(dim, (s.max_temporal_length * num_patches,)))
        elif s.pos_emb_type == "sinusoidal_3d":
            self.pos_table = DeviceTable(
                get_nd_sincos_pos_embed(dim, (s.max_temporal_length,) + grid))
        elif s.pos_emb_type == "sinusoidal_2d":
            self.spatial_pos_table = DeviceTable(get_nd_sincos_pos_embed(dim, grid))
        elif s.pos_emb_type == "sinusoidal_factorized":
            self.spatial_pos_table = DeviceTable(get_nd_sincos_pos_embed(dim, grid))
            self.temporal_pos_table = DeviceTable(
                get_nd_sincos_pos_embed(dim, (s.max_temporal_length,)))
        else:
            raise ValueError(f"unsupported pos_emb_type {s.pos_emb_type}")

        # the blocks of every variant, "full" included, get spatial_mlp_ratio
        # (None unless configured: NO MLP); only the temporal blocks of the
        # factorized variants get mlp_ratio. Upstream checkpoints are so.
        # Matrix blocks get mlp_ratio.
        if s.variant == "full_matrix_attention":
            self.blocks = nn.ModuleList(self._matrix_block() for _ in range(s.depth))
        else:
            self.blocks = nn.ModuleList(
                DiTBlock(dim, s.num_heads, s.spatial_mlp_ratio, rope,
                         s.causal and s.variant == "full")
                for _ in range(s.depth)
            )
        if s.variant == "factorized_matrix_attention":
            self.temporal_blocks = nn.ModuleList(self._matrix_block() for _ in range(s.depth))
        elif self.is_factorized:
            self.temporal_blocks = nn.ModuleList(
                DiTBlock(dim, s.num_heads, s.mlp_ratio, None, s.causal) for _ in range(s.depth)
            )
        self.final_layer = FinalLayer(dim, out_channels)

    def _matrix_block(self) -> MatrixDiTBlock:
        s = self.spec
        rope = None
        if s.use_temporal_rope:
            n, d = s.embed_col_dim // s.num_col_heads, s.embed_row_dim // s.num_row_heads
            rope = RopeTables(make_rope_1d(n * d if s.flatten_matrix_rope else d,
                                           s.max_temporal_length))
        return MatrixDiTBlock(
            self.num_patches, s.hidden_size, s.embed_col_dim, s.embed_row_dim, s.num_col_heads,
            s.num_row_heads, s.mlp_ratio, rope, s.flatten_matrix_rope, s.matrix_multi_token,
            s.matrix_use_bias, s.fixed_u,
        )

    @property
    def is_factorized(self) -> bool:
        return self.spec.variant in ("factorized_encoder", "factorized_attention",
                                     "factorized_matrix_attention")

    def _run(self, block, x, c):
        if self.spec.use_gradient_checkpointing and torch.is_grad_enabled():
            return remat(self.spec.remat_policy)(block, x, c)
        return block(x, c)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """x, c: (B, N, C) with N = T * num_patches, flattened row-major.

        Joint image-video training: tokens beyond max_temporal_length * P are
        single-frame images, run through the same blocks as (B * T_img, P)
        length-1 sequences and concatenated back."""
        s, P = self.spec, self.num_patches
        max_tokens = s.max_temporal_length * P
        if x.shape[1] > max_tokens:
            B0, t_img = x.shape[0], (x.shape[1] - max_tokens) // P
            out_vid = self(x[:, :max_tokens], c[:, :max_tokens])
            out_img = self(
                x[:, max_tokens:].reshape(B0 * t_img, P, x.shape[-1]),
                c[:, max_tokens:].reshape(B0 * t_img, P, c.shape[-1]),
            )
            return torch.cat([out_vid, out_img.reshape(B0, t_img * P, -1)], dim=1)

        B, N, C = x.shape
        T = N // P
        dev, dt = x.device, x.dtype
        if self.pos_emb is not None:
            x = x + self.pos_emb.pos_emb[:, :N].to(dt)
        elif self.pos_table is not None:
            x = x + self.pos_table.on(dev, dt)[:N]
        if self.spatial_pos_table is not None:
            x = (x.reshape(B, T, P, C) + self.spatial_pos_table.on(dev, dt)).reshape(B, N, C)
        if self.temporal_pos_table is not None and not self.is_factorized:
            # full variant with a factorized table: the temporal half at once
            tp = self.temporal_pos_table.on(dev, dt)[:T]
            x = (x.reshape(B, T, P, C) + tp[:, None]).reshape(B, N, C)

        if not self.is_factorized:
            for block in self.blocks:
                x = self._run(block, x, c)
            return self.final_layer(x, c)

        # spatial blocks over (B*T, P); temporal blocks over (B*P, T), or,
        # matrix blocks, over the whole (B, T*P) grid
        matrix_temporal = s.variant == "factorized_matrix_attention"
        cs = c.reshape(B * T, P, C)
        if not matrix_temporal:
            ct = c.reshape(B, T, P, C).transpose(1, 2).reshape(B * P, T, C)
        for i, block in enumerate(self.blocks):
            xs = self._run(block, x.reshape(B * T, P, C), cs)
            if i == 0 and self.temporal_pos_table is not None:
                # the temporal table is added once, after the first spatial block
                tp = self.temporal_pos_table.on(dev, xs.dtype)[:T]
                xs = (xs.reshape(B, T, P, C) + tp[:, None]).reshape(B * T, P, C)
            if matrix_temporal:
                x = self._run(self.temporal_blocks[i], xs.reshape(B, N, C), c)
                continue
            xt = xs.reshape(B, T, P, C).transpose(1, 2).reshape(B * P, T, C)
            xt = self._run(self.temporal_blocks[i], xt, ct)
            x = xt.reshape(B, P, T, C).transpose(1, 2).reshape(B, N, C)
        return self.final_layer(x, c)


class DiT3D(nn.Module):
    """Video DiT: patchify -> DiTBase -> unpatchify with per-frame AdaLN
    conditioning. x (B, T, H, W, C_in) channel-last; noise_levels (B, T)
    (integer levels or scaled logSNR). Returns fp32 in x's layout."""

    def __init__(self, spec: DiTSpec, x_channels: int, resolution: Tuple[int, int],
                 external_cond_type: Optional[str] = None, external_cond_dim: int = 0,
                 external_cond_num_classes: Optional[int] = None,
                 external_cond_dropout: float = 0.0, use_fourier_noise_emb: bool = False):
        super().__init__()
        s = spec
        self.spec, self.x_channels, self.resolution = s, x_channels, tuple(resolution)
        self.external_cond_type = external_cond_type
        p, dim = s.patch_size, s.hidden_size
        self.patch_embedder = PatchEmbed(p, x_channels, dim)
        self.noise_level_pos_embedding = StochasticTimeEmbedding(256, dim, use_fourier_noise_emb)
        if external_cond_type == "label":
            self.external_cond_embedding = LabelEmbedding(
                external_cond_num_classes, dim, external_cond_dropout)
        elif external_cond_type == "action":
            self.external_cond_embedding = RandomDropoutCondEmbedding(
                external_cond_dim, dim, external_cond_dropout)
        elif external_cond_type is not None:
            raise ValueError(f"unknown external_cond_type {external_cond_type}")
        gh, gw = self.grid
        self.dit_base = DiTBase(s, gh * gw, (gh, gw), p * p * x_channels)

    @property
    def grid(self) -> Tuple[int, int]:
        p = self.spec.patch_size
        return (self.resolution[0] // p, self.resolution[1] // p)

    def use_plain_kernels(self, plain: bool = True) -> None:
        """Route every block through the plain versions of its kernels (True)
        or through the kernels (False)."""
        for m in self.modules():
            if isinstance(m, (Attention, DiTBlock, FinalLayer)):
                m.plain = plain

    def forward(self, x, noise_levels, external_cond=None, external_cond_mask=None,
                extra_emb=None) -> torch.Tensor:
        B, T, H, W, Cin = x.shape
        p, dim = self.spec.patch_size, self.spec.hidden_size
        gh, gw = self.grid
        P = gh * gw
        tokens = self.patch_embedder(x).reshape(B, T * P, dim)

        emb = self.noise_level_pos_embedding(noise_levels)  # (B, T, C)
        if extra_emb is not None:
            emb = emb + extra_emb.to(emb.dtype)
        if external_cond is not None and self.external_cond_type is not None:
            cond = self.external_cond_embedding(external_cond, external_cond_mask)
            if cond.ndim == 2:  # one label per video: broadcast over frames
                cond = cond[:, None]
            emb = emb + cond.to(emb.dtype)
        # every patch of a frame carries the frame's conditioning
        c = emb.repeat_interleave(P, dim=1)  # (B, T*P, C)

        out = self.dit_base(tokens, c)
        out = out.reshape(B, T, gh, gw, p, p, Cin).transpose(3, 4)
        return out.reshape(B, T, H, W, Cin).float()


class DiT3DPose(nn.Module):
    """Camera-pose conditioned DiT3D. The (B, T, H, W, C') pose map is either
    concatenated to x before the patch embedding (``concat``; the output keeps
    x's channels) or patch-embedded (``pose_embed``), averaged per frame, dropped
    for a whole sample with probability ``external_cond_dropout`` in training
    mode (or where the mask says), and added to the conditioning (``film``).
    The denoiser is ``trunk``; both names are the JAX package's."""

    def __init__(self, spec: DiTSpec, x_channels: int, resolution: Tuple[int, int],
                 external_cond_dim: int, conditioning_type: str = "film",
                 external_cond_dropout: float = 0.1, use_fourier_noise_emb: bool = False):
        super().__init__()
        if conditioning_type not in ("concat", "film"):
            raise ValueError(f"unknown conditioning_type {conditioning_type}")
        self.spec, self.x_channels = spec, x_channels
        self.conditioning_type = conditioning_type
        self.external_cond_dropout = external_cond_dropout
        film = conditioning_type == "film"
        if film:
            self.pose_embed = PatchEmbed(spec.patch_size, external_cond_dim, spec.hidden_size)
        self.trunk = DiT3D(spec, x_channels + (0 if film else external_cond_dim), resolution,
                           use_fourier_noise_emb=use_fourier_noise_emb)

    def use_plain_kernels(self, plain: bool = True) -> None:
        self.trunk.use_plain_kernels(plain)

    def forward(self, x, noise_levels, external_cond=None, external_cond_mask=None):
        if external_cond is None:
            raise ValueError("DiT3DPose requires camera-pose conditioning")
        if self.conditioning_type == "concat":
            x_in = torch.cat([x, external_cond.to(x.dtype)], dim=-1)
            return self.trunk(x_in, noise_levels)[..., : self.x_channels]
        pose_emb = self.pose_embed(external_cond).mean(dim=2)  # (B, T, C)
        if self.external_cond_dropout > 0 and self.training:
            drop = torch.rand(x.shape[0], device=x.device) < self.external_cond_dropout
            pose_emb = torch.where(drop[:, None, None], 0.0, pose_emb)
        elif external_cond_mask is not None:
            m = external_cond_mask.reshape(
                external_cond_mask.shape + (1,) * (pose_emb.ndim - external_cond_mask.ndim))
            pose_emb = torch.where(m, 0.0, pose_emb)
        return self.trunk(x, noise_levels, extra_emb=pose_emb)[..., : self.x_channels]
