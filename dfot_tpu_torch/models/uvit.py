"""U-ViT3D(+Pose) video denoiser in PyTorch: the DFoT_RE10K flagship.

Port of ``dfot_tpu/models/uvit.py``: conv ResBlocks at high resolution,
full 3D-RoPE transformer blocks at low resolution, one subtract/add residual
skip per down/upsample, FiLM conditioning on a noise-level (+ camera-pose)
embedding.

Layouts follow the JAX package at the public surface: video (B, T, H, W, C),
or with ``token_io`` patch tokens (B, T, h*w, p*p*C) in (p_h, p_w, C) order.
Inside, conv levels carry (B*T, h, w, C) channel-last activations (convs see
a channels-last NCHW view); transformer levels carry (B, T*h*w, C) tokens.
Module and parameter names are the upstream torch names that
``dfot_tpu/utils/torch_ckpt.py:import_uvit3d_params`` reads, so an upstream
checkpoint loads with ``load_state_dict``. Every transformer block's
attention runs through kernels B2 -> B1 -> B3 (``ops/qkv_prep.py``) and, in
the backward, B7 -> B4, B5 -> B6. An ``AxialTransformerBlock`` level attends
over each frame's tokens that way and then over the frames of each position
(:class:`AxialAttention`): rows of 8 tokens, kernel B10.

Training follows PyTorch's idiom: ``model.train()`` switches on the block
dropouts and the whole-sample pose dropout (draws come from the device's
global generator, which the train step seeds, made for the global batch by
``models/dropout.py``), ``model.eval()`` switches
them off. Levels with ``use_checkpointing`` recompute their transformer
blocks in the backward whenever gradients are enabled.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention, attention_route
from ..ops.qkv_prep import attention_from_packed_qkv, fold_qk_tables, swap_pairs
from ..parallel.tensor import all_gather_last
from .dropout import Dropout, uniform
from .remat import not_a_residual, remat, saved_ops
from .embeddings import (
    PatchEmbed,
    RandomDropoutCondEmbedding,
    RoPE,
    RopeTables,
    StochasticTimeEmbedding,
    conv_as_patch_matrix,
    make_rope_1d,
    make_rope_2d,
    make_rope_3d,
    patchify,
)

__all__ = [
    "UViTSpec", "UViT3D", "UViT3DPose", "precompute_pose_conditioning",
    "patchify_tokens", "unpatchify_tokens",
]


def patchify_tokens(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, T, H, W, C) pixels -> (B, T, h*w, p*p*C) patch tokens: the
    sampler's token-layout state."""
    return patchify(x, p)


def unpatchify_tokens(x: torch.Tensor, p: int, H: int, W: int) -> torch.Tensor:
    """Inverse of :func:`patchify_tokens`."""
    B, T, N, D = x.shape
    C = D // (p * p)
    x = x.reshape(B, T, H // p, W // p, p, p, C).transpose(3, 4)
    return x.reshape(B, T, H, W, C)


def _nchw(fn, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW module to a (N, h, w, C) channel-last tensor."""
    return fn(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class RMSNorm(nn.Module):
    """RMSNorm with fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        normed = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return normed.to(x.dtype) * self.weight.to(x.dtype)


class FiLMNorm(nn.Module):
    """RMSNorm + FiLM from an embedding (upstream NormalizeWithCond).

    ``emb`` is per token (B, N, E) or per frame (B, F, E), N = F * tokens per
    frame: the modulation is then projected at frame rate and broadcast.
    ``pose_mod`` (B, N, 2C) is a precomputed spatial FiLM term (see
    :func:`precompute_pose_conditioning`), scaled by ``pose_scale``."""

    def __init__(self, dim: int, emb_dim: int):
        super().__init__()
        self.emb_layer = nn.Linear(emb_dim, 2 * dim)
        self.norm = RMSNorm(dim)

    def forward(self, x, emb, pose_mod=None, pose_scale=None):
        B, N, C = x.shape
        mod = self.emb_layer(emb)
        frames = mod.shape[1]
        per_frame = frames != N
        if per_frame:
            mod = mod[:, :, None, :]  # (B, F, 1, 2C)
        if pose_mod is not None:
            pm = pose_mod if pose_scale is None else pose_mod * pose_scale
            mod = mod + (pm.reshape(B, frames, N // frames, 2 * C) if per_frame else pm)
        scale, shift = mod.chunk(2, dim=-1)
        h = self.norm(x)
        if per_frame:
            h = h.reshape(B, frames, N // frames, C)
        return (h * (1 + scale) + shift).reshape(B, N, C)


class ResBlock(nn.Module):
    """GroupNorm conv ResBlock with FiLM emb injection. x: (BT, h, w, C)
    channel-last; emb: (BT, he, we, E) with (he, we) = (1, 1) or (h, w)."""

    def __init__(self, channels: int, emb_dim: int):
        super().__init__()
        C = channels
        self.in_layers = nn.Sequential(
            nn.GroupNorm(32, C, eps=1e-6), nn.SiLU(), nn.Conv2d(C, C, 3, padding=1)
        )
        self.emb_layer = nn.Conv2d(emb_dim, 2 * C, 1)
        self.out_norm = nn.GroupNorm(32, C, eps=1e-6)
        self.out_rest = nn.Sequential(nn.SiLU(), nn.Conv2d(C, C, 3, padding=1))

    def forward(self, x, emb, pose_mod=None, pose_scale=None):
        h = _nchw(self.in_layers, x)
        mod = F.linear(emb, self.emb_layer.weight[:, :, 0, 0], self.emb_layer.bias)
        if pose_mod is not None:
            mod = mod + (pose_mod if pose_scale is None else pose_mod * pose_scale)
        scale, shift = mod.chunk(2, dim=-1)
        h = _nchw(self.out_norm, h) * (1 + scale) + shift
        return x + _nchw(self.out_rest, h)


class _QKNormAttention:
    """Attention on a packed qkv projection with per-head RMSNorm of q and k
    (``q_norm``, ``k_norm``) and RoPE, for the modules that own those norms."""

    def _init_attention(self, heads: int) -> None:
        self.heads = heads
        self._folded_key = None
        self._folded = None
        # True: run the plain versions of the attention kernels (a reference
        # for the kernel route, e.g. on the card)
        self.plain_attention = False

    def _tables(self, device, dtype, rope: Optional[RopeTables] = None):
        """The RoPE tables (``rope``, by default the module's own) with the
        q/k norm scales folded in.

        Where a gradient can reach a scale (gradients enabled and the scale
        requires one) the fold is plain differentiable fp32 ops, made anew on
        every call: the table cotangents of the qkv_prep backward then reach
        ``q_norm.weight`` and ``k_norm.weight``. Otherwise the tables are
        folded once in ``dtype``, and again only when a scale changes (a
        load, a cast or a move gives it new data or a new version); under
        tracing (``torch.export``) on every call."""
        rope = self.rope if rope is None else rope
        qw, kw = self.q_norm.weight, self.k_norm.weight
        if torch.is_grad_enabled() and (qw.requires_grad or kw.requires_grad):
            return fold_qk_tables(*rope.on(device), qw, kw, torch.float32)
        if torch.compiler.is_compiling():  # traced (torch.export): no storage to key on
            return fold_qk_tables(*rope.on(device), qw, kw, dtype)
        key = (device, dtype, qw.data_ptr(), qw._version, kw.data_ptr(), kw._version)
        if key != self._folded_key:
            with torch.no_grad():
                self._folded = fold_qk_tables(*rope.on(device), qw, kw, dtype)
            self._folded_key = key
        return self._folded

    def _attend(self, qkv: torch.Tensor, rope: RopeTables) -> torch.Tensor:
        """(B, N, 3C) packed qkv -> (B, N, C) attention output. Long rows take
        the packed kernel route (norm, RoPE and the learned scales inside
        B2); short rows (an axial block's 8 frames) the chain norm -> RoPE ->
        dispatcher, whose kernel is B10."""
        B, N, C3 = qkv.shape
        H, D = self.heads, C3 // (3 * self.heads)
        # the output of either route is what the JAX model tags attn_out: the
        # route's last op (B3's or B10's) is what the attn remat policies keep
        if attention_route(N, D) in ("flash", "padded_flash"):
            return attention_from_packed_qkv(
                qkv, H, D, self._tables(qkv.device, qkv.dtype, rope),
                norm=True, eps=self.q_norm.eps, plain=self.plain_attention,
            )
        q, k, v = qkv.reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)  # each (B, H, N, D)
        q, k = self.q_norm(q), self.k_norm(k)
        cos, sin = (t[:N] for t in rope.cast(qkv.device, qkv.dtype))
        q = q * cos + swap_pairs(q) * sin
        k = k * cos + swap_pairs(k) * sin
        o = attention(q, k, v, plain=self.plain_attention)
        return o.transpose(1, 2).reshape(B, N, C3 // 3)


class AxialAttention(nn.Module, _QKNormAttention):
    """The second (temporal) attention of an axial transformer block
    (upstream ``AttentionBlock``, held as ``another_attn``): FiLM norm,
    bias-free projections, and the zero-initialized ``out`` projection added
    to the attention output itself; the block outside holds the residual."""

    def __init__(self, dim: int, heads: int, emb_dim: int, rope: RopeTables):
        super().__init__()
        self._init_attention(heads)
        d = dim // heads
        self.norm = FiLMNorm(dim, emb_dim)
        self.proj = nn.Linear(dim, 3 * dim, bias=False)
        self.q_norm = RMSNorm(d)
        self.k_norm = RMSNorm(d)
        self.out = nn.Linear(dim, dim, bias=False)
        self.rope = rope

    tp_group = None  # the tensor group, whose ranks hold a share of the heads

    def forward(self, x, emb):
        o = self._attend(self.proj(self.norm(x, emb)), self.rope)
        with not_a_residual():
            return all_gather_last(o, self.tp_group) + self.out(o)


class TransformerBlock(nn.Module, _QKNormAttention):
    """Parallel attention + MLP block with QK RMSNorm and RoPE (ViT-22B
    style; upstream TransformerBlock). ``rope`` is the 3D table of a full
    block. An axial block (``rope_ax1``, ``rope_ax2`` and ``ax1_len`` given)
    attends over the ``ax2`` tokens of each of the ``ax1_len`` frames here,
    with the 2D table, and over the frames of each position in
    ``another_attn``, with the 1D one."""

    def __init__(self, dim: int, heads: int, emb_dim: int, rope: Optional[RopeTables],
                 dropout: float = 0.0, rope_ax1: Optional[RopeTables] = None,
                 rope_ax2: Optional[RopeTables] = None, ax1_len: Optional[int] = None):
        super().__init__()
        self._init_attention(heads)
        d = dim // heads
        self.use_axial = rope_ax1 is not None
        self.ax1_len = ax1_len
        self.norm = FiLMNorm(dim, emb_dim)
        self.fused_attn_mlp_proj = nn.Linear(dim, 3 * dim + 4 * dim)
        self.q_norm = RMSNorm(d)
        self.k_norm = RMSNorm(d)
        self.attn_out = nn.Linear(dim, dim)
        if self.use_axial:
            self.another_attn = AxialAttention(dim, heads, emb_dim, rope_ax1)
        self.mlp_out = nn.Sequential(nn.SiLU(), Dropout(dropout), nn.Linear(4 * dim, dim))
        self.rope = rope_ax2 if self.use_axial else rope

    def forward(self, x, emb, pose_mod=None, pose_scale=None):
        if self.use_axial:
            if pose_mod is not None:
                raise ValueError("precomputed pose FiLM terms are not for axial blocks")
            B0, N0, C = x.shape
            ax1, E = self.ax1_len, emb.shape[-1]
            ax2 = N0 // ax1
            x = x.reshape(B0 * ax1, ax2, C)
            emb = emb.reshape(B0 * ax1, ax2, E)
        C = x.shape[-1]
        h = self.norm(x, emb, pose_mod, pose_scale)
        fused = self.fused_attn_mlp_proj(h)
        # the qkv part is 3 of every 7 columns, on a tensor-parallel rank too
        # (3C/t then 4C/t: parallel/tensor.py)
        split = fused.shape[-1] * 3 // 7
        if torch.is_grad_enabled() and fused.requires_grad:
            qkv, mlp_h = _SplitFused.apply(fused, split)
        else:
            qkv, mlp_h = fused[..., :split], fused[..., split:]
        o = self._attend(qkv, self.rope)
        with not_a_residual():
            x = x + self.attn_out(o)
        if self.use_axial:
            # (B*ax1, ax2, C) -> (B*ax2, ax1, C): attend over the frames
            x = x.reshape(B0, ax1, ax2, C).transpose(1, 2).reshape(B0 * ax2, ax1, C)
            e = emb.reshape(B0, ax1, ax2, E).transpose(1, 2).reshape(B0 * ax2, ax1, E)
            x = self.another_attn(x, e)
            x = x.reshape(B0, ax2, ax1, C).transpose(1, 2).reshape(B0 * ax1, ax2, C)
        with not_a_residual():
            x = x + self.mlp_out(mlp_h)
        return x.reshape(B0, N0, C) if self.use_axial else x


class _SplitFused(torch.autograd.Function):
    """The fused projection's (..., 7C) output as its qkv and MLP slices
    (views, no copy). The backward joins the two gradients with one ``cat``
    (one read and one write of the 7C-wide gradient) where autograd's own
    slice backward would zero-fill two 7C-wide buffers, copy a slice into
    each and add them."""

    @staticmethod
    def forward(ctx, fused, split):
        ctx.split = split
        return fused[..., :split], fused[..., split:]

    @staticmethod
    def backward(ctx, d_qkv, d_mlp):
        return torch.cat([d_qkv, d_mlp], dim=-1), None


class Downsample(nn.Module):
    """2x avg-pool then 3x3 conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        return _nchw(lambda t: self.conv(F.avg_pool2d(t, 2)), x)


class Upsample(nn.Module):
    """3x3 conv then 2x nearest upsample."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        return _nchw(lambda t: F.interpolate(self.conv(t), scale_factor=2, mode="nearest"), x)


class PatchUnembed(nn.Module):
    """Stride-p ConvTranspose2d (``proj``, upstream shape (C, C_out, p, p))
    applied as one matmul to (..., C) rows -> (..., p*p*C_out)."""

    def __init__(self, patch_size: int, in_channels: int, out_channels: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.ConvTranspose2d(in_channels, out_channels, patch_size, stride=patch_size)

    def forward(self, x):
        w = self.proj.weight
        C_in, C_out, p, _ = w.shape
        kernel = w.permute(0, 2, 3, 1).reshape(C_in, p * p * C_out)
        return F.linear(x, kernel.t(), self.proj.bias.repeat(p * p))


@dataclasses.dataclass(frozen=True)
class UViTSpec:
    channels: Tuple[int, ...] = (128, 256, 512, 1024)
    emb_channels: int = 1024
    patch_size: int = 2
    block_types: Tuple[str, ...] = (
        "ResBlock", "ResBlock", "TransformerBlock", "TransformerBlock",
    )
    block_dropouts: Tuple[float, ...] = (0.0, 0.0, 0.1, 0.1)
    num_updown_blocks: Tuple[int, ...] = (3, 3, 3)
    num_mid_blocks: int = 16
    num_heads: int = 4
    pos_emb_type: str = "rope"
    use_checkpointing: Tuple[bool, ...] = (False, False, False, False)
    max_temporal_length: int = 8
    remat_policy: Optional[str] = None

    @classmethod
    def from_config(cls, cfg, max_tokens: int) -> "UViTSpec":
        """From the ``algorithm.backbone`` config node (the JAX package's
        ``UViTSpec.from_config``)."""
        return cls(
            channels=tuple(cfg.channels),
            emb_channels=cfg.emb_channels,
            patch_size=cfg.patch_size,
            block_types=tuple(cfg.block_types),
            block_dropouts=tuple(cfg.block_dropouts),
            num_updown_blocks=tuple(cfg.num_updown_blocks),
            num_mid_blocks=cfg.num_mid_blocks,
            num_heads=cfg.num_heads,
            pos_emb_type=cfg.pos_emb_type,
            use_checkpointing=tuple(cfg.use_checkpointing),
            max_temporal_length=max_tokens,
            remat_policy=cfg.get("remat_policy"),
        )


class UViT3D(nn.Module):
    """Residual U-ViT video denoiser; x (B, T, H, W, C) or, with
    ``token_io``, (B, T, h*w, p*p*C). Returns fp32 in the input layout.

    With ``external_cond_dim`` > 0 a vector condition (B, T, dim), actions or
    labels as the dataset gives them, is embedded by a SiLU MLP
    (``external_cond_embedding``, dropped for a whole sample with
    probability ``external_cond_dropout`` in training mode, and wherever the
    mask says) and added to the noise-level embedding. A ``pos_emb_type``
    other than ``rope`` means no RoPE on any level."""

    def __init__(self, spec: UViTSpec, x_channels: int, resolution: int,
                 use_fourier_noise_emb: bool = False, token_io: bool = False,
                 external_cond_dim: int = 0, external_cond_dropout: float = 0.0):
        super().__init__()
        s = spec
        bad = set(s.block_types) - {"ResBlock", "TransformerBlock", "AxialTransformerBlock"}
        if bad:
            raise ValueError(f"unknown block types {sorted(bad)}")
        if any(s.use_checkpointing):
            saved_ops(s.remat_policy)  # an unknown name raises here
        self.spec, self.x_channels, self.resolution = s, x_channels, resolution
        self.token_io = token_io
        self._ropes: Dict[int, dict] = {}  # per level, shared by its blocks
        L, E, p = len(s.channels), s.emb_channels, s.patch_size
        self.embed_input = PatchEmbed(p, x_channels, s.channels[0])
        self.noise_level_pos_embedding = StochasticTimeEmbedding(256, E, use_fourier_noise_emb)
        self.down_blocks = nn.ModuleList(
            nn.ModuleList(
                [self._make_block(i) for _ in range(s.num_updown_blocks[i])]
                + [Downsample(s.channels[i], s.channels[i + 1])]
            )
            for i in range(L - 1)
        )
        self.mid_blocks = nn.ModuleList(self._make_block(L - 1) for _ in range(s.num_mid_blocks))
        # up_blocks[_i] serves level L - 2 - _i: [Upsample, blocks...]
        self.up_blocks = nn.ModuleList(
            nn.ModuleList(
                [Upsample(s.channels[i + 1], s.channels[i])]
                + [self._make_block(i) for _ in range(s.num_updown_blocks[i])]
            )
            for i in reversed(range(L - 1))
        )
        self.project_output = PatchUnembed(p, s.channels[0], x_channels)
        self.external_cond_dim = external_cond_dim
        if external_cond_dim:
            self.external_cond_embedding = RandomDropoutCondEmbedding(
                external_cond_dim, E, external_cond_dropout)

    @property
    def num_levels(self) -> int:
        return len(self.spec.channels)

    def level_resolution(self, i_level: int) -> int:
        return self.resolution // self.spec.patch_size // (2**i_level)

    def _rope(self, table: RoPE) -> RopeTables:
        """A level's RoPE table on the device; with a ``pos_emb_type`` other
        than ``rope`` the identity rotation of its shape (cos 1, sin 0),
        which carries only the q/k norm scales folded into it."""
        if self.spec.pos_emb_type != "rope":
            table = RoPE(np.ones_like(table.cos), np.zeros_like(table.sin), table.sizes)
        return RopeTables(table)

    def _make_block(self, i: int) -> nn.Module:
        s = self.spec
        ch = s.channels[i]
        if s.block_types[i] == "ResBlock":
            return ResBlock(ch, s.emb_channels)
        d, T, r = ch // s.num_heads, s.max_temporal_length, self.level_resolution(i)
        if s.block_types[i] == "TransformerBlock":
            if i not in self._ropes:
                self._ropes[i] = {"rope": self._rope(make_rope_3d(d, (T, r, r)))}
            axial = {}
        else:
            if i not in self._ropes:
                self._ropes[i] = {"rope": None, "rope_ax1": self._rope(make_rope_1d(d, T)),
                                  "rope_ax2": self._rope(make_rope_2d(d, (r, r)))}
            axial = {"ax1_len": T}
        return TransformerBlock(ch, s.num_heads, s.emb_channels, dropout=s.block_dropouts[i],
                                **self._ropes[i], **axial)

    def block_names(self):
        """[(block_name, i_level)] in forward order, the JAX package's names."""
        s = self.spec
        out = []
        for i in range(self.num_levels - 1):
            out += [(f"down_{i}_{j}", i) for j in range(s.num_updown_blocks[i])]
        out += [(f"mid_{j}", self.num_levels - 1) for j in range(s.num_mid_blocks)]
        for i in reversed(range(self.num_levels - 1)):
            out += [(f"up_{i}_{j}", i) for j in range(s.num_updown_blocks[i])]
        return out

    def block(self, name: str) -> nn.Module:
        """The module of a block named as in :meth:`block_names`."""
        kind, *idx = name.split("_")
        if kind == "mid":
            return self.mid_blocks[int(idx[0])]
        i, j = int(idx[0]), int(idx[1])
        if kind == "down":
            return self.down_blocks[i][j]
        return self.up_blocks[self.num_levels - 2 - i][1 + j]

    def use_plain_attention(self, plain: bool = True) -> None:
        """Route every transformer block through the plain versions of the
        attention kernels (True) or through the kernels (False)."""
        for m in self.modules():
            if isinstance(m, _QKNormAttention):
                m.plain_attention = plain

    def _run_block(self, block, x, emb, pose_mod, pose_scale, B, T, i_level):
        if isinstance(block, ResBlock):
            if pose_mod is not None:
                pose_mod = pose_mod.reshape((-1,) + pose_mod.shape[2:])
                if pose_scale is not None:
                    pose_scale = pose_scale.reshape(-1, 1, 1, 1)
            return block(x, emb, pose_mod, pose_scale)
        BT, h, w, C = x.shape
        E = emb.shape[-1]
        xt = x.reshape(B, T * h * w, C)
        if emb.shape[1] == 1 and emb.shape[2] == 1 and block.use_axial:
            # an axial block regroups its tokens and takes the embedding per token
            et = emb.reshape(B, T, 1, E).expand(B, T, h * w, E).reshape(B, T * h * w, E)
        elif emb.shape[1] == 1 and emb.shape[2] == 1:
            et = emb.reshape(B, T, E)  # per frame: FiLMNorm broadcasts
        else:
            et = emb.reshape(B, T * h * w, E)
        if pose_mod is not None:
            pose_mod = pose_mod.reshape(B, T * h * w, pose_mod.shape[-1])
            if pose_scale is not None:
                pose_scale = pose_scale[:, :, None].expand(B, T, h * w).reshape(B, T * h * w, 1)
        if self.spec.use_checkpointing[i_level] and torch.is_grad_enabled():
            out = remat(self.spec.remat_policy)(block, xt, et, pose_mod, pose_scale)
        else:
            out = block(xt, et, pose_mod, pose_scale)
        return out.reshape(BT, h, w, C)

    def forward(self, x, noise_levels, external_cond=None, external_cond_mask=None):
        s = self.spec
        p = s.patch_size
        hh = ww = self.level_resolution(0)
        w_in = self.embed_input.proj.weight
        if self.token_io:
            B, T, N, D = x.shape
            if N != hh * ww or D != p * p * self.x_channels:
                raise ValueError(f"token_io expects (B, T, {hh * ww}, {p * p * self.x_channels}), got {tuple(x.shape)}")
            rows = x
        else:
            B, T = x.shape[:2]
            rows = patchify(x, p)
        if T != s.max_temporal_length:
            raise ValueError(f"U-ViT temporal length fixed at {s.max_temporal_length}, got {T}")
        x = F.linear(rows.to(w_in.dtype), conv_as_patch_matrix(w_in), self.embed_input.proj.bias)
        x = x.reshape(B * T, hh, ww, -1)

        emb = self.noise_level_pos_embedding(noise_levels)  # (B, T, E)
        embs, pose_mods, pose_scale = self._conditioning(emb, external_cond, external_cond_mask, B, T)
        run = lambda blk, x, i, name: self._run_block(
            blk, x, embs[i], pose_mods.get(name), pose_scale, B, T, i
        )

        L = self.num_levels
        hs_before, hs_after = [], []
        for i in range(L - 1):
            blocks = self.down_blocks[i]
            for j in range(s.num_updown_blocks[i]):
                x = run(blocks[j], x, i, f"down_{i}_{j}")
            hs_before.append(x)
            x = blocks[-1](x)
            hs_after.append(x)
        for j, blk in enumerate(self.mid_blocks):
            x = run(blk, x, L - 1, f"mid_{j}")
        for _i in range(L - 1):
            i = L - 2 - _i
            blocks = self.up_blocks[_i]
            x = x - hs_after.pop()
            x = blocks[0](x)
            x = x + hs_before.pop()
            for j in range(s.num_updown_blocks[i]):
                x = run(blocks[1 + j], x, i, f"up_{i}_{j}")

        x = self.project_output(x).reshape(B, T, hh * ww, p * p * self.x_channels).float()
        if self.token_io:
            return x
        return unpatchify_tokens(x, p, self.resolution, self.resolution)

    def _conditioning(self, emb, external_cond, external_cond_mask, B, T):
        """(per-level emb maps, per-block pose FiLM terms, pose scale)."""
        if external_cond is not None and self.external_cond_dim:
            cond = self.external_cond_embedding(external_cond, external_cond_mask)
            emb = emb + cond.to(emb.dtype)
        return [emb.reshape(B * T, 1, 1, -1)] * self.num_levels, {}, None


class UViT3DPose(UViT3D):
    """U-ViT with spatial camera-pose conditioning. ``external_cond`` is the
    raw (B, T, H, W, Cp) pose map, or the dict of
    :func:`precompute_pose_conditioning` (the sampling path)."""

    def __init__(self, spec: UViTSpec, x_channels: int, resolution: int,
                 external_cond_dim: int, use_fourier_noise_emb: bool = False,
                 token_io: bool = False, external_cond_dropout: float = 0.0):
        super().__init__(spec, x_channels, resolution, use_fourier_noise_emb, token_io)
        self.external_cond_dropout = external_cond_dropout
        self.external_cond_embedding = nn.Module()
        self.external_cond_embedding.patch_embedder = PatchEmbed(
            spec.patch_size, external_cond_dim, spec.emb_channels
        )

    def forward(self, x, noise_levels, external_cond=None, external_cond_mask=None):
        if external_cond is None:
            raise ValueError("UViT3DPose requires camera-pose conditioning")
        return super().forward(x, noise_levels, external_cond, external_cond_mask)

    def _conditioning(self, emb, external_cond, external_cond_mask, B, T):
        E = emb.shape[-1]
        if isinstance(external_cond, dict):
            if self.training:
                raise ValueError("precomputed pose conditioning is for inference only")
            levels = external_cond.get("levels") or {}
            pose_scale = None
            if external_cond_mask is not None:
                keep = 1.0 - external_cond_mask.to(emb.dtype)
                pose_scale = keep.reshape(B, -1).expand(B, T)
            embs = []
            for i in range(self.num_levels):
                lm = levels.get(str(i))
                if lm is None:
                    embs.append(emb.reshape(B * T, 1, 1, E))
                    continue
                # an axial level takes its pooled pose map as it is
                lm = lm.to(emb.dtype)
                if pose_scale is not None:
                    lm = lm * pose_scale[:, :, None, None, None]
                e = emb[:, :, None, None, :] + lm
                embs.append(e.reshape((B * T,) + e.shape[2:]))
            return embs, external_cond.get("mods") or {}, pose_scale
        hh = self.level_resolution(0)
        pose = self.external_cond_embedding.patch_embedder(external_cond)
        pose = pose.reshape(B, T, hh, hh, E)
        if self.external_cond_dropout > 0 and self.training:
            # whole-sample dropout of the pose conditioning (CFG)
            drop = uniform((B,), pose.device) < self.external_cond_dropout
            pose = torch.where(drop[:, None, None, None, None], 0.0, pose)
        elif external_cond_mask is not None:
            m = external_cond_mask.reshape(
                external_cond_mask.shape + (1,) * (pose.ndim - external_cond_mask.ndim)
            )
            pose = torch.where(m, 0.0, pose)
        e0 = (emb[:, :, None, None, :] + pose.to(emb.dtype)).reshape(B * T, hh, hh, E)
        embs = [e0] + [
            _nchw(lambda t, k=2**i: F.avg_pool2d(t, k), e0) for i in range(1, self.num_levels)
        ]
        return embs, {}, None


@torch.no_grad()
def precompute_pose_conditioning(model: UViT3DPose, pose_map: torch.Tensor) -> dict:
    """Step-invariant half of the pose conditioning, once per window.

    Every block's FiLM modulation is ``emb_layer(noise_vec + pose_map_emb)``;
    ``emb_layer`` is linear, so the pose term ``W @ pose_map_emb`` (patch
    embedding, per-level pooling, every block's projection) is computed here
    and added inside the blocks. An axial block regroups its tokens, so its
    level keeps the pooled pose map itself, which the model adds to the
    noise-level embedding. pose_map: raw (B, T, H, W, Cp). Returns
    {"mods": {block_name: (B, T, h_l, w_l, 2C)},
    "levels": {str(i_level): (B, T, h_l, w_l, E)}}, "levels" only for the
    axial levels.
    """
    s = model.spec
    B, T, H, W, Cp = pose_map.shape
    pe = model.external_cond_embedding.patch_embedder.proj
    dt = pe.weight.dtype
    h0, w0 = H // s.patch_size, W // s.patch_size
    rows = patchify(pose_map.to(dt), s.patch_size)
    emb0 = F.linear(rows, conv_as_patch_matrix(pe.weight), pe.bias)
    E = emb0.shape[-1]
    emb0 = emb0.reshape(B * T, h0, w0, E)
    lvls = [emb0] + [
        _nchw(lambda t, k=2**i: F.avg_pool2d(t, k), emb0) for i in range(1, model.num_levels)
    ]
    mods, levels = {}, {}
    for name, i in model.block_names():
        blk = model.block(name)
        if s.block_types[i] == "AxialTransformerBlock":
            levels[str(i)] = lvls[i].reshape((B, T) + lvls[i].shape[1:])
            continue
        if isinstance(blk, ResBlock):
            w = blk.emb_layer.weight[:, :, 0, 0]
        else:
            w = blk.norm.emb_layer.weight
        m = F.linear(lvls[i], w)
        mods[name] = m.reshape((B, T) + m.shape[1:])
    return {"mods": mods, "levels": levels}
