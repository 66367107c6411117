"""DC-AE: the deep-compression autoencoder of the SANA family.

Port of ``dfot_tpu/vae/dc_ae.py`` (the reference's vendored diffusers
``AutoencoderDC``): a deterministic autoencoder whose residual conv stages
and linear-attention EfficientViT blocks are joined by pixel-(un)shuffle
residual shortcuts around every down- and upsample. The modules are
channel-first (NCHW), as PyTorch's convolutions are, and keep the diffusers
state-dict names (``encoder.down_blocks.1.0.conv1.weight``, ...), so
``dfot_tpu.vae.dc_ae.import_dc_ae_params`` takes this module's
``state_dict()`` as it takes a diffusers checkpoint, and such a checkpoint
loads here with ``load_state_dict``. The linear attention is plain tensor
products, as in the JAX package (no Pallas kernel there); the convolutions
are cuDNN's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["DCAEConfig", "DCAE", "pixel_unshuffle", "pixel_shuffle"]


# ---------------------------------------------------------------------------
# pixel shuffles (channel-major: out channel = (C, r, r))
# ---------------------------------------------------------------------------


def pixel_unshuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """(B, C, H, W) -> (B, C*r*r, H/r, W/r), channel c*r*r + i*r + j from
    pixel (r*h + i, r*w + j) of channel c (``dfot_tpu/vae/dc_ae.py:35``)."""
    return F.pixel_unshuffle(x, r)


def pixel_shuffle(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """The inverse of :func:`pixel_unshuffle` (``dfot_tpu/vae/dc_ae.py:43``)."""
    return F.pixel_shuffle(x, r)


_ACTS = {"relu": F.relu, "relu6": F.relu6, "silu": F.silu}


# ---------------------------------------------------------------------------
# norms over the channel axis (dim 1)
# ---------------------------------------------------------------------------


class RMSNormT(nn.Module):
    """diffusers RMSNorm over the channels: fp32 variance, affine weight and
    bias (``dfot_tpu/vae/dc_ae.py:61``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(1, keepdim=True) + self.eps)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return xf.to(x.dtype) * self.weight.view(shape) + self.bias.view(shape)


class BatchNorm2dInf(nn.Module):
    """Inference-mode BatchNorm2d: the running statistics always applied
    (``dfot_tpu/vae/dc_ae.py:81``; the DC-AE is a frozen preprocessor).
    ``num_batches_tracked`` is kept so torch checkpoints load strictly."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]


def _norm(norm_type: str, features: int) -> nn.Module:
    if norm_type == "rms_norm":
        return RMSNormT(features)
    if norm_type == "batch_norm":
        return BatchNorm2dInf(features)
    raise ValueError(f"unsupported norm {norm_type}")


def _conv(cin: int, cout: int, k: int, bias: bool = True, groups: int = 1) -> nn.Conv2d:
    """A stride-1 'same' convolution, flax's ``nn.Conv`` default."""
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias, groups=groups)


# ---------------------------------------------------------------------------
# blocks (reference autoencoder_dc_model.py:108-284)
# ---------------------------------------------------------------------------


class ResBlock(nn.Module):
    """conv1 -> act -> conv2 (no bias) -> norm, plus the input."""

    def __init__(self, channels: int, norm_type: str = "rms_norm", act_fn: str = "silu"):
        super().__init__()
        self.act = _ACTS[act_fn]
        self.conv1 = _conv(channels, channels, 3)
        self.conv2 = _conv(channels, channels, 3, bias=False)
        self.norm = _norm(norm_type, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.conv2(self.act(self.conv1(x)))) + x


class SanaMultiscaleAttentionProjection(nn.Module):
    """Depthwise conv, then a 1x1 grouped per (head, stream)."""

    def __init__(self, inner_dim: int, num_heads: int, kernel_size: int):
        super().__init__()
        ch = 3 * inner_dim
        self.proj_in = _conv(ch, ch, kernel_size, bias=False, groups=ch)
        self.proj_out = nn.Conv2d(ch, ch, 1, bias=False, groups=3 * num_heads)

    def forward(self, qkv: torch.Tensor) -> torch.Tensor:
        return self.proj_out(self.proj_in(qkv))


class SanaMultiscaleLinearAttention(nn.Module):
    """ReLU linear attention with multiscale conv aggregation
    (``dfot_tpu/vae/dc_ae.py:152``); the heads are torch's channel-major
    ``reshape(B, -1, 3*d, HW)`` groups."""

    def __init__(self, in_channels: int, out_channels: int, attention_head_dim: int = 32,
                 mult: float = 1.0, norm_type: str = "rms_norm",
                 kernel_sizes: Tuple[int, ...] = (5,), eps: float = 1e-15,
                 residual_connection: bool = True):
        super().__init__()
        self.head_dim = attention_head_dim
        self.eps = eps
        self.residual_connection = residual_connection
        num_heads = int(in_channels // attention_head_dim * mult)
        inner = num_heads * attention_head_dim
        self.to_q = nn.Linear(in_channels, inner, bias=False)
        self.to_k = nn.Linear(in_channels, inner, bias=False)
        self.to_v = nn.Linear(in_channels, inner, bias=False)
        self.to_qkv_multiscale = nn.ModuleList(
            SanaMultiscaleAttentionProjection(inner, num_heads, k) for k in kernel_sizes)
        # every scale's heads reach the output projection
        self.to_out = nn.Linear(inner * (1 + len(kernel_sizes)), out_channels, bias=False)
        self.norm_out = _norm(norm_type, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        d = self.head_dim
        xl = x.movedim(1, -1)
        qkv = torch.cat([self.to_q(xl), self.to_k(xl), self.to_v(xl)], dim=-1).movedim(-1, 1)
        h = torch.cat([qkv] + [proj(qkv) for proj in self.to_qkv_multiscale], dim=1)

        use_linear = H * W > d
        if use_linear:
            h = h.float()
        h = h.reshape(B, -1, 3 * d, H * W)
        qh, kh, vh = torch.chunk(h, 3, dim=2)  # each (B, n, d, HW)
        qh, kh = F.relu(qh), F.relu(kh)
        if use_linear:  # reference :88-96
            vh = F.pad(vh, (0, 0, 0, 1), value=1.0)
            scores = torch.matmul(vh, kh.transpose(-1, -2))  # (B, n, d+1, d)
            out = torch.matmul(scores, qh)  # (B, n, d+1, HW)
            out = out[:, :, :-1] / (out[:, :, -1:] + self.eps)
        else:  # reference :98-102
            scores = torch.matmul(kh.transpose(-1, -2), qh).float()  # (B, n, HW, HW)
            scores = scores / (scores.sum(dim=2, keepdim=True) + self.eps)
            out = torch.matmul(vh.to(scores.dtype), scores)
        out = out.to(x.dtype).reshape(B, -1, H, W)
        out = self.to_out(out.movedim(1, -1)).movedim(-1, 1)
        out = self.norm_out(out)
        return out + x if self.residual_connection else out


class GLUMBConv(nn.Module):
    """Gated inverted-bottleneck conv (diffusers ``GLUMBConv``); its norm is
    there for ``rms_norm`` only."""

    def __init__(self, in_channels: int, out_channels: int, expand_ratio: float = 4.0,
                 norm_type: str = "rms_norm", residual_connection: bool = True):
        super().__init__()
        hidden = int(expand_ratio * in_channels)
        self.residual_connection = residual_connection
        self.conv_inverted = nn.Conv2d(in_channels, 2 * hidden, 1)
        self.conv_depth = _conv(2 * hidden, 2 * hidden, 3, groups=2 * hidden)
        self.conv_point = nn.Conv2d(hidden, out_channels, 1, bias=False)
        self.norm = RMSNormT(out_channels) if norm_type == "rms_norm" else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_depth(F.silu(self.conv_inverted(x)))
        h, gate = torch.chunk(h, 2, dim=1)
        h = self.conv_point(h * F.silu(gate))
        if self.norm is not None:
            h = self.norm(h)
        return h + x if self.residual_connection else h


class EfficientViTBlock(nn.Module):
    """Linear attention, then GLUMBConv."""

    def __init__(self, channels: int, attention_head_dim: int = 32,
                 norm_type: str = "rms_norm", qkv_multiscales: Tuple[int, ...] = ()):
        super().__init__()
        self.attn = SanaMultiscaleLinearAttention(
            channels, channels, attention_head_dim=attention_head_dim, norm_type=norm_type,
            kernel_sizes=tuple(qkv_multiscales), residual_connection=True)
        self.conv_out = GLUMBConv(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.attn(x))


class DCDownBlock2d(nn.Module):
    """conv + pixel_unshuffle (or a stride-2 conv), group-mean shortcut."""

    def __init__(self, in_channels: int, out_channels: int, downsample: bool = False,
                 shortcut: bool = True):
        super().__init__()
        self.downsample = downsample
        self.shortcut = shortcut
        self.group_size = in_channels * 4 // out_channels
        conv_out = out_channels // 4 if downsample else out_channels
        # a stride-2 'SAME' conv pads (0, 1) on even inputs: explicit below
        self.conv = nn.Conv2d(in_channels, conv_out, 3, stride=1 if downsample else 2,
                              padding=1 if downsample else 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample:
            h = pixel_unshuffle(self.conv(x), 2)
        else:
            h = self.conv(F.pad(x, (0, 1, 0, 1)))
        if self.shortcut:
            y = pixel_unshuffle(x, 2)
            B, C, H, W = y.shape
            h = h + y.reshape(B, C // self.group_size, self.group_size, H, W).mean(2)
        return h


class DCUpBlock2d(nn.Module):
    """conv + pixel_shuffle (or nearest upsample + conv), channel-repeat
    shortcut."""

    def __init__(self, in_channels: int, out_channels: int, interpolate: bool = False,
                 shortcut: bool = True):
        super().__init__()
        self.interpolate = interpolate
        self.shortcut = shortcut
        self.repeats = out_channels * 4 // in_channels
        self.conv = _conv(in_channels, out_channels if interpolate else out_channels * 4, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.interpolate:
            h = self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
        else:
            h = pixel_shuffle(self.conv(x), 2)
        if self.shortcut:
            h = h + pixel_shuffle(x.repeat_interleave(self.repeats, dim=1), 2)
        return h


# ---------------------------------------------------------------------------
# config / encoder / decoder (reference :286-467)
# ---------------------------------------------------------------------------


def _per_level(v, n: int) -> Tuple:
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


@dataclasses.dataclass(frozen=True)
class DCAEConfig:
    """The fields of ``configurations/algorithm/dc_ae_preprocessor.yaml``."""

    in_channels: int = 3
    latent_channels: int = 32
    attention_head_dim: int = 32
    encoder_block_types: Tuple[str, ...] = ("ResBlock",) * 3 + ("EfficientViTBlock",)
    decoder_block_types: Tuple[str, ...] = ("ResBlock",) * 3 + ("EfficientViTBlock",)
    encoder_block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    decoder_block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    encoder_layers_per_block: Tuple[int, ...] = (0, 4, 8, 2)
    decoder_layers_per_block: Tuple[int, ...] = (0, 5, 10, 2)
    encoder_qkv_multiscales: Tuple[Tuple[int, ...], ...] = ((), (), (), ())
    decoder_qkv_multiscales: Tuple[Tuple[int, ...], ...] = ((), (), (), ())
    decoder_norm_types: Tuple[str, ...] = ("batch_norm",) * 3 + ("rms_norm",)
    decoder_act_fns: Tuple[str, ...] = ("relu",) * 3 + ("silu",)
    downsample_block_type: str = "pixel_unshuffle"
    upsample_block_type: str = "pixel_shuffle"
    scaling_factor: float = 0.2889

    @property
    def spatial_compression(self) -> int:
        return 2 ** (len(self.encoder_block_out_channels) - 1)

    @classmethod
    def from_config(cls, cfg) -> "DCAEConfig":
        """``dfot_tpu/vae/dc_ae.py:DCAEConfig.from_config`` (:355)."""
        n = len(cfg.get("encoder_block_out_channels", [128, 256, 512, 512]))

        def get(key, default):
            v = cfg.get(key, default)
            return v if not isinstance(v, (list, tuple)) else tuple(
                tuple(e) if isinstance(e, (list, tuple)) else e for e in v)

        return cls(
            in_channels=cfg.get("in_channels", 3),
            latent_channels=cfg.get("latent_channels", 32),
            attention_head_dim=cfg.get("attention_head_dim", 32),
            encoder_block_types=_per_level(
                get("encoder_block_types", ["ResBlock"] * 3 + ["EfficientViTBlock"]), n),
            decoder_block_types=_per_level(
                get("decoder_block_types", ["ResBlock"] * 3 + ["EfficientViTBlock"]), n),
            encoder_block_out_channels=get("encoder_block_out_channels", [128, 256, 512, 512]),
            decoder_block_out_channels=get("decoder_block_out_channels", [128, 256, 512, 512]),
            encoder_layers_per_block=get("encoder_layers_per_block", [0, 4, 8, 2]),
            decoder_layers_per_block=get("decoder_layers_per_block", [0, 5, 10, 2]),
            encoder_qkv_multiscales=get("encoder_qkv_multiscales", [(), (), (), ()]),
            decoder_qkv_multiscales=get("decoder_qkv_multiscales", [(), (), (), ()]),
            decoder_norm_types=_per_level(
                get("decoder_norm_types", ["batch_norm"] * 3 + ["rms_norm"]), n),
            decoder_act_fns=_per_level(get("decoder_act_fns", ["relu"] * 3 + ["silu"]), n),
            downsample_block_type=cfg.get("downsample_block_type", "pixel_unshuffle"),
            upsample_block_type=cfg.get("upsample_block_type", "pixel_shuffle"),
            scaling_factor=cfg.get("scaling_factor", 0.2889),
        )


def _make_block(block_type, ch, head_dim, norm_type, act_fn, multiscales) -> nn.Module:
    if block_type == "ResBlock":
        return ResBlock(ch, norm_type, act_fn)
    if block_type == "EfficientViTBlock":
        return EfficientViTBlock(ch, attention_head_dim=head_dim, norm_type=norm_type,
                                 qkv_multiscales=tuple(multiscales))
    raise ValueError(f"unsupported block type {block_type}")


class DCAEEncoder(nn.Module):
    def __init__(self, c: DCAEConfig):
        super().__init__()
        chs, lpb = c.encoder_block_out_channels, c.encoder_layers_per_block
        n = len(chs)
        unshuffle = c.downsample_block_type == "pixel_unshuffle"
        stem_out = chs[0] if lpb[0] > 0 else chs[1]
        if lpb[0] > 0:
            self.conv_in = _conv(c.in_channels, stem_out, 3)
        else:
            self.conv_in = DCDownBlock2d(c.in_channels, stem_out, downsample=unshuffle,
                                         shortcut=False)
        self.down_blocks = nn.ModuleList()
        for i in range(n):
            stage = [_make_block(c.encoder_block_types[i], chs[i], c.attention_head_dim,
                                 "rms_norm", "silu", c.encoder_qkv_multiscales[i])
                     for _ in range(lpb[i])]
            if i < n - 1 and lpb[i] > 0:
                stage.append(DCDownBlock2d(chs[i], chs[i + 1], downsample=unshuffle,
                                           shortcut=True))
            self.down_blocks.append(nn.Sequential(*stage))
        self.conv_out = _conv(chs[-1], c.latent_channels, 3)
        self.out_group = chs[-1] // c.latent_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for stage in self.down_blocks:
            h = stage(h)
        B, C, H, W = h.shape
        # out_shortcut: contiguous channel-group mean (reference :356-372)
        return self.conv_out(h) + h.reshape(B, C // self.out_group, self.out_group, H, W).mean(2)


class DCAEDecoder(nn.Module):
    def __init__(self, c: DCAEConfig):
        super().__init__()
        chs, lpb = c.decoder_block_out_channels, c.decoder_layers_per_block
        n = len(chs)
        interpolate = c.upsample_block_type == "interpolate"
        self.in_repeats = chs[-1] // c.latent_channels
        self.conv_in = _conv(c.latent_channels, chs[-1], 3)
        self.up_blocks = nn.ModuleList()
        for i in range(n):
            stage = []
            if i < n - 1 and lpb[i] > 0:
                stage.append(DCUpBlock2d(chs[i + 1], chs[i], interpolate=interpolate,
                                         shortcut=True))
            stage += [_make_block(c.decoder_block_types[i], chs[i], c.attention_head_dim,
                                  c.decoder_norm_types[i], c.decoder_act_fns[i],
                                  c.decoder_qkv_multiscales[i]) for _ in range(lpb[i])]
            self.up_blocks.append(nn.Sequential(*stage))
        out_ch = chs[0] if lpb[0] > 0 else chs[1]
        self.norm_out = RMSNormT(out_ch)
        if lpb[0] > 0:
            self.conv_out = _conv(out_ch, c.in_channels, 3)
        else:
            self.conv_out = DCUpBlock2d(out_ch, c.in_channels, interpolate=interpolate,
                                        shortcut=False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        # in_shortcut: channel repeat (reference :448-452)
        h = self.conv_in(z) + z.repeat_interleave(self.in_repeats, dim=1)
        for stage in reversed(self.up_blocks):
            h = stage(h)
        return self.conv_out(F.relu(self.norm_out(h)))


class DCAE(nn.Module):
    """Deterministic deep-compression autoencoder: ``encode`` (B, 3, H, W)
    -> the raw latent (B, latent_channels, H/f, W/f) (scaled downstream by
    ``cfg.scaling_factor`` where a recipe asks), ``decode`` back."""

    def __init__(self, cfg: DCAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = DCAEEncoder(cfg)
        self.decoder = DCAEDecoder(cfg)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)
