"""LatentCodec: the algorithm-facing VAE encode and decode.

Port of ``dfot_tpu/vae/codec.py:LatentCodec`` on ``device`` (None: the
card). The VAE family follows the latent config: ``vae.name`` containing
``dc_ae`` builds the deterministic DC-AE, a temporal factor above 1 the
causal VideoVAE, else the per-frame ImageVAE, each at the JAX package's
widths. The per-frame VAEs encode and decode in chunks of ``batch_size * 8``
frames (``vae.batch_size``), the KL ones drawing their posterior sample per
chunk from the caller's generator; the VideoVAE takes the batch whole, as
in JAX.

Weights: ``vae.pretrained_path`` (``pretrained:NAME`` is
``data/ckpts/NAME``), a ``.pth``/``.ckpt``/``.pt``/``.safetensors`` file of
this module's state-dict names (diffusers' for the DC-AE; a Lightning
``state_dict`` entry is unwrapped), loaded strictly. A path that is named and
absent raises. Without one the VAE is a seeded random one (``pretrained``
False), built on the CPU under ``torch.manual_seed(RANDOM_VAE_SEED)`` so
its weights are the same whichever device it then moves to; the numbers
differ from the JAX package's random VAE.

The VAE is frozen: fp32 weights, encode and decode under ``no_grad``.
Videos are channel-last (B, T, H, W, 3) in [0, 1], latents channel-last
(B, T', h, w, C), as the JAX package's.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..diffusion.core import resolve_device
from ..utils.torch_ckpt import load_state_dict, resolve_weights_path

__all__ = ["LatentCodec", "RANDOM_VAE_SEED"]

RANDOM_VAE_SEED = 0


class LatentCodec:
    def __init__(self, algo_cfg, dataset_cfg, batch_size: Optional[int] = None, device=None):
        latent = dataset_cfg.latent
        self.temporal_factor = latent.downsampling_factor[0]
        self.spatial_factor = latent.downsampling_factor[1]
        self.num_channels = latent.num_channels
        self.resolution = dataset_cfg.resolution
        self.batch_size = batch_size or algo_cfg.vae.get("batch_size", 2)
        self.device = resolve_device(device)
        self.is_video = self.temporal_factor > 1
        vae_name = str(algo_cfg.vae.get("name", "") or "")
        self.deterministic = "dc_ae" in vae_name
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(RANDOM_VAE_SEED)
            self.vae = self._build(algo_cfg)
        path = algo_cfg.vae.get("pretrained_path")
        self.pretrained = bool(path)
        if path:
            file = resolve_weights_path(str(path))
            if not os.path.exists(file):
                raise FileNotFoundError(f"vae.pretrained_path={path}: no file {file}")
            state = load_state_dict(file)
            state = state.get("state_dict", state)
            self.vae.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()},
                                     strict=True)
        self.vae = self.vae.to(self.device).eval().requires_grad_(False)

    def _build(self, algo_cfg) -> torch.nn.Module:
        vae_cfg = algo_cfg.vae
        n_levels = int(np.log2(self.spatial_factor)) + 1
        if self.deterministic:
            from .dc_ae import DCAE, DCAEConfig

            return DCAE(DCAEConfig.from_config(vae_cfg))
        if self.is_video:
            from .video_vae import VideoVAE, VideoVAEConfig

            return VideoVAE(VideoVAEConfig(
                hidden_size=vae_cfg.get("hidden_size", 128),
                hidden_size_mult=tuple([1, 2, 4, 4][:n_levels]),
                z_channels=self.num_channels, embed_dim=self.num_channels,
                resolution=self.resolution))
        from .image_vae import ImageVAE, ImageVAEConfig

        return ImageVAE(ImageVAEConfig(
            ch=vae_cfg.get("ch", 128), ch_mult=tuple([1, 2, 4, 4][:n_levels]),
            z_channels=self.num_channels, embed_dim=self.num_channels,
            resolution=self.resolution))

    def _encode(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.deterministic:
            return self.vae.encode(x)
        return self.vae.encode(x).sample(generator)

    def _videos(self, videos) -> torch.Tensor:
        """Host or device videos in [0, 1] -> fp32 on the device in [-1, 1]."""
        x = torch.as_tensor(videos).to(self.device, torch.float32, non_blocking=True)
        return x * 2.0 - 1.0

    @torch.no_grad()
    def encode_video(self, videos, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, H, W, 3) in [0, 1] -> (B, T', h, w, C) latents, the KL
        posterior sampled from ``generator`` (on the codec's device)."""
        x = self._videos(videos)
        if self.is_video:
            z = self._encode(x.permute(0, 4, 1, 2, 3).contiguous(), generator)
            return z.permute(0, 2, 3, 4, 1).contiguous()
        B, T = x.shape[:2]
        flat = x.reshape((B * T,) + x.shape[2:]).permute(0, 3, 1, 2).contiguous()
        n = self.batch_size * 8
        z = torch.cat([self._encode(flat[i:i + n], generator)
                       for i in range(0, flat.shape[0], n)])
        return z.permute(0, 2, 3, 1).reshape((B, T) + z.shape[2:] + z.shape[1:2]).contiguous()

    @torch.no_grad()
    def decode_video(self, latents) -> torch.Tensor:
        """(B, T', h, w, C) -> (B, T, H, W, 3) in [0, 1]."""
        z = torch.as_tensor(latents).to(self.device, torch.float32)
        if self.is_video:
            out = self.vae.decode(z.permute(0, 4, 1, 2, 3).contiguous()).permute(0, 2, 3, 4, 1)
        else:
            B, T = z.shape[:2]
            flat = z.reshape((B * T,) + z.shape[2:]).permute(0, 3, 1, 2).contiguous()
            n = self.batch_size * 8
            out = torch.cat([self.vae.decode(flat[i:i + n]) for i in range(0, flat.shape[0], n)])
            out = out.permute(0, 2, 3, 1).reshape((B, T) + out.shape[2:] + out.shape[1:2])
        return torch.clamp(out * 0.5 + 0.5, 0.0, 1.0).contiguous()
