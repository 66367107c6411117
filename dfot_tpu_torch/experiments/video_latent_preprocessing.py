"""Latent preprocessing: every video encoded to fp16 latents on disk.

Port of ``dfot_tpu/experiments/video_latent_preprocessing.py`` on ``device``
(None: the card): for the training and validation splits that exist, each
whole video of the dataset's plain ``VideoDataset`` is encoded in chunks of
``algorithm.max_encode_length`` frames (a causal VideoVAE's chunks cut to
1 + k * 4 frames), its posterior sampled from a generator seeded 0 (the
DC-AE is deterministic), and saved as ``{save_dir}_latent_{resolution}/
{split}/{stem}.npy`` (channel-last fp16); files already there are skipped.
Then the channel-wise statistics of the split's latents go beside them as
``data_mean.npy`` and ``data_std.npy``.

The VAE is the algorithm's: ``dc_ae`` (the DC-AE, ``algorithm.pretrained_path``
named and present, else seeded random), ``titok`` (TiTok-KL, upstream
weights from ``algorithm.pretrained_path``), ``kl_autoencoder`` (the
diffusers kl-f8 AutoencoderKL, or the ImageVAE of ``algorithm.ddconfig``
where given; a diffusers state dict from ``algorithm.pretrained_path`` or a
``pretrained_model_name_or_path`` that is a local file or diffusers
directory, else a warning and seeded random weights), ``video`` (the
VideoVAE of ``algorithm.model``) or else the ImageVAE of
``algorithm.ddconfig``; their weights from ``load=``, a torch file of the
module's state dict, where given. A weights path the disk lacks raises.
TiTok and kl-f8 keep the posterior's mode; TiTok takes videos in [0, 1],
the others in [-1, 1]. TiTok's latents are its tokens, (T, N, token_size).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..data.video_dataset import VideoDataset
from ..diffusion.core import resolve_device
from ..utils.logging import MetricsLogger
from ..utils.torch_ckpt import load_state_dict, resolve_weights_path
from ..vae import (
    DCAE,
    KL_F8_CONFIG,
    AutoencoderKL,
    DCAEConfig,
    ImageVAE,
    ImageVAEConfig,
    TiTokConfig,
    TiTokKL,
    VideoVAE,
    VideoVAEConfig,
    diffusers_state_dict,
    estimate_latent_stats,
)
from ..vae.codec import RANDOM_VAE_SEED

__all__ = ["VideoLatentPreprocessingExperiment"]

ENCODE_SEED = 0  # the posterior draws of the KL VAEs


def _local_diffusers_weights(name_or_path: Optional[str]) -> Optional[str]:
    """``pretrained_model_name_or_path`` as a local weights file, where it
    names one or a diffusers directory holding one (a hub name is not
    fetched)."""
    if not name_or_path:
        return None
    p = str(name_or_path)
    if os.path.isfile(p):
        return p
    if os.path.isdir(p):
        for fname in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin"):
            if os.path.exists(os.path.join(p, fname)):
                return os.path.join(p, fname)
    return None


class VideoLatentPreprocessingExperiment:
    def __init__(self, cfg, output_dir: Optional[str] = None, load: Optional[str] = None,
                 device=None):
        self.cfg = cfg
        self.output_dir = output_dir or "outputs"
        os.makedirs(self.output_dir, exist_ok=True)
        self.load_path = load
        self.device = resolve_device(device)
        self.timings: Dict[str, float] = {}
        self.max_encode_length = cfg.algorithm.get("max_encode_length", 16)
        self._build_vae()
        self.logger = MetricsLogger(self.output_dir)

    def _build_vae(self) -> None:
        acfg = self.cfg.algorithm
        name = acfg.get("_name", "image_vae_preprocessor")
        self.is_titok = "titok" in name
        is_kl = "kl_autoencoder" in name
        self.is_video_vae = "video" in name and not (self.is_titok or is_kl)
        self.is_deterministic = "dc_ae" in name
        self.keeps_mode = self.is_titok or is_kl
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(RANDOM_VAE_SEED)
            if self.is_titok:
                self.vae_cfg = TiTokConfig.from_config(acfg)
                vae = TiTokKL(self.vae_cfg)
            elif is_kl:
                self.vae_cfg = (ImageVAEConfig.from_config(acfg) if acfg.get("ddconfig") is not None
                                else KL_F8_CONFIG)
                vae = AutoencoderKL(self.vae_cfg)
            elif self.is_video_vae:
                self.vae_cfg = VideoVAEConfig.from_config(acfg)
                vae = VideoVAE(self.vae_cfg)
            elif self.is_deterministic:
                self.vae_cfg = DCAEConfig.from_config(acfg)
                vae = DCAE(self.vae_cfg)
            else:
                self.vae_cfg = ImageVAEConfig.from_config(acfg)
                vae = ImageVAE(self.vae_cfg)
        path, rename = self.load_path, None
        if not path and (self.is_deterministic or self.is_titok or is_kl) \
                and acfg.get("pretrained_path"):
            path = resolve_weights_path(str(acfg.pretrained_path))
            rename = diffusers_state_dict if is_kl else None
        if not path and is_kl:
            path = _local_diffusers_weights(acfg.get("pretrained_model_name_or_path"))
            rename = diffusers_state_dict
            if not path:
                print(f"WARNING: the kl_autoencoder preprocessor has no weights "
                      f"(pretrained_path unset and pretrained_model_name_or_path="
                      f"{acfg.get('pretrained_model_name_or_path')!r} is not a local "
                      f"checkpoint): latents will come from a randomly initialized VAE. Point "
                      f"algorithm.pretrained_path at a diffusers sd-vae-ft-* checkpoint before "
                      f"real preprocessing.")
        self.pretrained = bool(path)
        if path:
            if not os.path.exists(str(path)):
                raise FileNotFoundError(f"VAE weights {path}: no such file")
            state = load_state_dict(str(path))
            state = dict(state.get("state_dict", state))
            vae.load_state_dict(rename(state) if rename else state, strict=True)
        self.vae = vae.to(self.device).eval().requires_grad_(False)

    def exec_task(self, task: str) -> None:
        if task != "validation":
            raise ValueError("latent preprocessing runs as a validation task")
        self.validation()

    def validation(self) -> None:
        dcfg = self.cfg.dataset
        for split in ("training", "validation"):
            try:
                dataset = VideoDataset(dcfg, split)
            except FileNotFoundError:
                continue
            latent_dir = os.path.join(f"{dcfg.save_dir}_latent_{dcfg.resolution}", split)
            os.makedirs(latent_dir, exist_ok=True)
            generator = torch.Generator(device=self.device).manual_seed(ENCODE_SEED)
            done = 0
            for meta in dataset.metadata:
                base = os.path.splitext(os.path.basename(meta["path"]))[0]
                out_path = os.path.join(latent_dir, base + ".npy")
                if os.path.exists(out_path):
                    continue
                video = dataset._load_video(meta, 0, meta["length"])
                np.save(out_path, self._encode_video(video, generator).astype(np.float16))
                done += 1
            self.logger.log({f"{split}/videos_encoded": done}, 0)

            # channel-wise stats for the dataset config
            paths = [os.path.join(latent_dir, f) for f in sorted(os.listdir(latent_dir))
                     if f.endswith(".npy")]
            if paths:
                mean, std = estimate_latent_stats(paths)
                np.save(os.path.join(latent_dir, "data_mean.npy"), mean)
                np.save(os.path.join(latent_dir, "data_std.npy"), std)

    def _encode(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if self.is_deterministic:
            return self.vae.encode(x)
        if self.keeps_mode:
            return self.vae.encode(x).mode()
        return self.vae.encode(x).sample(generator)

    @torch.no_grad()
    def _encode_video(self, video: np.ndarray, generator: torch.Generator) -> np.ndarray:
        """(T, H, W, C) in [0, 1] -> channel-last latents, chunk by chunk."""
        x = torch.as_tensor(np.asarray(video), dtype=torch.float32).to(self.device)
        if not self.is_titok:
            x = x * 2.0 - 1.0
        chunks = []
        if self.is_video_vae:
            f = self.vae_cfg.temporal_downsampling_factor
            step = 1 + (self.max_encode_length - 1) // f * f
            t = 0
            while t < x.shape[0]:
                seg = x[t:t + step]
                n = (seg.shape[0] - 1) // f * f + 1  # the valid causal length
                z = self._encode(seg[None, :n].permute(0, 4, 1, 2, 3).contiguous(), generator)
                chunks.append(z[0].permute(1, 2, 3, 0))
                t += n
        else:
            for t in range(0, x.shape[0], self.max_encode_length):
                seg = x[t:t + self.max_encode_length].permute(0, 3, 1, 2).contiguous()
                z = self._encode(seg, generator)
                chunks.append(z if self.is_titok else z.permute(0, 2, 3, 1))
        return torch.cat(chunks).cpu().numpy()

    def close(self) -> None:
        self.logger.close()
