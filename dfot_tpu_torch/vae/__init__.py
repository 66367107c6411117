"""The VAEs of the latent path (``dfot_tpu/vae``): the DC-AE, the per-frame
ImageVAE, the causal VideoVAE, their diagonal-Gaussian posterior, the
algorithm-facing ``LatentCodec`` and the latent statistics. TiTok, the
diffusers AutoencoderKL and the VAE losses are not ported (ROADMAP.md queue
A13)."""

from .codec import LatentCodec
from .dc_ae import DCAE, DCAEConfig
from .distribution import DiagonalGaussian
from .image_vae import ImageVAE, ImageVAEConfig
from .stats import estimate_latent_stats
from .video_vae import VideoVAE, VideoVAEConfig

__all__ = ["DCAE", "DCAEConfig", "DiagonalGaussian", "ImageVAE", "ImageVAEConfig",
           "LatentCodec", "VideoVAE", "VideoVAEConfig", "estimate_latent_stats"]
