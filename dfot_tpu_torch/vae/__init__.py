"""The VAEs (``dfot_tpu/vae``): the DC-AE, the per-frame ImageVAE and its
diffusers kl-f8 alias AutoencoderKL, the causal VideoVAE, TiTok-KL, their
diagonal-Gaussian posterior, the algorithm-facing ``LatentCodec``, the
latent statistics and the training losses."""

from .autoencoder_kl import KL_F8_CONFIG, AutoencoderKL, diffusers_state_dict
from .codec import LatentCodec
from .dc_ae import DCAE, DCAEConfig
from .distribution import DiagonalGaussian
from .image_vae import ImageVAE, ImageVAEConfig
from .losses import (
    LPIPS,
    NLayerDiscriminator,
    adopt_weight,
    calculate_adaptive_weight,
    decoder_last_layer,
    hinge_d_loss,
    lpips_state_dict,
    vae_discriminator_loss,
    vae_generator_loss,
    vanilla_d_loss,
)
from .stats import estimate_latent_stats
from .titok import TiTokConfig, TiTokKL
from .video_vae import VideoVAE, VideoVAEConfig

__all__ = ["AutoencoderKL", "DCAE", "DCAEConfig", "DiagonalGaussian", "ImageVAE", "ImageVAEConfig",
           "KL_F8_CONFIG", "LPIPS", "LatentCodec", "NLayerDiscriminator", "TiTokConfig",
           "TiTokKL", "VideoVAE", "VideoVAEConfig", "adopt_weight", "calculate_adaptive_weight",
           "decoder_last_layer", "diffusers_state_dict", "estimate_latent_stats", "hinge_d_loss",
           "lpips_state_dict", "vae_discriminator_loss", "vae_generator_loss", "vanilla_d_loss"]
