"""The pose algorithm's sampling side and the DFoT_RE10K flagship recipe.

Counterpart of ``dfot_tpu/algorithms/dfot_video.py``'s
``DFoTVideoPoseAlgo._sampling_cond_transform`` (pose vectors -> ray maps ->
per-block pose FiLM terms, once per window) and of the README's RE10K
command::

    python main.py +name=re10k dataset=realestate10k_mini \
        algorithm=dfot_video_pose experiment=video_generation \
        @diffusion/continuous experiment.tasks=[validation] \
        load=pretrained:DFoT_RE10K.ckpt \
        ++algorithm.tasks.prediction.history_guidance.name=vanilla \
        ++algorithm.tasks.prediction.history_guidance.guidance_scale=4.0

:func:`flagship` gives the values that command composes, in code (the
machine with the card has no YAML loader); a CPU test holds them equal to
``dfot_tpu.config``'s composition.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..diffusion.core import DiffusionConfig
from ..guidance.history_guidance import HistoryGuidance
from ..models.uvit import UViT3DPose, UViTSpec, precompute_pose_conditioning
from ..utils.geometry import expand_pose_conditions

__all__ = ["Flagship", "flagship", "build_model", "sampling_cond_transform"]


class Flagship(NamedTuple):
    spec: UViTSpec
    dcfg: DiffusionConfig
    history_guidance: HistoryGuidance
    resolution: int
    x_channels: int
    conditioning_type: str
    external_cond_dim: int
    use_fourier_noise_emb: bool


def flagship() -> Flagship:
    """UViT3DPose 467M, 256 px RealEstate10K, 180-channel ray encodings,
    continuous diffusion on the 0.125-shifted simple-diffusion cosine
    schedule, v-prediction, 50 DDIM steps, vanilla HG at scale 4."""
    spec = UViTSpec(
        channels=(128, 256, 576, 1152),
        emb_channels=1024,
        patch_size=2,
        block_types=("ResBlock", "ResBlock", "TransformerBlock", "TransformerBlock"),
        block_dropouts=(0.0, 0.0, 0.1, 0.1),
        num_updown_blocks=(3, 3, 6),
        num_mid_blocks=20,
        num_heads=9,
        pos_emb_type="rope",
        use_checkpointing=(False, False, False, True),
        max_temporal_length=8,
    )
    dcfg = DiffusionConfig(
        timesteps=1000,
        sampling_timesteps=50,
        objective="pred_v",
        beta_schedule="cosine_simple_diffusion",
        schedule_fn_kwargs=(("interpolated", False), ("shift", 1.0), ("shifted", 0.125)),
        loss_weighting_strategy="sigmoid",
        snr_clip=5.0,
        cum_snr_decay=0.9,
        sigmoid_bias=-1.0,
        ddim_sampling_eta=0.0,
        clip_noise=20.0,
        use_causal_mask=False,
        is_continuous=True,
        precond_scale=0.125,
        training_schedule_name="cosine",
        training_schedule_shift=0.125,
        reconstruction_guidance=0.0,
    )
    hg = HistoryGuidance.vanilla(guidance_scale=4.0, timesteps=dcfg.timesteps)
    return Flagship(spec, dcfg, hg, resolution=256, x_channels=3,
                    conditioning_type="ray_encoding", external_cond_dim=180,
                    use_fourier_noise_emb=True)


def build_model(fs: Flagship, token_io: bool = True) -> UViT3DPose:
    """The recipe's UViT3DPose (weights as constructed; load or fill them)."""
    return UViT3DPose(
        fs.spec, fs.x_channels, fs.resolution, fs.external_cond_dim,
        use_fourier_noise_emb=fs.use_fourier_noise_emb, token_io=token_io,
    )


def sampling_cond_transform(model: UViT3DPose, conditioning_type: str) -> Callable:
    """NFE-expanded (N, T, 16) pose vectors -> the precomputed pose
    conditioning the model reads: ray maps in the model's dtype, then every
    block's pose FiLM term, once per window."""
    dtype = model.embed_input.proj.weight.dtype

    def transform(cond: torch.Tensor) -> dict:
        maps = expand_pose_conditions(cond, conditioning_type, model.resolution).to(dtype)
        return precompute_pose_conditioning(model, maps)

    return transform
