"""The pose algorithm and the DFoT_RE10K flagship recipe.

Counterpart of ``dfot_tpu/algorithms/dfot_video.py``'s ``DFoTVideoPoseAlgo``:
the sampling side (``_sampling_cond_transform``: pose vectors -> ray maps ->
per-block pose FiLM terms, once per window) and the training side
(``_cond_transform``, ``_train_apply``, ``make_train_state``,
``make_train_step``), and of the README's RE10K command::

    python main.py +name=re10k dataset=realestate10k_mini \
        algorithm=dfot_video_pose experiment=video_generation \
        @diffusion/continuous experiment.tasks=[validation] \
        load=pretrained:DFoT_RE10K.ckpt \
        ++algorithm.tasks.prediction.history_guidance.name=vanilla \
        ++algorithm.tasks.prediction.history_guidance.guidance_scale=4.0

:func:`flagship` gives the values that command composes, in code (the
machine with the card has no YAML loader); a CPU test holds them equal to
``dfot_tpu.config``'s composition, the training values with
``experiment.tasks=[training]``. Entry points that build tensors take
``device=None``, which means the card.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..diffusion.core import DiffusionConfig, make_schedule, resolve_device
from ..guidance.history_guidance import HistoryGuidance
from ..models.uvit import UViT3DPose, UViTSpec, precompute_pose_conditioning
from ..training.noise_levels import NoiseLevelConfig
from ..training.optim import make_optimizer
from ..training.state import TrainState, create_train_state
from ..training.trainer import make_train_step as _make_train_step
from ..utils.geometry import expand_pose_conditions

__all__ = [
    "Flagship", "TrainRecipe", "flagship", "build_model", "sampling_cond_transform",
    "cond_transform", "make_train_apply", "make_train_state", "make_train_step",
]


class TrainRecipe(NamedTuple):
    """The training values the recipe composes (algorithm and experiment)."""

    lr: float
    weight_decay: float
    optimizer_beta: Tuple[float, float]
    lr_scheduler: str
    num_warmup_steps: int
    num_training_steps: Optional[int]
    grad_clip: float
    accumulate_steps: int
    ema_decay: float
    precision: str  # "bf16": bf16 compute over fp32 master weights
    batch_size: int
    noise_levels: NoiseLevelConfig


class Flagship(NamedTuple):
    spec: UViTSpec
    dcfg: DiffusionConfig
    history_guidance: HistoryGuidance
    resolution: int
    x_channels: int
    conditioning_type: str
    external_cond_dim: int
    use_fourier_noise_emb: bool
    external_cond_dropout: float
    train: TrainRecipe


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
    train = TrainRecipe(
        lr=5e-5, weight_decay=0.01, optimizer_beta=(0.9, 0.99),
        lr_scheduler="constant_with_warmup", num_warmup_steps=10000,
        num_training_steps=550000, grad_clip=1.0, accumulate_steps=1, ema_decay=0.9999,
        precision="bf16", batch_size=8,
        noise_levels=NoiseLevelConfig(
            noise_level="random_independent", timesteps=dcfg.timesteps,
            is_continuous=dcfg.is_continuous, n_context_tokens=4,
        ),
    )
    return Flagship(spec, dcfg, hg, resolution=256, x_channels=3,
                    conditioning_type="ray_encoding", external_cond_dim=180,
                    use_fourier_noise_emb=True, external_cond_dropout=0.1, train=train)


def build_model(fs: Flagship, token_io: bool = True, device=None) -> UViT3DPose:
    """The recipe's UViT3DPose with fp32 parameters on ``device`` (None: the
    card); weights as constructed: load or fill them."""
    with torch.device(resolve_device(device)):
        return UViT3DPose(
            fs.spec, fs.x_channels, fs.resolution, fs.external_cond_dim,
            use_fourier_noise_emb=fs.use_fourier_noise_emb, token_io=token_io,
            external_cond_dropout=fs.external_cond_dropout,
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


def cond_transform(fs: Flagship, dtype=torch.float32) -> Callable:
    """(B, T, 16) pose vectors -> the raw (B, T, H, W, Cp) ray maps the
    model's training path embeds, on the device of the vectors."""

    def expand(cond: torch.Tensor) -> torch.Tensor:
        return expand_pose_conditions(cond, fs.conditioning_type, fs.resolution).to(dtype)

    return expand


def make_train_apply(fs: Flagship) -> Callable:
    """``model_apply(model, x, noise_levels, cond, cond_mask)`` of the train
    step: pose vectors to ray maps, then the model. With the recipe's
    ``bf16`` precision the model runs under autocast: matmuls, convolutions
    and the attention kernels in bf16 over the fp32 master weights, norm
    statistics and the loss in fp32, as the JAX modules compute
    (``param_dtype`` fp32, ``dtype`` bf16)."""
    bf16 = fs.train.precision == "bf16"
    expand = cond_transform(fs, torch.bfloat16 if bf16 else torch.float32)

    def apply(model, x, noise_levels, cond, cond_mask):
        if cond is not None:
            cond = expand(cond)
        ctx = (
            torch.autocast(x.device.type, dtype=torch.bfloat16) if bf16
            else contextlib.nullcontext()
        )
        with ctx:
            return model(x, noise_levels, cond, cond_mask)

    return apply


def make_train_state(fs: Flagship, model: Optional[UViT3DPose] = None, device=None,
                     use_ema: bool = True) -> TrainState:
    """Train state of the recipe: the model (built on ``device`` if not
    given; None is the card) with fp32 master weights, AdamW with warm-up and
    global-norm clipping, and the EMA shadow."""
    if model is None:
        model = build_model(fs, token_io=False, device=device)
    r = fs.train
    opt = make_optimizer(
        model.parameters(), lr=r.lr, weight_decay=r.weight_decay, betas=r.optimizer_beta,
        grad_clip=r.grad_clip, lr_schedule_name=r.lr_scheduler,
        num_warmup_steps=r.num_warmup_steps, num_training_steps=r.num_training_steps,
        accumulate_steps=r.accumulate_steps,
    )
    return create_train_state(model, opt, use_ema=use_ema)


def make_train_step(fs: Flagship, device=None) -> Callable:
    """``train_step(state, batch, generator) -> (state, metrics)`` of the
    recipe; the batch lives on ``device`` (None: the card). ``conditions``
    are (B, T, 16) pose vectors."""
    r = fs.train
    return _make_train_step(
        make_train_apply(fs), fs.dcfg, make_schedule(fs.dcfg, device), r.noise_levels,
        ema_decay=r.ema_decay, accumulate_steps=r.accumulate_steps,
    )
