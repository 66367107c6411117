"""The video algorithms' recipes: DFoT_RE10K (pose) and K600 @DiT/XL (latent).

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
``experiment.tasks=[training]``. :func:`uvit3d_pose_base` is the same recipe
on the backbone at its own published widths (heads of 256 at level 3). :func:`k600_dit_xl` does the same for the
plain ``DFoTVideoAlgo`` on the Kinetics-600 latent recipe::

    python main.py +name=k600 dataset=kinetics_600 algorithm=dfot_video \
        experiment=video_generation @DiT/XL

a DiT3D in latent space (the VideoVAE that makes and decodes the latents is
not ported: the recipe's x is the (5, 16, 16, 16) latent window). ``build_model``
and the ``make_train_*`` functions take either recipe. Entry points that
build tensors take ``device=None``, which means the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from ..diffusion.core import DiffusionConfig, make_schedule, resolve_device
from ..guidance.history_guidance import HistoryGuidance
from ..models.dit import DiT3D, DiTSpec
from ..models.uvit import UViT3DPose, UViTSpec, precompute_pose_conditioning
from ..training.noise_levels import NoiseLevelConfig
from ..training.optim import make_optimizer
from ..training.state import TrainState, create_train_state
from ..training.trainer import make_train_step as _make_train_step
from ..utils.geometry import expand_pose_conditions

__all__ = [
    "Flagship", "DiTRecipe", "TrainRecipe", "flagship", "uvit3d_pose_base", "k600_dit_xl",
    "build_model",
    "sampling_cond_transform",
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


def uvit3d_pose_base() -> Flagship:
    """The flagship recipe (256 px, 8 frames, ray encodings, continuous
    v-prediction, 50 DDIM steps, vanilla HG at 4, the same training values)
    on UViT3DPose at the backbone's own published widths,
    ``configurations/algorithm/backbone/u_vit3d_pose.yaml`` without the
    RealEstate10K overlay: channels (128, 256, 512, 1024), 4 heads, (3, 3, 3)
    up/down blocks and 16 mid blocks, no checkpointing. Level 2 has heads of
    128 over 8192 tokens, level 3 heads of 256 over 2048."""
    fs = flagship()
    spec = dataclasses.replace(
        fs.spec, channels=(128, 256, 512, 1024), emb_channels=1024, patch_size=2,
        num_updown_blocks=(3, 3, 3), num_mid_blocks=16, num_heads=4,
        use_checkpointing=(False, False, False, False),
    )
    return fs._replace(spec=spec)


class DiTRecipe(NamedTuple):
    """A DiT3D recipe of the plain video algorithm, in the model's (latent)
    space: ``resolution`` (h, w) and ``x_channels`` are the token shape,
    ``max_tokens`` and ``n_context_tokens`` the window and its context in
    (latent) frames."""

    spec: DiTSpec
    dcfg: DiffusionConfig
    history_guidance: HistoryGuidance
    resolution: Tuple[int, int]
    x_channels: int
    max_tokens: int
    n_context_tokens: int
    external_cond_type: Optional[str]
    external_cond_dim: int
    external_cond_num_classes: Optional[int]
    external_cond_dropout: float
    use_fourier_noise_emb: bool
    train: TrainRecipe


def k600_dit_xl() -> DiTRecipe:
    """DiT3D XL (hidden 1152, depth 28, 16 heads of 72, patch 1, full 3D-RoPE
    attention over 5 x 16 x 16 = 1280 tokens, no MLP in its blocks: the recipe
    sets no ``spatial_mlp_ratio``), on Kinetics-600 VideoVAE latents: 17
    frames of 128 px -> (5, 16, 16, 16), 5 context frames -> 2 latent ones.
    Discrete cosine schedule, v-prediction, fused min-SNR weighting, 50 DDIM
    steps, conditional sampling (no guidance), unconditional in the label."""
    spec = DiTSpec(
        hidden_size=1152, depth=28, num_heads=16, mlp_ratio=4.0, spatial_mlp_ratio=None,
        variant="full", pos_emb_type="rope_3d", patch_size=1, max_temporal_length=5,
        use_gradient_checkpointing=True,
    )
    dcfg = DiffusionConfig(
        timesteps=1000,
        sampling_timesteps=50,
        objective="pred_v",
        beta_schedule="cosine",
        schedule_fn_kwargs=(("shift", 1.0),),
        loss_weighting_strategy="fused_min_snr",
        snr_clip=5.0,
        cum_snr_decay=0.96,
        sigmoid_bias=-1.0,
        ddim_sampling_eta=0.0,
        clip_noise=20.0,
        use_causal_mask=False,
        is_continuous=False,
        precond_scale=1.0,
        training_schedule_name="cosine",
        training_schedule_shift=1.0,
        reconstruction_guidance=0.0,
    )
    train = TrainRecipe(
        lr=2e-4, weight_decay=0.0, optimizer_beta=(0.9, 0.99),
        lr_scheduler="constant_with_warmup", num_warmup_steps=10000,
        num_training_steps=None, grad_clip=1.0, accumulate_steps=1, ema_decay=0.9999,
        precision="bf16", batch_size=16,
        noise_levels=NoiseLevelConfig(
            noise_level="random_independent", timesteps=dcfg.timesteps,
            is_continuous=dcfg.is_continuous, n_context_tokens=2,
        ),
    )
    return DiTRecipe(
        spec, dcfg, HistoryGuidance.conditional(timesteps=dcfg.timesteps),
        resolution=(16, 16), x_channels=16, max_tokens=5, n_context_tokens=2,
        external_cond_type=None, external_cond_dim=0, external_cond_num_classes=None,
        external_cond_dropout=0.0, use_fourier_noise_emb=False, train=train,
    )


Recipe = Union[Flagship, DiTRecipe]


def build_model(fs: Recipe, token_io: bool = True, device=None) -> torch.nn.Module:
    """The recipe's model (UViT3DPose, or DiT3D, which has no token layout of
    its own and ignores ``token_io``) with fp32 parameters on ``device``
    (None: the card); weights as constructed: load or fill them."""
    with torch.device(resolve_device(device)):
        if isinstance(fs, DiTRecipe):
            return DiT3D(
                fs.spec, fs.x_channels, fs.resolution, fs.external_cond_type,
                fs.external_cond_dim, fs.external_cond_num_classes, fs.external_cond_dropout,
                fs.use_fourier_noise_emb,
            )
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


def make_train_apply(fs: Recipe) -> Callable:
    """``model_apply(model, x, noise_levels, cond, cond_mask)`` of the train
    step: pose vectors to ray maps (the pose recipe; a DiT recipe's
    conditions go as they are), then the model. With the recipe's
    ``bf16`` precision the model runs under autocast: matmuls, convolutions
    and the attention kernels in bf16 over the fp32 master weights, norm
    statistics and the loss in fp32, as the JAX modules compute
    (``param_dtype`` fp32, ``dtype`` bf16)."""
    bf16 = fs.train.precision == "bf16"
    expand = (
        (lambda cond: cond) if isinstance(fs, DiTRecipe)
        else cond_transform(fs, torch.bfloat16 if bf16 else torch.float32)
    )

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


def make_train_state(fs: Recipe, model: Optional[torch.nn.Module] = None, device=None,
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


def make_train_step(fs: Recipe, device=None) -> Callable:
    """``train_step(state, batch, generator) -> (state, metrics)`` of the
    recipe; the batch lives on ``device`` (None: the card). ``conditions``
    are (B, T, 16) pose vectors for the pose recipe, absent for K600."""
    r = fs.train
    return _make_train_step(
        make_train_apply(fs), fs.dcfg, make_schedule(fs.dcfg, device), r.noise_levels,
        ema_decay=r.ema_decay, accumulate_steps=r.accumulate_steps,
    )
