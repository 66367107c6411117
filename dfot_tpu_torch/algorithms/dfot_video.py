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

:func:`flagship` gives the values that command composes, in code, for the
paths that build the model without a config; CPU tests hold them equal to
``dfot_tpu.config``'s composition (the training values with
``experiment.tasks=[training]``) and to what :func:`build_algorithm` builds. :func:`uvit3d_pose_base` is the same recipe
on the backbone at its own published widths (heads of 256 at level 3). :func:`k600_dit_xl` does the same for the
plain ``DFoTVideoAlgo`` on the Kinetics-600 latent recipe::

    python main.py +name=k600 dataset=kinetics_600 algorithm=dfot_video \
        experiment=video_generation @DiT/XL

a DiT3D in latent space (the VideoVAE that makes and decodes the latents is
not ported: the recipe's x is the (5, 16, 16, 16) latent window). ``build_model``
and the ``make_train_*`` functions take either recipe. Entry points that
build tensors take ``device=None``, which means the card.

:func:`build_algorithm` builds the algorithm from a composed config, as the
JAX package's does (``DFoTVideoAlgo`` and ``DFoTVideoPoseAlgo``): the
backbone, the diffusion schedule and the rollout with the configured
scheduling matrix, HG schemes and the token-layout state codec of the
U-ViTs; ``sample_videos`` runs the configured generation tasks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..diffusion.core import DiffusionConfig, make_schedule, resolve_device
from ..guidance.history_guidance import HistoryGuidance
from ..models.dit import DiT3D, DiT3DPose, DiTSpec
from ..models.dit1d import DiT1D, DiT1DSpec
from ..models.far import FARDiT, FARSpec
from ..models.unet3d import UNet3D, UNet3DSpec
from ..models.uvit import (
    UViT3D,
    UViT3DPose,
    UViTSpec,
    patchify_tokens,
    precompute_pose_conditioning,
    unpatchify_tokens,
)
from ..sampling import DFoTRollout, RolloutConfig
from ..training.noise_levels import NoiseLevelConfig
from ..training.optim import make_optimizer
from ..training.state import TrainState, create_train_state
from ..training.trainer import denoising_loss
from ..training.trainer import make_train_step as _make_train_step
from ..utils.geometry import (
    conditioning_dim,
    expand_pose_conditions,
    normalize_camera_conditions,
    process_camera_conditions,
)

__all__ = [
    "Flagship", "DiTRecipe", "TrainRecipe", "flagship", "uvit3d_pose_base", "k600_dit_xl",
    "build_model",
    "sampling_cond_transform",
    "cond_transform", "make_train_apply", "make_train_state", "make_train_step",
    "DFoTVideoAlgo", "DFoTVideoPoseAlgo", "build_algorithm",
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


def _new_train_state(model: torch.nn.Module, lr: float, weight_decay: float, betas,
                     grad_clip: float, lr_scheduler: str, num_warmup_steps: int,
                     num_training_steps: Optional[int], accumulate_steps: int) -> TrainState:
    """AdamW with warm-up and global-norm clipping over the model's fp32
    master weights, and the EMA shadow: the train state of a recipe and of
    a composed config alike."""
    opt = make_optimizer(
        model.parameters(), lr=lr, weight_decay=weight_decay, betas=betas,
        grad_clip=grad_clip, lr_schedule_name=lr_scheduler,
        num_warmup_steps=num_warmup_steps, num_training_steps=num_training_steps,
        accumulate_steps=accumulate_steps,
    )
    return create_train_state(model, opt, use_ema=True)


def make_train_state(fs: Recipe, model: Optional[torch.nn.Module] = None, device=None
                     ) -> TrainState:
    """Train state of the recipe: the model (built on ``device`` if not
    given; None is the card) with fp32 master weights, AdamW with warm-up and
    global-norm clipping, and the EMA shadow."""
    if model is None:
        model = build_model(fs, token_io=False, device=device)
    r = fs.train
    return _new_train_state(model, r.lr, r.weight_decay, r.optimizer_beta, r.grad_clip,
                            r.lr_scheduler, r.num_warmup_steps, r.num_training_steps,
                            r.accumulate_steps)


def make_train_step(fs: Recipe, device=None) -> Callable:
    """``train_step(state, batch, generator) -> (state, metrics)`` of the
    recipe; the batch lives on ``device`` (None: the card). ``conditions``
    are (B, T, 16) pose vectors for the pose recipe, absent for K600."""
    r = fs.train
    return _make_train_step(
        make_train_apply(fs), fs.dcfg, make_schedule(fs.dcfg, device), r.noise_levels,
        ema_decay=r.ema_decay, accumulate_steps=r.accumulate_steps,
    )


# ---------------------------------------------------------------------------
# the algorithm built from a composed config
# ---------------------------------------------------------------------------

FRESH_INIT_SEED = 0  # the weights a run validates without a checkpoint


class DFoTVideoAlgo:
    """Diffusion Forcing Transformer for video generation, from the
    ``algorithm`` config node (``dfot_tpu/algorithms/dfot_video.py:39``).

    The model holds fp32 weights on ``device`` (None: the card), built under
    ``torch.manual_seed(FRESH_INIT_SEED)`` (PyTorch's own initializers: the numbers
    differ from the JAX package's fresh init) and replaced when a
    checkpoint is loaded. With ``compute_dtype`` bf16 (the default, as in
    JAX) the sampler runs the model and the pose conditioning under
    autocast: bf16 matmuls, convolutions and attention kernels over the fp32
    weights, as the JAX modules compute (``param_dtype`` fp32, ``dtype``
    bf16); the sampler's own arithmetic stays fp32. A latent config builds
    the model in latent space; making and decoding the latents is the
    experiment's (A13).
    """

    def __init__(self, cfg, compute_dtype=torch.bfloat16, device=None):
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)

        # ---- frame/token bookkeeping -------------------------------------
        latent = cfg.latent
        self.is_latent = bool(latent.enabled)
        self.temporal_downsampling = latent.downsampling_factor[0] if self.is_latent else 1
        c, h, w = cfg.x_shape
        if self.is_latent:
            ds = latent.downsampling_factor[1]
            c = latent.num_channels
            h, w = h // ds, w // ds
        self.x_shape = (h, w, c)  # channel-last token shape
        self.max_tokens = self._frames_to_tokens(cfg.max_frames)
        self.n_context_tokens = (
            self._frames_to_tokens(cfg.context_frames) if cfg.context_frames else 0)

        # data normalization buffers (channel-last, (1, 1, C))
        self.data_mean = self._stat(cfg.get("data_mean"))
        self.data_std = self._stat(cfg.get("data_std"))

        # ---- diffusion -----------------------------------------------------
        self.dcfg = DiffusionConfig.from_config(cfg.diffusion)
        self.sched = make_schedule(self.dcfg, self.device)

        # ---- backbone ------------------------------------------------------
        # U-ViTs sample in their patch-token layout: the pixel <-> patch
        # transpose runs once per window instead of once per step
        p = cfg.backbone.get("patch_size")
        self._state_codec = None
        if cfg.backbone.name in ("u_vit3d", "u_vit3d_pose") and h == w and h % p == 0:
            self._state_codec = (lambda x: patchify_tokens(x, p),
                                 lambda x: unpatchify_tokens(x, p, h, w))
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(FRESH_INIT_SEED)
            self.model = self._build_backbone(token_io=self._state_codec is not None).eval()

        # ---- rollout -------------------------------------------------------
        pred, interp = cfg.tasks.prediction, cfg.tasks.interpolation
        self.rollout_cfg = RolloutConfig(
            max_tokens=self.max_tokens,
            x_shape=self.x_shape,
            scheduling_matrix=cfg.scheduling_matrix,
            is_full_sequence=self.is_full_sequence,
            chunk_size=cfg.chunk_size,
            use_causal_mask=self.dcfg.use_causal_mask,
            external_cond_type=cfg.get("external_cond_type"),
            sliding_context_len=pred.get("sliding_context_len"),
            keyframe_density=pred.get("keyframe_density"),
            interpolation_max_batch_size=interp.get("max_batch_size"),
            scan_bucket=cfg.get("scan_bucket", 0) or 0,
            cond_transform=self._autocast(self._sampling_cond_transform()),
            state_codec=self._state_codec,
            refinement=(
                dict(cfg.refinement_sampling.to_dict())
                if cfg.refinement_sampling.enabled else None
            ),
        )
        self.rollout = DFoTRollout(self.rollout_cfg, self.dcfg, self.sched,
                                   self._autocast(self.model))
        self.prediction_hg = HistoryGuidance.from_config(
            pred.history_guidance, timesteps=self.dcfg.timesteps)
        self.interpolation_hg = HistoryGuidance.from_config(
            interp.history_guidance, timesteps=self.dcfg.timesteps)

        # ---- training ------------------------------------------------------
        self.nl_cfg = NoiseLevelConfig.from_config(cfg, self.dcfg.timesteps,
                                                   self.n_context_tokens)

    def set_sampling_mesh(self, mesh) -> None:
        """Split the NFE-expanded sampling batch over ``mesh``'s data axis
        (``sampling/sampler.py``; None: one process evaluates every row)."""
        self.rollout_cfg = dataclasses.replace(self.rollout_cfg, mesh=mesh)
        self.rollout = DFoTRollout(self.rollout_cfg, self.dcfg, self.sched,
                                   self._autocast(self.model))

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------
    def _frames_to_tokens(self, n_frames: int) -> int:
        return (n_frames - 1) // self.temporal_downsampling + 1

    @property
    def is_full_sequence(self) -> bool:
        """Full-sequence baseline: uniform noise + full_sequence matrix
        (context is re-noised rather than pinned)."""
        return (
            self.cfg.noise_level == "random_uniform"
            and self.cfg.scheduling_matrix == "full_sequence"
            and not self.cfg.fixed_context.enabled
            and not self.cfg.variable_context.enabled
        )

    def _stat(self, value) -> Optional[torch.Tensor]:
        """A normalization statistic as a (1, 1, C) fp32 tensor: from the
        config's (C, 1, 1) list, or from the ``.npy`` file a string names
        (None when the file is absent)."""
        if value is None:
            return None
        if isinstance(value, str):
            if not os.path.exists(value):
                return None
            arr = np.load(value).astype(np.float32).reshape(1, 1, -1)
        else:
            arr = np.asarray(value, dtype=np.float32)
            if arr.ndim == 3:
                arr = arr.transpose(1, 2, 0)
        return torch.as_tensor(arr, device=self.device)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        if self.data_mean is None:
            return x
        return (x - self.data_mean) / self.data_std

    def unnormalize(self, x: torch.Tensor) -> torch.Tensor:
        if self.data_mean is None:
            return x
        return x * self.data_std + self.data_mean

    # ------------------------------------------------------------------
    # backbone
    # ------------------------------------------------------------------
    def _build_backbone(self, token_io: bool) -> torch.nn.Module:
        """The configured backbone with fp32 weights on the algorithm's
        device (``dfot_tpu/algorithms/dfot_video.py:187``)."""
        cfg, bcfg = self.cfg, self.cfg.backbone
        name = bcfg.name
        h, w, c = self.x_shape
        dropout = bcfg.get("external_cond_dropout", 0.0)
        fourier = bcfg.get("use_fourier_noise_embedding", False)
        cond = (cfg.get("external_cond_type"), cfg.get("external_cond_dim") or 0,
                cfg.get("external_cond_num_classes"), dropout, fourier)
        with torch.device(self.device):
            if name == "u_net3d":
                return UNet3D(UNet3DSpec.from_config(bcfg, self.max_tokens), c, h,
                              self.dcfg.use_causal_mask, *cond)
            if name == "far_dit":
                return FARDiT(FARSpec.from_config(bcfg, self.max_tokens), c, (h, w), *cond)
            if name == "dit1d":
                # x_shape (C, 1, N): N tokens a frame
                return DiT1D(DiT1DSpec.from_config(bcfg, self.max_tokens), c, w, *cond)
            if name in ("dit3d", "dit3d_pose", "difference_dit3d"):
                spec = DiTSpec.from_config(bcfg, self.max_tokens, self.dcfg.use_causal_mask)
                if name == "dit3d_pose":
                    cond_cfg = bcfg.get("conditioning")
                    ctype = "film" if cond_cfg is None else cond_cfg.get("type", "film")
                    return DiT3DPose(
                        spec, c, (h, w), conditioning_dim(cfg.camera_pose_conditioning.type),
                        conditioning_type=ctype, external_cond_dropout=dropout,
                        use_fourier_noise_emb=fourier,
                    )
                return DiT3D(spec, c, (h, w), *cond)
            if name in ("u_vit3d", "u_vit3d_pose"):
                spec = UViTSpec.from_config(bcfg, self.max_tokens)
                if name == "u_vit3d_pose":
                    return UViT3DPose(
                        spec, c, h, conditioning_dim(cfg.camera_pose_conditioning.type),
                        use_fourier_noise_emb=fourier, token_io=token_io,
                        external_cond_dropout=dropout,
                    )
                # the U-ViT has no label table: labels, like actions, are
                # vectors of external_cond_dim (dfot_tpu/algorithms/dfot_video.py:276)
                return UViT3D(spec, c, h, use_fourier_noise_emb=fourier, token_io=token_io,
                              external_cond_dim=cfg.get("external_cond_dim") or 0,
                              external_cond_dropout=dropout)
        raise NotImplementedError(f"backbone {name!r} is not available")

    def _autocast(self, fn: Optional[Callable]) -> Optional[Callable]:
        """``fn`` run under autocast to ``compute_dtype`` (as it is, in fp32)."""
        if fn is None or self.compute_dtype == torch.float32:
            return fn

        def run(*args):
            with torch.autocast(self.device.type, dtype=self.compute_dtype):
                return fn(*args)

        return run

    def _sampling_cond_transform(self) -> Optional[Callable]:
        """Map of the NFE-expanded conditions, once per window (the pose
        algorithm's ray maps and pose FiLM terms); none here."""
        return None

    # ------------------------------------------------------------------
    # conditions
    # ------------------------------------------------------------------
    def process_conditions(self, conditions):
        """Host condition preprocessing: identity here."""
        return conditions

    # ------------------------------------------------------------------
    # training (``dfot_tpu/algorithms/dfot_video.py:364-445``)
    # ------------------------------------------------------------------
    def _cond_transform(self) -> Optional[Callable]:
        """Expansion of a batch's (B, T, .) conditions inside the train step
        and the eval denoiser (the pose algorithm's ray maps); none here."""
        return None

    def _train_apply(self, model, x, noise_levels, cond, cond_mask):
        """The denoiser on the pixel layout (B, T, H, W, C) the loss is taken
        on: conditions expanded, the U-ViT's token layout around the model
        (a pure permutation: the same numbers as a pixel-layout model), the
        model under autocast to ``compute_dtype``; fp32 out."""
        ct = self._cond_transform()
        if cond is not None and ct is not None:
            cond = ct(cond)
        if self._state_codec is not None:
            x = self._state_codec[0](x)
        if self.compute_dtype == torch.float32:
            out = model(x, noise_levels, cond, cond_mask)
        else:
            with torch.autocast(x.device.type, dtype=self.compute_dtype):
                out = model(x, noise_levels, cond, cond_mask)
        if self._state_codec is not None:
            out = self._state_codec[1](out)
        return out.float()

    def make_train_state(self, accumulate_steps: int = 1,
                         num_training_steps: Optional[int] = None,
                         grad_clip: float = 1.0) -> TrainState:
        """Train state over the algorithm's model (its weights as they are),
        the optimizer the ``algorithm`` node configures."""
        c = self.cfg
        return _new_train_state(
            self.model, c.lr, c.weight_decay, tuple(c.optimizer_beta), grad_clip,
            c.lr_scheduler.name, c.lr_scheduler.num_warmup_steps,
            c.lr_scheduler.get("num_training_steps", num_training_steps), accumulate_steps)

    def make_train_step(self, ema_decay: float = 0.9999, accumulate_steps: int = 1,
                        rows=None, grad_sync: Optional[Callable] = None) -> Callable:
        """``train_step(state, batch, generator) -> (state, metrics)``, batch
        {"xs": normalized (B, T, H, W, C), "masks", "conditions"} on the
        device; ``rows`` and ``grad_sync`` as ``training.trainer.make_train_step``
        takes them (a data-parallel process's share)."""
        return _make_train_step(self._train_apply, self.dcfg, self.sched, self.nl_cfg,
                                ema_decay, accumulate_steps=accumulate_steps, rows=rows,
                                grad_sync=grad_sync)

    def make_eval_denoise(self) -> Callable:
        """``eval_denoise(batch, generator) -> (masked mean loss, x0
        reconstruction)`` on the model's current weights (the caller swaps
        the EMA in): noise levels without context dropout, no dropout, no
        gradients. The draws can be injected (``noise_levels``, ``noise``);
        ``rows``: the batch is a data-parallel share (``training.trainer``)."""

        @torch.no_grad()
        def eval_denoise(batch: Dict, generator: Optional[torch.Generator], *,
                         noise_levels=None, noise=None, rows=None):
            self.model.eval()
            return denoising_loss(
                self._train_apply, self.dcfg, self.sched, self.nl_cfg, self.model, batch["xs"],
                batch.get("conditions"), batch["masks"], generator, False, noise_levels, noise,
                rows)

        return eval_denoise

    def make_eval_loss(self) -> Callable:
        """The eval denoiser's loss alone."""
        eval_denoise = self.make_eval_denoise()
        return lambda batch, generator, **draws: eval_denoise(batch, generator, **draws)[0]

    # ------------------------------------------------------------------
    # sampling (validation / generation)
    # ------------------------------------------------------------------
    def sample_videos(
        self,
        generator: Optional[torch.Generator],
        xs: torch.Tensor,  # (B, T, h, w, c) normalized tokens
        conditions=None,
        tasks: Optional[Tuple[str, ...]] = None,
        n_context_tokens: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """Run the configured generation tasks: ``{"gt": xs, task: video}``,
        fp32 on the device. The JAX call's ``(params, rng, ...)`` becomes
        ``(generator, ...)``: the model holds its weights and every task
        draws from ``generator`` in turn."""
        if tasks is None:
            tasks = tuple(t for t in ("prediction", "interpolation") if self.cfg.tasks[t].enabled)
        nct = self.n_context_tokens if n_context_tokens is None else n_context_tokens
        self.model.eval()
        conds = self.process_conditions(conditions)
        if conds is not None:
            conds = torch.as_tensor(np.asarray(conds), device=self.device)
        out: Dict[str, torch.Tensor] = {"gt": xs}
        for task in tasks:
            if task == "prediction":
                out[task] = self.rollout.predict_videos(
                    generator, xs, nct, conds,
                    prediction_hg=self.prediction_hg, interpolation_hg=self.interpolation_hg,
                )
            elif task == "interpolation":
                out[task] = self.rollout.interpolate_videos(
                    generator, xs, None, conds, history_guidance=self.interpolation_hg)
            else:
                raise ValueError(f"unknown task {task}")
        return out


class DFoTVideoPoseAlgo(DFoTVideoAlgo):
    """Camera-pose conditioned DFoT (``dfot_tpu/algorithms/dfot_video.py:512``)."""

    def __init__(self, cfg, compute_dtype=torch.bfloat16, device=None):
        if cfg.backbone.name not in ("dit3d_pose", "u_vit3d_pose"):
            raise ValueError(
                f"pose-conditioned DFoT requires a pose backbone, got {cfg.backbone.name}")
        super().__init__(cfg, compute_dtype, device)

    def process_conditions(self, conditions):
        """Raw (B, T, 16) camera vectors -> the normalized vectors the
        device expands (ray formats), or the (B, T, 12) global extrinsics;
        fp32 numpy on the host."""
        if conditions is None:
            return None
        cpc = self.cfg.camera_pose_conditioning
        raw = np.asarray(conditions, dtype=np.float32)
        if cpc.type == "global":
            return process_camera_conditions(
                raw, conditioning_type="global", normalize_by=cpc.normalize_by,
                bound=cpc.get("bound"),
            )
        return normalize_camera_conditions(raw, normalize_by=cpc.normalize_by,
                                           bound=cpc.get("bound"))

    def _pose_resolution(self) -> int:
        return self.cfg.x_shape[1] if not self.is_latent else self.x_shape[0]

    def _cond_transform(self) -> Optional[Callable]:
        """Normalized (B, T, 16) pose vectors -> ray maps in the compute
        dtype, on the device (the global conditioning goes as it is)."""
        cpc = self.cfg.camera_pose_conditioning
        if cpc.type == "global":
            return None
        ctype, res, dtype = cpc.type, self._pose_resolution(), self.compute_dtype
        return lambda cond: expand_pose_conditions(cond, ctype, res).to(dtype)

    def _sampling_cond_transform(self) -> Optional[Callable]:
        cpc = self.cfg.camera_pose_conditioning
        if cpc.type == "global":
            return None
        if isinstance(self.model, UViT3DPose):
            return sampling_cond_transform(self.model, cpc.type)
        ctype, res = cpc.type, self._pose_resolution()
        return lambda cond: expand_pose_conditions(cond, ctype, res)


def build_algorithm(cfg, compute_dtype=torch.bfloat16, device=None):
    """The algorithm a composed config names, on ``device`` (None: the card)."""
    name = cfg.algorithm.get("_name", "dfot_video")
    # "sd_video*" are the standard-diffusion baselines: the same classes
    # with full-sequence noise and fixed context
    if name in ("dfot_video", "gibbs_dfot_video", "sd_video"):
        return DFoTVideoAlgo(cfg.algorithm, compute_dtype, device)
    if name in ("dfot_video_pose", "sd_video_3d"):
        return DFoTVideoPoseAlgo(cfg.algorithm, compute_dtype, device)
    if name == "difference_dfot_video":
        from .difference_dfot import DifferenceDFoTVideoAlgo

        return DifferenceDFoTVideoAlgo(cfg.algorithm, compute_dtype, device)
    raise NotImplementedError(f"algorithm {name!r} is not available")
