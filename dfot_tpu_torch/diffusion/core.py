"""Discrete-time diffusion math with per-token noise levels, on tensors.

Port of ``dfot_tpu/diffusion/core.py``, sampling and training side. The
noise level ``k`` is an integer tensor of shape (B, T): every token (frame)
has its own diffusion time. Schedule buffers are fp32 tensors on one
device; random draws take an explicit ``torch.Generator``. Functions that
make tensors from nothing take ``device=None``, which means the card
(``"cuda"``); the CPU only when the caller says ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .schedules import make_beta_schedule

__all__ = [
    "DiffusionConfig",
    "Schedule",
    "ModelPrediction",
    "make_schedule",
    "bcast_right",
    "clipped_normal",
    "q_sample",
    "q_sample_from_x_k",
    "model_predictions",
    "ddim_step",
    "ddpm_step",
    "predict_v",
    "compute_loss_weights",
    "training_targets",
    "training_loss",
    "ddim_idx_to_noise_level",
    "estimate_noise_level",
]

CARD = "cuda"  # what ``device=None`` means


def resolve_device(device=None) -> torch.device:
    """``None`` is the card; anything else is taken as given."""
    return torch.device(CARD if device is None else device)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Diffusion hyperparameters (field for field the JAX package's)."""

    timesteps: int = 1000
    sampling_timesteps: int = 50
    objective: str = "pred_v"  # pred_noise | pred_x0 | pred_v
    beta_schedule: str = "cosine"
    schedule_fn_kwargs: Tuple[Tuple[str, object], ...] = ()
    loss_weighting_strategy: str = "fused_min_snr"
    snr_clip: float = 5.0
    cum_snr_decay: float = 0.9
    sigmoid_bias: float = -1.0
    ddim_sampling_eta: float = 0.0
    clip_noise: float = 20.0
    use_causal_mask: bool = False
    is_continuous: bool = False
    precond_scale: float = 1.0
    training_schedule_name: str = "cosine"
    training_schedule_shift: float = 1.0
    logsnr_min: float = -15.0
    logsnr_max: float = 15.0
    reconstruction_guidance: float = 0.0

    @property
    def is_ddim_sampling(self) -> bool:
        return self.sampling_timesteps < self.timesteps

    @classmethod
    def from_config(cls, cfg) -> "DiffusionConfig":
        """From the ``algorithm.diffusion`` config node."""
        lw = cfg.loss_weighting
        ts = cfg.get("training_schedule")
        return cls(
            timesteps=cfg.timesteps,
            sampling_timesteps=cfg.sampling_timesteps,
            objective=cfg.objective,
            beta_schedule=cfg.beta_schedule,
            schedule_fn_kwargs=tuple(sorted(cfg.schedule_fn_kwargs.to_dict().items())),
            loss_weighting_strategy=lw.strategy,
            snr_clip=lw.get("snr_clip", 5.0),
            cum_snr_decay=lw.get("cum_snr_decay", 0.9),
            sigmoid_bias=lw.get("sigmoid_bias", -1.0),
            ddim_sampling_eta=cfg.ddim_sampling_eta,
            clip_noise=cfg.clip_noise,
            use_causal_mask=cfg.use_causal_mask,
            is_continuous=cfg.get("is_continuous", False),
            precond_scale=cfg.get("precond_scale", 1.0),
            training_schedule_name=(ts.name if ts is not None else "cosine"),
            training_schedule_shift=(ts.get("shift", 1.0) if ts is not None else 1.0),
            logsnr_min=(ts.get("logsnr_min", -15.0) if ts is not None else -15.0),
            logsnr_max=(ts.get("logsnr_max", 15.0) if ts is not None else 15.0),
            reconstruction_guidance=cfg.get("reconstruction_guidance", 0.0),
        )


class Schedule(NamedTuple):
    """fp32 schedule buffers, each (timesteps,), on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    snr: torch.Tensor
    logsnr: torch.Tensor
    clipped_snr: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.betas.device


class ModelPrediction(NamedTuple):
    pred_noise: torch.Tensor
    pred_x_start: torch.Tensor
    model_out: torch.Tensor


def make_schedule(cfg: DiffusionConfig, device=None) -> Schedule:
    """All schedule buffers, computed in float64 on the host and cast once,
    on ``device`` (None: the card)."""
    device = resolve_device(device)
    betas = make_beta_schedule(
        schedule=cfg.beta_schedule,
        timesteps=cfg.timesteps,
        zero_terminal_snr=cfg.objective != "pred_noise",
        **dict(cfg.schedule_fn_kwargs),
    )
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.concatenate([[1.0], ac[:-1]])
    with np.errstate(divide="ignore"):
        posterior_variance = betas * (1.0 - ac_prev) / (1.0 - ac)
        snr = ac / (1.0 - ac)
        buffers = dict(
            betas=betas,
            alphas_cumprod=ac,
            alphas_cumprod_prev=ac_prev,
            sqrt_alphas_cumprod=np.sqrt(ac),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - ac),
            log_one_minus_alphas_cumprod=np.log(1.0 - ac),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / ac),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / ac - 1.0),
            posterior_variance=posterior_variance,
            posterior_log_variance_clipped=np.log(np.clip(posterior_variance, 1e-20, None)),
            posterior_mean_coef1=betas * np.sqrt(ac_prev) / (1.0 - ac),
            posterior_mean_coef2=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
            snr=snr,
            logsnr=np.log(snr),
            clipped_snr=np.clip(snr, None, cfg.snr_clip),
        )
    return Schedule(**{
        k: torch.as_tensor(v.astype(np.float32), device=device) for k, v in buffers.items()
    })


def bcast_right(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append trailing singleton dims until ``a.ndim == ndim``."""
    return a.reshape(a.shape + (1,) * (ndim - a.ndim))


def _gather(buf: torch.Tensor, k: torch.Tensor, ndim: int) -> torch.Tensor:
    return bcast_right(buf[k.long()], ndim)


def clipped_normal(
    shape, clip: float, generator: Optional[torch.Generator] = None,
    device=None, dtype=torch.float32,
) -> torch.Tensor:
    """Standard normal noise clipped to +-clip (the reference's convention),
    on ``device`` (None: the card)."""
    x = torch.randn(shape, generator=generator, device=resolve_device(device), dtype=dtype)
    return x.clamp_(-clip, clip)


def q_sample(sched: Schedule, x_start, k, noise):
    """Diffuse x_0 to noise level k: sqrt(ac_k) x_0 + sqrt(1 - ac_k) eps."""
    n = x_start.ndim
    return (
        _gather(sched.sqrt_alphas_cumprod, k, n) * x_start
        + _gather(sched.sqrt_one_minus_alphas_cumprod, k, n) * noise
    )


def q_sample_from_x_k(sched: Schedule, timesteps: int, x_k, cur_k, next_k, noise):
    """Re-noise x_k from level cur_k up to next_k (go-back sampling)."""
    n = x_k.ndim
    scale = _gather(sched.alphas_cumprod, next_k, n) / _gather(sched.alphas_cumprod, cur_k, n)
    scale = torch.where(bcast_right(next_k, n) == timesteps - 1, 1.0, scale)
    return scale.sqrt() * x_k + (1.0 - scale).clamp(min=0.0).sqrt() * noise


def predict_start_from_noise(sched, x_k, k, noise):
    n = x_k.ndim
    return (
        _gather(sched.sqrt_recip_alphas_cumprod, k, n) * x_k
        - _gather(sched.sqrt_recipm1_alphas_cumprod, k, n) * noise
    )


def predict_noise_from_start(sched, x_k, k, x0):
    n = x_k.ndim
    return (x_k - _gather(sched.sqrt_alphas_cumprod, k, n) * x0) / _gather(
        sched.sqrt_one_minus_alphas_cumprod, k, n
    )


def predict_v(sched, x_start, k, noise):
    n = x_start.ndim
    return (
        _gather(sched.sqrt_alphas_cumprod, k, n) * noise
        - _gather(sched.sqrt_one_minus_alphas_cumprod, k, n) * x_start
    )


def predict_start_from_v(sched, x_k, k, v):
    n = x_k.ndim
    return (
        _gather(sched.sqrt_alphas_cumprod, k, n) * x_k
        - _gather(sched.sqrt_one_minus_alphas_cumprod, k, n) * v
    )


def predict_noise_from_v(sched, x_k, k, v):
    n = x_k.ndim
    return (
        _gather(sched.sqrt_alphas_cumprod, k, n) * v
        + _gather(sched.sqrt_one_minus_alphas_cumprod, k, n) * x_k
    )


def model_predictions(sched: Schedule, cfg: DiffusionConfig, x, k, model_out) -> ModelPrediction:
    """Convert a raw network output into (eps, x0) under cfg.objective."""
    if cfg.objective == "pred_noise":
        pred_noise = model_out.clamp(-cfg.clip_noise, cfg.clip_noise)
        x_start = predict_start_from_noise(sched, x, k, pred_noise)
    elif cfg.objective == "pred_x0":
        x_start = model_out
        pred_noise = predict_noise_from_start(sched, x, k, x_start)
    elif cfg.objective == "pred_v":
        x_start = predict_start_from_v(sched, x, k, model_out)
        pred_noise = predict_noise_from_v(sched, x, k, model_out)
    else:
        raise ValueError(f"unknown objective {cfg.objective}")
    return ModelPrediction(pred_noise, x_start, model_out)


def ddim_step(sched: Schedule, cfg: DiffusionConfig, x, curr_k, next_k,
              pred: ModelPrediction, noise):
    """One DDIM update with per-token (curr_k -> next_k) levels. Tokens with
    curr_k == next_k are left untouched; next_k < 0 means fully denoised."""
    n = x.ndim
    alpha = _gather(sched.alphas_cumprod, curr_k.clamp(min=0), n)
    next_lt0 = bcast_right(next_k < 0, n)
    alpha_next = torch.where(
        next_lt0, 1.0, _gather(sched.alphas_cumprod, next_k.clamp(min=0), n)
    )
    sigma = torch.where(
        next_lt0,
        0.0,
        cfg.ddim_sampling_eta * (
            (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha)
        ).clamp(min=0.0).sqrt(),
    )
    c = (1.0 - alpha_next - sigma**2).clamp(min=0.0).sqrt()
    x_pred = pred.pred_x_start * alpha_next.sqrt() + pred.pred_noise * c + sigma * noise
    return torch.where(bcast_right(curr_k == next_k, n), x, x_pred)


def ddpm_step(sched: Schedule, cfg: DiffusionConfig, x, curr_k, pred: ModelPrediction, noise):
    """One ancestral (DDPM) update; tokens at curr_k == -1 are frozen."""
    n = x.ndim
    kc = curr_k.clamp(min=0)
    mean = (
        _gather(sched.posterior_mean_coef1, kc, n) * pred.pred_x_start
        + _gather(sched.posterior_mean_coef2, kc, n) * x
    )
    log_var = _gather(sched.posterior_log_variance_clipped, kc, n)
    noise = torch.where(bcast_right(kc > 0, n), noise, 0.0)
    x_pred = mean + torch.exp(0.5 * log_var) * noise
    return torch.where(bcast_right(curr_k == -1, n), x, x_pred)


def _shifted_ema(seq: torch.Tensor, decay: float) -> torch.Tensor:
    """Exponential moving average along T of a (B, T) sequence, shifted right
    by one with a zero in front (the loss at t sees the cumulated SNR of < t)."""
    cum = [seq[:, 0]]
    for t in range(1, seq.shape[1]):
        cum.append(decay * cum[-1] + (1 - decay) * seq[:, t])
    cum = torch.stack(cum, dim=1)
    return torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], dim=1)


def compute_loss_weights(sched: Schedule, cfg: DiffusionConfig, k: torch.Tensor) -> torch.Tensor:
    """Per-token loss weights, fp32; ``k`` has shape (B, T).

    Strategies: ``uniform``; ``sigmoid`` (sigmoid(bias - logsnr)); ``min_snr``;
    ``fused_min_snr`` (Diffusion Forcing v1 cumulative SNR along T,
    bidirectional for non-causal models).
    """
    strategy = cfg.loss_weighting_strategy
    if strategy == "uniform":
        return torch.ones(k.shape, dtype=torch.float32, device=k.device)
    k = k.long()
    snr = sched.snr[k]
    if strategy == "sigmoid":
        eps_w = torch.sigmoid(cfg.sigmoid_bias - sched.logsnr[k])
    elif strategy == "min_snr":
        eps_w = sched.clipped_snr[k] / snr.clamp(min=1e-8)
    elif strategy == "fused_min_snr":
        norm_clipped = sched.clipped_snr[k] / cfg.snr_clip
        norm_snr = snr / cfg.snr_clip
        decay = cfg.cum_snr_decay
        cum_snr = _shifted_ema(norm_clipped, decay)
        if not cfg.use_causal_mask:
            bwd = _shifted_ema(norm_clipped.flip(1), decay).flip(1)
            cum_snr = 0.5 * (cum_snr + bwd)
        clipped = (1 - (1 - cum_snr * decay) * (1 - norm_clipped)) * cfg.snr_clip
        snr = (1 - (1 - cum_snr * decay) * (1 - norm_snr)) * cfg.snr_clip
        eps_w = clipped / snr.clamp(min=1e-8)
    else:
        raise ValueError(f"unknown loss weighting strategy {strategy}")
    if cfg.objective == "pred_noise":
        return eps_w
    if cfg.objective == "pred_x0":
        return eps_w * snr
    if cfg.objective == "pred_v":
        return eps_w * snr / (snr + 1)
    raise ValueError(f"unknown objective {cfg.objective}")


def training_targets(sched: Schedule, cfg: DiffusionConfig, x, k, noise):
    """(noised x, target) for the configured objective."""
    noised = q_sample(sched, x, k, noise)
    if cfg.objective == "pred_noise":
        target = noise
    elif cfg.objective == "pred_x0":
        target = x
    elif cfg.objective == "pred_v":
        target = predict_v(sched, x, k, noise)
    else:
        raise ValueError(f"unknown objective {cfg.objective}")
    return noised, target


def training_loss(sched: Schedule, cfg: DiffusionConfig, model_out, target, k) -> torch.Tensor:
    """Elementwise weighted MSE, no reduction: the caller applies the frame
    mask and reduces. No gradient flows into the target."""
    loss = (model_out - target.detach()) ** 2
    w = compute_loss_weights(sched, cfg, k)
    return loss * bcast_right(w, loss.ndim)


def ddim_idx_to_noise_level(timesteps: int, sampling_timesteps: int, indices) -> np.ndarray:
    """Map DDIM grid indices (0..sampling_timesteps) to raw noise levels
    (-1..timesteps-1), host numpy."""
    real_steps = np.linspace(-1, timesteps - 1, sampling_timesteps + 1)
    real_steps = real_steps.astype(np.int64)  # truncation toward zero
    return real_steps[np.asarray(indices)]


def estimate_noise_level(sched: Schedule, x: torch.Tensor,
                         mu: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Maximum-likelihood noise level of each token of x (B, T, ...), as
    an int64 (B, T) tensor: the level whose noise variance best explains
    the token's mean square (about ``mu``, if given)."""
    if mu is not None:
        x = x - mu
    mse = x.pow(2).mean(dim=tuple(range(2, x.ndim)))  # (B, T)
    ac = sched.alphas_cumprod
    ll = -sched.log_one_minus_alphas_cumprod - mse[..., None] * ac / (1 - ac)
    return ll.argmax(dim=-1)
