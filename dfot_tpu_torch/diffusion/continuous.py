"""Continuous-time diffusion (logSNR parameterization).

Port of ``dfot_tpu/diffusion/continuous.py``: training draws t in [0, 1] per
token and converts it through a (shifted) cosine logSNR schedule; sampling
runs on the discrete DDIM grid, but the network's noise-level input is
``precond_scale * logsnr`` instead of the integer timestep.
"""

from __future__ import annotations

import math

import torch

from .core import DiffusionConfig, Schedule, bcast_right

__all__ = [
    "continuous_logsnr",
    "continuous_training_fields",
    "continuous_model_noise_input",
    "continuous_v_loss",
]


def continuous_logsnr(cfg: DiffusionConfig, t: torch.Tensor) -> torch.Tensor:
    """Cosine logSNR schedule with resolution shift; ``t`` in [0, 1]."""
    if cfg.training_schedule_name != "cosine":
        raise ValueError(f"unknown continuous schedule {cfg.training_schedule_name}")
    t_min = math.atan(math.exp(-0.5 * cfg.logsnr_max))
    t_max = math.atan(math.exp(-0.5 * cfg.logsnr_min))
    shift = 2.0 * math.log(cfg.training_schedule_shift)
    return -2.0 * torch.log(torch.tan(t_min + t * (t_max - t_min))) + shift


def continuous_model_noise_input(cfg: DiffusionConfig, sched: Schedule, k: torch.Tensor):
    """The network's noise-level input while sampling: precond_scale * logsnr[k]."""
    return cfg.precond_scale * sched.logsnr[k.clamp(min=0).long()]


def continuous_training_fields(cfg: DiffusionConfig, x, t, noise):
    """The continuous-time v-prediction training quantities:
    (x_t, logsnr, alpha_t, sigma_t), alpha and sigma broadcast to x.
    ``t``: (B, T) floats in [0, 1]."""
    logsnr = continuous_logsnr(cfg, t)
    alpha_t = bcast_right(torch.sigmoid(logsnr).sqrt(), x.ndim)
    sigma_t = bcast_right(torch.sigmoid(-logsnr).sqrt(), x.ndim)
    return alpha_t * x + sigma_t * noise, logsnr, alpha_t, sigma_t


def continuous_v_loss(cfg: DiffusionConfig, v_pred, x_t, noise, logsnr, alpha_t, sigma_t):
    """Sigmoid-weighted epsilon-MSE loss of the v-prediction (Kingma & Gao
    2023): (x_pred, elementwise weighted loss). No gradient flows into the
    noise."""
    noise_pred = alpha_t * v_pred + sigma_t * x_t
    x_pred = alpha_t * x_t - sigma_t * v_pred
    loss = (noise_pred - noise.detach()) ** 2
    w = torch.sigmoid(cfg.sigmoid_bias - logsnr)
    return x_pred, loss * bcast_right(w, loss.ndim)
