"""Continuous-time diffusion (logSNR parameterization), sampling side.

Port of ``dfot_tpu/diffusion/continuous.py``: sampling runs on the discrete
DDIM grid, but the network's noise-level input is ``precond_scale * logsnr``
instead of the integer timestep.
"""

from __future__ import annotations

import math

import torch

from .core import DiffusionConfig, Schedule

__all__ = ["continuous_logsnr", "continuous_model_noise_input"]


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
