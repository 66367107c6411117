"""Noise schedules — host numpy, float64.

A copy of the schedule families of ``dfot_tpu/diffusion/schedules.py`` that
the port's configurations use (``cosine`` and the flagship's shifted
``cosine_simple_diffusion``). The copy exists because the JAX package's
``diffusion/__init__`` imports jax; ``tests/test_torch_port_sampling.py``
holds it equal to the original.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

__all__ = ["make_beta_schedule"]


def cosine_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Improved-DDPM cosine alphas_cumprod."""
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    ac = np.cos((t + s) / (1 + s) * math.pi * 0.5) ** 2
    ac = ac / ac[0]
    return ac[1:]


def cosine_simple_diffusion_schedule(
    timesteps: int,
    logsnr_min: float = -15.0,
    logsnr_max: float = 15.0,
    shifted: float = 1.0,
    interpolated: bool = False,
) -> np.ndarray:
    """Simple-Diffusion cosine schedule in logSNR form (arXiv 2301.11093),
    with optional resolution shift / interpolation."""
    t_min = math.atan(math.exp(-0.5 * logsnr_max))
    t_max = math.atan(math.exp(-0.5 * logsnr_min))
    t = np.linspace(0, 1, timesteps, dtype=np.float64)
    logsnr = -2.0 * np.log(np.tan(t_min + t * (t_max - t_min)))
    if shifted != 1.0:
        shifted_logsnr = logsnr + 2.0 * math.log(shifted)
        logsnr = t * logsnr + (1 - t) * shifted_logsnr if interpolated else shifted_logsnr
    return 1.0 / (1.0 + np.exp(-logsnr))


def shift_beta_schedule(alphas_cumprod: np.ndarray, shift: float) -> np.ndarray:
    """Rescale alphas_cumprod so SNR is multiplied by shift**2."""
    s2 = shift * shift
    return (s2 * alphas_cumprod) / (s2 * alphas_cumprod + 1.0 - alphas_cumprod)


_SCHEDULES: Dict[str, callable] = {
    "cosine": cosine_schedule,
    "cosine_simple_diffusion": cosine_simple_diffusion_schedule,
}


def make_beta_schedule(
    schedule: str,
    timesteps: int,
    shift: float = 1.0,
    clip_min: float = 1e-9,
    zero_terminal_snr: bool = True,
    **kwargs,
) -> np.ndarray:
    """Per-step betas (float64, length ``timesteps``). Both ported families
    already end at zero terminal SNR, so ``zero_terminal_snr`` changes
    nothing for them (as in the JAX package); cosine_simple_diffusion
    carries its SNR shift in its own kwargs."""
    if schedule not in _SCHEDULES:
        raise ValueError(f"beta schedule {schedule!r} is not ported")
    ac = _SCHEDULES[schedule](timesteps=timesteps, **kwargs)
    if shift != 1.0 and schedule != "cosine_simple_diffusion":
        ac = shift_beta_schedule(ac, shift)
    alphas = np.concatenate([ac[:1], ac[1:] / ac[:-1]])
    betas = 1.0 - alphas
    return np.clip(betas, clip_min, 1.0)
