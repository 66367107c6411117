"""Noise schedules — host numpy, float64.

A copy of ``dfot_tpu/diffusion/schedules.py``: every schedule family
(``cosine``, ``cosine_simple_diffusion``, ``alphas_cumprod_linear``,
``linear``, ``sigmoid``, ``sd``), zero-terminal-SNR enforcement and SNR
shifting. The copy exists because the JAX package's ``diffusion/__init__``
imports jax; ``tests/test_torch_port_sampling.py`` and
``tests/test_torch_port_remainders.py`` hold it equal to the original.
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


def alphas_cumprod_linear_schedule(timesteps: int) -> np.ndarray:
    """Linear alphas_cumprod (arXiv 2301.10972)."""
    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    return (1.0 - t)[1:]


def beta_linear_schedule(timesteps: int, start: float = 0.0001, end: float = 0.02) -> np.ndarray:
    """DDPM's linear-beta schedule (arXiv 2006.11239)."""
    betas = np.linspace(start, end, timesteps, dtype=np.float64)
    return np.cumprod(1.0 - betas)


def sigmoid_schedule(timesteps: int, start: float = -3.0, end: float = 3.0,
                     tau: float = 1.0) -> np.ndarray:
    """Sigmoid schedule (arXiv 2212.11972, Fig. 8). The endpoint sigmoids
    are taken in float32, as the upstream torch code computes them (its
    ``torch.tensor`` of a Python float is float32)."""

    def _sig(v):
        return 1.0 / (1.0 + np.exp(-v))

    def _sig32(v):
        v32 = np.float32(v)
        return np.float64(np.float32(1.0) / (np.float32(1.0) + np.exp(-v32, dtype=np.float32)))

    t = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64) / timesteps
    v_start, v_end = _sig32(start / tau), _sig32(end / tau)
    ac = (-_sig((t * (end - start) + start) / tau) + v_end) / (v_end - v_start)
    ac = ac / ac[0]
    return ac[1:]


def sd_schedule(timesteps: int, start: float = 0.00085, end: float = 0.0120) -> np.ndarray:
    """Stable Diffusion's sqrt-linear beta schedule."""
    betas = np.linspace(start**0.5, end**0.5, timesteps, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def shift_beta_schedule(alphas_cumprod: np.ndarray, shift: float) -> np.ndarray:
    """Rescale alphas_cumprod so SNR is multiplied by shift**2."""
    s2 = shift * shift
    return (s2 * alphas_cumprod) / (s2 * alphas_cumprod + 1.0 - alphas_cumprod)


def enforce_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift and rescale sqrt(alphas_cumprod) so that the last step has
    exactly zero SNR (arXiv 2305.08891)."""
    sqrt_ac = np.sqrt(alphas_cumprod)
    a0, aT = sqrt_ac[0], sqrt_ac[-1]
    sqrt_ac = sqrt_ac - aT
    sqrt_ac = sqrt_ac * (a0 / sqrt_ac[0])
    out = sqrt_ac**2
    if out[-1] != 0.0:
        raise ValueError("terminal SNR not zero")
    return out


_SCHEDULES: Dict[str, callable] = {
    "cosine": cosine_schedule,
    "cosine_simple_diffusion": cosine_simple_diffusion_schedule,
    "alphas_cumprod_linear": alphas_cumprod_linear_schedule,
    "linear": beta_linear_schedule,
    "sigmoid": sigmoid_schedule,
    "sd": sd_schedule,
}


def make_beta_schedule(
    schedule: str,
    timesteps: int,
    shift: float = 1.0,
    clip_min: float = 1e-9,
    zero_terminal_snr: bool = True,
    **kwargs,
) -> np.ndarray:
    """Per-step betas (float64, length ``timesteps``). The cosine families
    skip the zero-terminal-SNR pass (cosine already ends at zero SNR;
    simple-diffusion's must not), and cosine_simple_diffusion carries its SNR
    shift in its own kwargs."""
    if schedule not in _SCHEDULES:
        raise ValueError(f"unknown beta schedule {schedule!r}")
    ac = _SCHEDULES[schedule](timesteps=timesteps, **kwargs)
    if schedule not in ("cosine", "cosine_simple_diffusion") and zero_terminal_snr:
        ac = enforce_zero_terminal_snr(ac)
    if shift != 1.0 and schedule != "cosine_simple_diffusion":
        ac = shift_beta_schedule(ac, shift)
    alphas = np.concatenate([ac[:1], ac[1:] / ac[:-1]])
    betas = 1.0 - alphas
    return np.clip(betas, clip_min, 1.0)
