"""Per-token diffusion math (schedules, DDIM/DDPM steps) on tensors."""

from .core import DiffusionConfig, Schedule, make_schedule

__all__ = ["DiffusionConfig", "Schedule", "make_schedule"]
