"""Scheduling matrices, the window sampler and the rollout entry point."""

from .rollout import DFoTRollout, RolloutConfig

__all__ = ["DFoTRollout", "RolloutConfig"]
