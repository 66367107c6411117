"""Scheduling matrices, the window sampler, the long-video planners and the
rollout entry points."""

from .planner import (
    SlidingWindow,
    interpolation_plan,
    keyframe_indices,
    pad_to_length,
    sliding_window_plan,
)
from .rollout import DFoTRollout, RolloutConfig

__all__ = [
    "DFoTRollout", "RolloutConfig", "SlidingWindow", "interpolation_plan",
    "keyframe_indices", "pad_to_length", "sliding_window_plan",
]
