"""A device trace of a stretch of work, with ``torch.profiler``.

Port of ``dfot_tpu/utils/profiling.py:trace`` (the ``jax.profiler`` trace
the training loop takes of step ``experiment.training.profile_at_step``):
``with trace(log_dir): step()`` records host and device activity and
writes, into ``log_dir``, a TensorBoard-readable trace
(``*.pt.trace.json``) and ``kernels.json``, the device time of each kernel
and copy (name, calls, self device ms), largest first.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator

import torch

__all__ = ["trace", "device_kernels"]


def device_kernels(prof) -> list:
    """``[{"kernel", "calls", "ms"}]`` of the device-side entries of a
    finished profile: kernels and copies, not the annotations that the
    profiler also shows on the device side (``Optimizer.step#...``)."""
    rows = [
        {"kernel": e.key, "calls": e.count, "ms": e.self_device_time_total / 1e3}
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False) and not e.key.startswith("Optimizer.")
    ]
    return sorted(rows, key=lambda r: -r["ms"])


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the body (on the card when there is one; the caller waits for
    its device work inside the body)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
    with open(os.path.join(log_dir, "kernels.json"), "w") as f:
        json.dump(device_kernels(prof), f, indent=1)
