"""Window-level sampling entry point.

Port of ``dfot_tpu/sampling/rollout.py``: :class:`RolloutConfig` and
:meth:`DFoTRollout.sample_sequence`, one window of up to ``max_tokens``
frames with an arbitrary context mask. The long-video entry points
(``predict_sequence``, ``interpolate_videos``, ``predict_videos``) and
scan-length bucketing are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..diffusion import core as dc
from ..guidance.history_guidance import HistoryGuidance
from .sampler import make_window_sampler, plan_sampling

__all__ = ["RolloutConfig", "DFoTRollout"]


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    max_tokens: int
    x_shape: Tuple[int, ...]  # channel-last token shape, e.g. (H, W, C)
    scheduling_matrix: str = "full_sequence"
    is_full_sequence: bool = False
    use_causal_mask: bool = False
    refinement: Optional[dict] = None
    # applied once per window to the NFE-expanded conditions (e.g. camera
    # poses -> ray-encoding maps -> per-block pose FiLM terms)
    cond_transform: Optional[Callable] = None
    # (to_state, from_state): keep the loop state in the model's token layout
    state_codec: Optional[Tuple[Callable, Callable]] = None
    scan_bucket: int = 0
    mesh: Optional[object] = None


class DFoTRollout:
    """Samples windows; the model holds its weights, and the schedule's
    device is the device the window runs on."""

    def __init__(self, cfg: RolloutConfig, dcfg: dc.DiffusionConfig, sched: dc.Schedule,
                 model_apply: Callable):
        if cfg.scan_bucket:
            raise NotImplementedError("scan-length bucketing is not ported")
        self.cfg = cfg
        self.dcfg = dcfg
        self.sched = sched
        # denoiser evaluations counted as batch-1 forward passes
        self.stats = {"denoiser_evals_b1": 0, "windows": 0}
        self._window_fn = make_window_sampler(
            model_apply, dcfg, sched,
            replacement_only=cfg.is_full_sequence,
            use_ddpm=not dcfg.is_ddim_sampling,
            reconstruction_guidance=dcfg.reconstruction_guidance,
            mesh=cfg.mesh,
            cond_transform=cfg.cond_transform,
            state_codec=cfg.state_codec,
        )

    def sample_sequence(
        self,
        generator: Optional[torch.Generator],
        batch_size: int,
        length: Optional[int] = None,
        context=None,
        context_mask: Optional[np.ndarray] = None,
        conditions=None,
        history_guidance: Optional[HistoryGuidance] = None,
    ) -> torch.Tensor:
        """Sample one window of up to max_tokens frames.

        The JAX call's ``(variables, rng, ...)`` becomes ``(generator, ...)``:
        the model carries its weights and every random draw comes from
        ``generator`` (on the schedule's device). context: (B, length,
        *x_shape) or None; context_mask: (B, length) int {0, 1, 2};
        conditions: (B, T, ...) array or tensor. Returns (B, length, *x_shape)
        fp32 on the device.
        """
        cfg, dcfg = self.cfg, self.dcfg
        dev = self.sched.device
        if length is None:
            length = cfg.max_tokens if context is None else context.shape[1]
        if length > cfg.max_tokens:
            raise ValueError(f"length {length} exceeds max_tokens {cfg.max_tokens}")
        if (context is None) != (context_mask is None):
            raise ValueError("context and context_mask must be given together")

        horizon = length if cfg.use_causal_mask else cfg.max_tokens
        padding = horizon - length
        xs_shape = (batch_size, horizon) + tuple(cfg.x_shape)
        x_init = dc.clipped_normal(xs_shape, dcfg.clip_noise, generator, dev)

        ctx = torch.zeros(xs_shape, dtype=x_init.dtype, device=dev)
        if context is None:
            mask = np.zeros((batch_size, horizon), dtype=np.int64)
        else:
            ctx[:, :length] = torch.as_tensor(context, dtype=x_init.dtype, device=dev)
            mask = np.full((batch_size, horizon), -1, dtype=np.int64)
            mask[:, :length] = np.asarray(context_mask)
        is_ctx = torch.as_tensor(mask >= 1, device=dev)
        x_init = torch.where(dc.bcast_right(is_ctx, x_init.ndim), ctx, x_init)

        if history_guidance is None:
            history_guidance = HistoryGuidance.conditional(timesteps=dcfg.timesteps)
        plan = plan_sampling(
            mask, history_guidance, cfg.scheduling_matrix, dcfg.timesteps,
            dcfg.sampling_timesteps, horizon - padding, padding,
            is_full_sequence=cfg.is_full_sequence, refine=cfg.refinement,
        )
        n_eval_rows = int(plan.num_steps - plan.renoise.sum() - plan.noop.sum())
        self.stats["denoiser_evals_b1"] += n_eval_rows * batch_size * plan.nfe
        self.stats["windows"] += 1
        if conditions is not None:
            conditions = torch.as_tensor(conditions, device=dev)
        out = self._window_fn(x_init, plan, conditions, generator)
        return out[:, :length]
