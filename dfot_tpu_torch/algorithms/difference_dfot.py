"""Difference-DFoT: a denoiser of (frame difference, frame) token pairs.

Port of ``dfot_tpu/algorithms/difference_dfot.py``. The sequence gains its
first-order temporal differences (``diff[t] = x[t] - x[t-1]``, ``diff[0] =
0``), merged ``concat`` (``[diffs | frames]``) or ``interleaved`` along time
into 2T tokens; noise levels, loss masks and conditions are tiled over both
streams, and the two halves' losses are logged apart (``diff_loss``,
``xs_loss``). Sampling rolls out the merged stream in windows of twice the
model's tokens and unmerges at the end.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..diffusion import core as dc
from ..diffusion.continuous import continuous_training_fields, continuous_v_loss
from ..sampling import DFoTRollout
from ..training.noise_levels import training_noise_levels
from ..training.trainer import make_train_step as _make_train_step
from ..training.trainer import training_noise
from .dfot_video import DFoTVideoAlgo

__all__ = ["DifferenceDFoTVideoAlgo"]


class DifferenceDFoTVideoAlgo(DFoTVideoAlgo):
    def __init__(self, cfg, compute_dtype=torch.bfloat16, device=None):
        self.merge_type = cfg.backbone.get("merge_type", "concat")
        if self.merge_type not in ("concat", "interleaved"):
            raise ValueError(f"unsupported merge type {self.merge_type}")
        super().__init__(cfg, compute_dtype, device)
        self._merged_rollout()

    def _merged_rollout(self) -> None:
        """Windows over the merged stream: twice the model's tokens."""
        self.merged_rollout = DFoTRollout(
            dataclasses.replace(self.rollout_cfg, max_tokens=2 * self.max_tokens),
            self.dcfg, self.sched, self._autocast(self.model))

    def set_sampling_mesh(self, mesh) -> None:
        super().set_sampling_mesh(mesh)
        self._merged_rollout()

    # -- merging ------------------------------------------------------------
    def merge(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Two (B, T, ...) streams -> (B, 2T, ...)."""
        if self.merge_type == "concat":
            return torch.cat([a, b], dim=1)
        return torch.stack([a, b], dim=2).reshape((a.shape[0], 2 * a.shape[1]) + a.shape[2:])

    def unmerge(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.merge_type == "concat":
            return tuple(x.chunk(2, dim=1))
        y = x.reshape((x.shape[0], x.shape[1] // 2, 2) + x.shape[2:])
        return y[:, :, 0], y[:, :, 1]

    @staticmethod
    def differences(xs: torch.Tensor) -> torch.Tensor:
        """x[t] - x[t-1] along time, 0 at the first frame."""
        return torch.diff(xs, dim=1, prepend=xs[:, :1])

    # -- training -----------------------------------------------------------
    def _merged_loss(self, model, xs, conditions, frame_mask, generator, noise_levels, noise,
                     rows=None):
        """(masked mean loss over both streams, {"diff_loss", "xs_loss"}): the
        levels drawn per frame and tiled, ``noise`` over the merged (B, 2T,
        ...) stream; ``rows`` a data-parallel share (``training.trainer``)."""
        dcfg, sched = self.dcfg, self.sched
        dev = sched.device
        draws = noise_levels if isinstance(noise_levels, dict) or noise_levels is None \
            else {"levels": noise_levels}
        k, loss_mask = training_noise_levels(generator, self.nl_cfg, frame_mask, True, draws,
                                             rows=rows)
        xs = xs.float()
        merged = self.merge(self.differences(xs), xs)
        k2, mask2 = self.merge(k, k), self.merge(loss_mask, loss_mask)
        cond2 = None if conditions is None else self.merge(conditions, conditions)
        if noise is None:
            noise = training_noise(dcfg, merged.shape, generator, dev, merged.dtype, rows)
        else:
            noise = torch.as_tensor(noise, device=dev, dtype=merged.dtype).clamp(
                -dcfg.clip_noise, dcfg.clip_noise)
        if dcfg.is_continuous:
            x_t, logsnr, alpha_t, sigma_t = continuous_training_fields(dcfg, merged, k2, noise)
            out = self._train_apply(model, x_t, dcfg.precond_scale * logsnr, cond2, None)
            _, loss = continuous_v_loss(dcfg, out, x_t, noise, logsnr, alpha_t, sigma_t)
        else:
            noised, target = dc.training_targets(sched, dcfg, merged, k2, noise)
            out = self._train_apply(model, noised, k2.float(), cond2, None)
            loss = dc.training_loss(sched, dcfg, out, target, k2)
        w2 = dc.bcast_right(mask2.to(loss.dtype), loss.ndim)
        w1 = dc.bcast_right(loss_mask.to(loss.dtype), loss.ndim)
        diff_loss, xs_loss = (part.detach() for part in self.unmerge(loss))
        return (loss * w2).mean(), {"diff_loss": (diff_loss * w1).mean(),
                                    "xs_loss": (xs_loss * w1).mean()}

    def make_train_step(self, ema_decay: float = 0.9999, accumulate_steps: int = 1,
                        rows=None, grad_sync=None):
        """``train_step(state, batch, generator) -> (state, metrics)`` on the
        merged stream; metrics add ``diff_loss`` and ``xs_loss``. The draws
        can be injected as the base step's: ``noise_levels`` per frame (B,
        T), ``noise`` over the merged (B, 2T, ...) stream."""
        return _make_train_step(self._train_apply, self.dcfg, self.sched, self.nl_cfg,
                                ema_decay, accumulate_steps,
                                loss_fn=functools.partial(self._merged_loss, rows=rows),
                                grad_sync=grad_sync)

    # -- sampling -----------------------------------------------------------
    def sample_videos(self, generator: Optional[torch.Generator], xs: torch.Tensor,
                      conditions=None, tasks=None, n_context_tokens: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
        """Prediction on the merged (difference, frame) stream: context
        tokens doubled (only the interleaved merge takes context), windows of
        twice the model's tokens with ``sliding_context_len`` as it is, the
        frames and the differences unmerged at the end (``prediction``,
        ``prediction_diff``)."""
        nct = self.n_context_tokens if n_context_tokens is None else n_context_tokens
        if nct > 0 and self.merge_type != "interleaved":
            raise ValueError("context tokens > 0 require the interleaved merge")
        self.model.eval()
        merged = self.merge(self.differences(xs), xs)
        conds = self.process_conditions(conditions)
        if conds is not None:
            conds = torch.as_tensor(np.asarray(conds), device=self.device)
            conds = self.merge(conds, conds)
        out = self.merged_rollout.predict_videos(
            generator, merged, 2 * nct, conds,
            prediction_hg=self.prediction_hg, interpolation_hg=self.interpolation_hg)
        gen_diff, frames = self.unmerge(out)
        return {"gt": xs, "prediction": frames, "prediction_diff": gen_diff}
