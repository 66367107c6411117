"""Long-video rollout: windows, keyframes, interpolation.

Port of ``dfot_tpu/sampling/rollout.py``, the DFoT sampling API around the
window sampler (sampler.py):

- ``sample_sequence``: one window (<= max_tokens), any context mask;
- ``predict_sequence``: the sliding-window autoregressive rollout;
- ``interpolate_videos``: the greedy plan's chunks infilled round by round;
- ``predict_videos``: a keyframe pass, then the interpolation rounds.

The plans (planner.py) and the masks of known frames stay on the host: all
of them are known before a window runs. The video itself stays on the
device: the JAX rollout keeps it in host numpy only because each distinct
frame tuple would compile an XLA program of its own, a reason eager PyTorch
does not have. So window contexts are gathered, and samples written back, on
the device, and the rollout itself adds no wait on the device between the
windows of a keyframe pass or of an interpolation round. (The window sampler
uploads each window's plan from pageable host memory, and that copy waits
for the stream.)

``stats`` counts denoiser evaluations at batch 1 (``denoiser_evals_b1``) and
windows (``windows``), and, for ``predict_videos``, the keyframe pass's
seconds and evaluations (``keyframe_sec``, ``keyframe_evals_b1``) and the
interpolation's seconds (``interp_sec``). Per interpolation round it adds
up the seconds spent gathering the round's chunks before its first window
(``interp_host_build_sec``) and the seconds spent waiting for the device
once every window of the round is dispatched (``interp_device_wait_sec``).
The phases end where the JAX rollout blocks on its arrays: after the
keyframe pass and at each round's end, on CUDA with
``torch.cuda.synchronize()``. The JAX keys for the host scatter
(``interp_host_scatter_sec``, ``interp_fetch_scatter_sec``) are gone: the
port has no host scatter.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..diffusion import core as dc
from ..guidance.history_guidance import HistoryGuidance
from .planner import interpolation_plan, keyframe_indices, sliding_window_plan
from .sampler import make_window_sampler, plan_sampling

__all__ = ["RolloutConfig", "DFoTRollout"]


def _take_frames(x, frames):
    """Gather ``frames`` along axis 1 of a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.index_select(1, torch.as_tensor(frames, device=x.device))
    return np.take(x, frames, axis=1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    max_tokens: int
    x_shape: Tuple[int, ...]  # channel-last token shape, e.g. (H, W, C)
    scheduling_matrix: str = "full_sequence"
    is_full_sequence: bool = False
    chunk_size: int = -1
    use_causal_mask: bool = False
    external_cond_type: Optional[str] = None  # label | action | None
    sliding_context_len: Optional[int] = None
    keyframe_density: Optional[float] = None
    interpolation_max_batch_size: Optional[int] = None
    refinement: Optional[dict] = None
    # applied once per window to the NFE-expanded conditions (e.g. camera
    # poses -> ray-encoding maps -> per-block pose FiLM terms)
    cond_transform: Optional[Callable] = None
    # round each window's step count up to a multiple of this (0 = exact);
    # the padding steps are no-ops the loop skips
    scan_bucket: int = 0
    mesh: Optional[object] = None
    # (to_state, from_state): keep the loop state in the model's token layout
    state_codec: Optional[Tuple[Callable, Callable]] = None


class DFoTRollout:
    """Samples windows and long videos; the model holds its weights, and the
    schedule's device is the device every window runs on."""

    def __init__(self, cfg: RolloutConfig, dcfg: dc.DiffusionConfig, sched: dc.Schedule,
                 model_apply: Callable):
        self.cfg = cfg
        self.dcfg = dcfg
        self.sched = sched
        # denoiser evaluations counted as batch-1 forward passes
        self.stats = {"denoiser_evals_b1": 0, "windows": 0}
        # optional progress callback: progress(phase: str, info: dict), called
        # after the keyframe pass ("keyframes") and each interpolation round
        # ("interp_round")
        self.progress = None
        self._window_fn = make_window_sampler(
            model_apply, dcfg, sched,
            replacement_only=cfg.is_full_sequence,
            use_ddpm=not dcfg.is_ddim_sampling,
            reconstruction_guidance=dcfg.reconstruction_guidance,
            mesh=cfg.mesh,
            cond_transform=cfg.cond_transform,
            state_codec=cfg.state_codec,
        )

    def _add(self, key: str, value) -> None:
        self.stats[key] = self.stats.get(key, 0) + value

    # ------------------------------------------------------------------
    # one window
    # ------------------------------------------------------------------
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

        def plan_window(pad_steps_to=None):
            return plan_sampling(
                mask, history_guidance, cfg.scheduling_matrix, dcfg.timesteps,
                dcfg.sampling_timesteps, horizon - padding, padding,
                is_full_sequence=cfg.is_full_sequence, refine=cfg.refinement,
                pad_steps_to=pad_steps_to,
            )

        plan = plan_window()
        if cfg.scan_bucket and cfg.scan_bucket > 0:
            bucket = -(-plan.num_steps // cfg.scan_bucket) * cfg.scan_bucket
            if bucket > plan.num_steps:
                plan = plan_window(bucket)
        n_eval_rows = int(plan.num_steps - plan.renoise.sum() - plan.noop.sum())
        self.stats["denoiser_evals_b1"] += n_eval_rows * batch_size * plan.nfe
        self.stats["windows"] += 1
        if conditions is not None:
            conditions = torch.as_tensor(conditions, device=dev)
        out = self._window_fn(x_init, plan, conditions, generator, ctx)
        return out[:, :length]

    # ------------------------------------------------------------------
    # sliding-window prediction
    # ------------------------------------------------------------------
    def predict_sequence(
        self,
        generator: Optional[torch.Generator],
        context,  # (B, gt_len, *x_shape)
        length: Optional[int] = None,
        conditions=None,
        history_guidance: Optional[HistoryGuidance] = None,
        sliding_context_len: Optional[int] = None,
    ) -> torch.Tensor:
        """Extend ``context`` to ``length`` frames window by window; each
        window's context is the last frames so far, its generated ones with
        mask code 2. Returns (B, length, *x_shape) fp32 on the device."""
        cfg = self.cfg
        dev = self.sched.device
        if length is None:
            length = cfg.max_tokens
        batch_size, gt_len = context.shape[:2]
        windows = sliding_window_plan(
            gt_len, length, cfg.max_tokens,
            sliding_context_len if sliding_context_len is not None
            else (cfg.sliding_context_len if length > cfg.max_tokens else None),
            cfg.chunk_size, cfg.use_causal_mask,
        )
        xs_pred = torch.as_tensor(context, dtype=torch.float32, device=dev)
        for w in windows:
            c, h = w.context_len, w.gen_len
            win_ctx = torch.cat([
                xs_pred[:, xs_pred.shape[1] - c:],
                xs_pred.new_zeros((batch_size, h) + tuple(cfg.x_shape)),
            ], 1)
            win_mask = np.zeros((batch_size, c + h), dtype=np.int64)
            win_mask[:, :c] = 1
            if w.generated_context_len > 0:
                win_mask[:, c - w.generated_context_len:c] = 2
            cond_slice = self._slice_conditions(
                conditions, w.start_token, c + h if cfg.use_causal_mask else cfg.max_tokens
            )
            new = self.sample_sequence(
                generator, batch_size, length=c + h, context=win_ctx,
                context_mask=win_mask, conditions=cond_slice,
                history_guidance=history_guidance,
            )
            xs_pred = torch.cat([xs_pred, new[:, c:]], 1)
        return xs_pred

    # ------------------------------------------------------------------
    # interpolation
    # ------------------------------------------------------------------
    def interpolate_videos(
        self,
        generator: Optional[torch.Generator],
        context,  # (B, T, *x_shape)
        context_mask: Optional[np.ndarray] = None,  # (B, T) bool
        conditions=None,
        history_guidance: Optional[HistoryGuidance] = None,
    ) -> torch.Tensor:
        """Fill every unknown frame (default: all but the first and last),
        round by round of ``planner.interpolation_plan``. The plan comes from
        batch element 0's mask, which the batch shares. Returns (B, T,
        *x_shape) fp32 on the device."""
        cfg = self.cfg
        dev = self.sched.device
        B, T = context.shape[:2]
        if context_mask is None:
            context_mask = np.zeros((B, T), dtype=bool)
            context_mask[:, [0, -1]] = True
        known = np.array(context_mask, dtype=bool)
        plan = interpolation_plan(known[0], cfg.max_tokens)
        xs = torch.as_tensor(context, dtype=torch.float32, device=dev).clone()
        if conditions is not None:
            conditions = torch.as_tensor(conditions, device=dev)
        bs = cfg.interpolation_max_batch_size

        for rnd in plan:
            t_build = time.perf_counter()
            chunk_ctx, chunk_mask, chunk_cond = [], [], []
            for frames in rnd:
                n = len(frames)
                pad = cfg.max_tokens - n
                ctx = _take_frames(xs, frames)
                if pad:
                    ctx = torch.cat([ctx, ctx.new_zeros((B, pad) + tuple(cfg.x_shape))], 1)
                m = np.full((B, cfg.max_tokens), -1, dtype=np.int64)
                m[:, :n] = known[:, frames]
                chunk_ctx.append(ctx)
                chunk_mask.append(m)
                if conditions is not None:
                    if cfg.external_cond_type == "label":
                        chunk_cond.append(conditions)
                    else:
                        csel = _take_frames(conditions, frames)
                        if pad:
                            csel = torch.cat(
                                [csel, csel.new_zeros((B, pad) + csel.shape[2:])], 1)
                        chunk_cond.append(csel)
            self._add("interp_host_build_sec", time.perf_counter() - t_build)

            # the round's flat chunk-major batch of N rows, cut into groups of
            # at most ``bs`` rows; a group boundary splits a chunk unless bs
            # is a multiple of B
            N = len(rnd) * B
            size = bs or N

            def chunk_rows(i0, i1):
                """(chunk, r0, r1) spans covering flat rows [i0, i1)."""
                return [(ci, max(0, i0 - ci * B), min(B, i1 - ci * B))
                        for ci in range(i0 // B, -(-i1 // B))]

            def row_parts(parts, i0, i1):
                rows = [parts[ci][r0:r1] for ci, r0, r1 in chunk_rows(i0, i1)]
                if isinstance(rows[0], np.ndarray):
                    return np.concatenate(rows, 0)
                return torch.cat(rows, 0)

            groups = [(i0, min(i0 + size, N)) for i0 in range(0, N, size)]
            outs = [
                self.sample_sequence(
                    generator, i1 - i0, length=cfg.max_tokens,
                    context=row_parts(chunk_ctx, i0, i1),
                    context_mask=row_parts(chunk_mask, i0, i1),
                    conditions=row_parts(chunk_cond, i0, i1) if chunk_cond else None,
                    history_guidance=history_guidance,
                )
                for i0, i1 in groups
            ]
            t_wait = time.perf_counter()
            _sync(dev)
            self._add("interp_device_wait_sec", time.perf_counter() - t_wait)
            for (i0, i1), out in zip(groups, outs):
                for ci, r0, r1 in chunk_rows(i0, i1):
                    frames = rnd[ci]
                    po = ci * B + r0 - i0
                    xs[r0:r1].index_copy_(1, torch.as_tensor(frames, device=dev),
                                          out[po:po + r1 - r0, :len(frames)])
                    known[r0:r1, frames] = True
            if self.progress is not None:
                self.progress("interp_round", {"frames_known": int(known[0].sum())})
        return xs

    # ------------------------------------------------------------------
    # full prediction task (keyframes + interpolation)
    # ------------------------------------------------------------------
    def predict_videos(
        self,
        generator: Optional[torch.Generator],
        xs,  # (B, T, *x_shape): context frames at the front
        n_context_tokens: int,
        conditions=None,
        prediction_hg: Optional[HistoryGuidance] = None,
        interpolation_hg: Optional[HistoryGuidance] = None,
    ) -> torch.Tensor:
        """Keyframes at ``keyframe_density`` by a sliding-window pass from
        the first ``n_context_tokens`` frames, then interpolation between
        them. Returns (B, T, *x_shape) fp32 on the device."""
        cfg = self.cfg
        dev = self.sched.device
        B, T = xs.shape[:2]
        keys = keyframe_indices(cfg.keyframe_density or 1.0, T, n_context_tokens)
        key_conditions = conditions
        if conditions is not None and cfg.external_cond_type == "action":
            key_conditions = _take_frames(conditions, keys)

        xs_pred = torch.as_tensor(xs, dtype=torch.float32, device=dev).clone()
        t0 = time.perf_counter()
        ev0 = self.stats["denoiser_evals_b1"]
        xs_key = self.predict_sequence(
            generator, xs_pred[:, :n_context_tokens], length=len(keys),
            conditions=key_conditions, history_guidance=prediction_hg,
            sliding_context_len=cfg.sliding_context_len or cfg.max_tokens // 2,
        )
        _sync(dev)
        self._add("keyframe_sec", time.perf_counter() - t0)
        self._add("keyframe_evals_b1", self.stats["denoiser_evals_b1"] - ev0)
        if self.progress is not None:
            self.progress("keyframes", {"frames_known": len(keys)})
        xs_pred.index_copy_(1, torch.as_tensor(keys, device=dev), xs_key)

        if len(keys) < T:
            mask = np.zeros((B, T), dtype=bool)
            mask[:, keys] = True
            t1 = time.perf_counter()
            xs_pred = self.interpolate_videos(
                generator, xs_pred, mask, conditions=conditions,
                history_guidance=interpolation_hg,
            )
            self._add("interp_sec", time.perf_counter() - t1)
        return xs_pred

    # ------------------------------------------------------------------
    def _slice_conditions(self, conditions, start: int, length: int):
        """Frames [start, start + length) of per-frame conditions, zero-padded
        past the end; ``label`` conditions pass whole."""
        if conditions is None:
            return None
        if self.cfg.external_cond_type == "label":
            return conditions
        sl = conditions[:, start:start + length]
        if sl.shape[1] < length:  # pad tail windows
            shape = (sl.shape[0], length - sl.shape[1]) + tuple(sl.shape[2:])
            if isinstance(sl, torch.Tensor):
                sl = torch.cat([sl, sl.new_zeros(shape)], 1)
            else:
                sl = np.concatenate([sl, np.zeros(shape, sl.dtype)], 1)
        return sl
