"""The window sampler: one denoising window as a loop over a host plan.

Port of ``dfot_tpu/sampling/sampler.py``. Everything data-dependent
(scheduling matrix, context pinning, mask evolution, HG tables) is resolved
on the host into a :class:`SamplingPlan` (a numpy copy of the JAX
package's planner). The device side is a Python loop over the plan's step
axis, the counterpart of the JAX ``lax.scan``: each step is a denoise, a
go-back re-noise or a no-op, chosen from the host plan, so the loop never
waits on the device.

Reconstruction guidance differentiates each step's reconstruction loss
against the clean context with respect to the denoiser's input (the model's
autograd route: B2 -> B1 -> B3 forward, B7 -> B4, B5 -> B6 back).

With a ``mesh`` (``parallel/mesh.py``; the JAX ``mesh``, :226-260, :359)
the NFE-expanded batch of every denoising step is split over the mesh's
``data`` axis where it divides: each process evaluates its consecutive rows
(with their reconstruction-guidance gradients) and the predictions are
all-gathered. Every process keeps the whole sampling state and draws the
same noise from the same generator seed, so the window is the one-process
window on every process.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..diffusion import core as dc
from ..diffusion.continuous import continuous_model_noise_input
from ..guidance.history_guidance import HGTable, HistoryGuidance, hg_compose, hg_prepare
from .scheduling import generate_refine_scheduling_matrix, generate_scheduling_matrix

__all__ = ["SamplingPlan", "plan_sampling", "make_window_sampler"]


class SamplingPlan(NamedTuple):
    """Host-precomputed per-step tables for one window. Leading axis S =
    steps; B = batch; T = horizon; H = history conditions; G = gen segments."""

    from_levels: np.ndarray      # (S, B, T) int32
    to_levels: np.ndarray        # (S, B, T) int32
    context_masks: np.ndarray    # (S, B, T) int32, mask before each step
    override_mask: np.ndarray    # (S, B, H, T) bool
    override_levels: np.ndarray  # (S, B, H, T) int32
    cond_mask: np.ndarray        # (S, H) bool
    weights: np.ndarray          # (S, H) float32
    gen_excluded: np.ndarray     # (S, B, G, T) bool
    gen_coverage: np.ndarray     # (S, B, T) int32
    renoise: np.ndarray          # (S,) bool: go-back re-noising steps
    noop: np.ndarray             # (S,) bool: identity padding rows

    @property
    def num_steps(self) -> int:
        return self.from_levels.shape[0]

    @property
    def num_hist(self) -> int:
        return self.weights.shape[1]

    @property
    def num_gen(self) -> int:
        return self.gen_excluded.shape[2]

    @property
    def nfe(self) -> int:
        return self.num_hist * self.num_gen


def _tree_rows(tree, lo: int, hi: int):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_rows(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def _data_rows(mesh) -> Callable:
    """``rows(fn, *args)``: ``fn`` of the NFE-expanded arguments (leading
    axis the rows; dicts of such tensors too), split over the mesh's data
    axis where the rows divide: this process's consecutive rows, then every
    output tensor all-gathered in rank order. Without a mesh, or where the
    rows do not divide, ``fn`` of them all."""
    if mesh is None:
        return lambda fn, *args: fn(*args)
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a torch DeviceMesh (parallel.make_mesh), got {mesh!r}")
    import torch.distributed as dist

    from ..parallel.mesh import axis_group

    group, size, index = axis_group(mesh, "data")

    def rows(fn, *args):
        n = args[0].shape[0]
        if size == 1 or n % size:
            return fn(*args)
        lo, hi = index * n // size, (index + 1) * n // size
        out = fn(*(_tree_rows(a, lo, hi) for a in args))

        def gather(t):
            parts = [torch.empty_like(t) for _ in range(size)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts, dim=0)

        return type(out)(*(gather(t) for t in out))

    return rows


def plan_sampling(
    context_mask: np.ndarray,
    history_guidance: HistoryGuidance,
    scheduling_matrix: str,
    timesteps: int,
    sampling_timesteps: int,
    horizon: int,
    padding: int = 0,
    is_full_sequence: bool = False,
    refine: Optional[dict] = None,
    pad_steps_to: Optional[int] = None,
) -> SamplingPlan:
    """Resolve the whole window schedule on the host.

    context_mask: (B, T) int in {-1, 0, 1, 2} (T = horizon + padding).
    """
    ctx = np.asarray(context_mask, dtype=np.int64)
    if ctx.ndim != 2:
        raise ValueError("context_mask must be (B, T)")
    B, T = ctx.shape
    if T != horizon + padding:
        raise ValueError(f"context_mask width {T} != horizon+padding {horizon + padding}")

    if refine is not None:
        mat = generate_refine_scheduling_matrix(
            horizon, timesteps, sampling_timesteps,
            refine["goback_length"], refine["n_goback"], padding,
        )
    else:
        mat = generate_scheduling_matrix(
            scheduling_matrix, horizon, timesteps, sampling_timesteps, padding
        )

    # pin context tokens to -1 (per batch element)
    mat_b = np.broadcast_to(mat[:, None, :], (mat.shape[0], B, T)).copy()
    if not is_full_sequence:
        mat_b = np.where(ctx[None] >= 1, -1, mat_b)

    if refine is None:
        # prune identical adjacent leading rows across the whole batch
        diff = (mat_b[1:] != mat_b[:-1]).any(axis=(1, 2))
        skip = int(np.argmax(diff)) if diff.any() else len(diff)
        mat_b = mat_b[skip:]

    S = mat_b.shape[0] - 1
    from_levels = mat_b[:-1]
    to_levels = mat_b[1:]
    renoise = (to_levels > from_levels).any(axis=(1, 2))

    # evolve context masks (0 -> 2 where from == -1) per denoising step
    context_masks = np.empty((S, B, T), dtype=np.int64)
    cur = ctx.copy()
    for s in range(S):
        if not renoise[s]:
            cur = np.where((cur == 0) & (from_levels[s] == -1), 2, cur)
        context_masks[s] = cur

    tables = [[history_guidance.plan(context_masks[s, b]) for b in range(B)] for s in range(S)]
    H = max(t.num_hist for row in tables for t in row)
    G = tables[0][0].num_gen

    override_mask = np.zeros((S, B, H, T), dtype=bool)
    override_levels = np.full((S, B, H, T), timesteps - 1, dtype=np.int32)
    cond_mask = np.zeros((S, H), dtype=bool)
    weights = np.zeros((S, H), dtype=np.float32)
    gen_excluded = np.zeros((S, B, G, T), dtype=bool)
    gen_coverage = np.ones((S, B, T), dtype=np.int32)
    for s in range(S):
        h_s = tables[s][0].num_hist
        for b in range(B):
            t = tables[s][b]
            if t.num_hist != h_s:
                raise ValueError("HG table size must be batch-constant per step")
            override_mask[s, b, :h_s] = t.override_mask[0]
            override_levels[s, b, :h_s] = t.override_levels[0]
            gen_excluded[s, b] = t.gen_excluded[0]
            gen_coverage[s, b] = t.gen_coverage[0]
        cond_mask[s, :h_s] = tables[s][0].cond_mask
        weights[s, :h_s] = tables[s][0].weights

    noop = np.zeros(S, dtype=bool)
    if pad_steps_to is not None and pad_steps_to > S:
        extra = pad_steps_to - S

        def pad0(a):
            return np.concatenate([a, np.repeat(a[-1:], extra, axis=0)], axis=0)

        from_levels, to_levels, context_masks = map(pad0, (from_levels, to_levels, context_masks))
        override_mask, override_levels = pad0(override_mask), pad0(override_levels)
        cond_mask, weights = pad0(cond_mask), pad0(weights)
        gen_excluded, gen_coverage = pad0(gen_excluded), pad0(gen_coverage)
        renoise = np.concatenate([renoise, np.zeros(extra, dtype=bool)])
        noop = np.concatenate([noop, np.ones(extra, dtype=bool)])

    return SamplingPlan(
        from_levels.astype(np.int32),
        to_levels.astype(np.int32),
        context_masks.astype(np.int32),
        override_mask,
        override_levels,
        cond_mask,
        weights,
        gen_excluded,
        gen_coverage,
        renoise,
        noop,
    )


def make_window_sampler(
    model_apply: Callable,
    dcfg: dc.DiffusionConfig,
    sched: dc.Schedule,
    replacement_only: bool = False,
    use_ddpm: bool = False,
    reconstruction_guidance: float = 0.0,
    mesh=None,
    cond_transform: Optional[Callable] = None,
    state_codec=None,
):
    """Build the one-window sampler.

    model_apply(x, noise_input, cond, cond_mask) -> model output, with x
    (N, T, ...), noise_input (N, T) float (discrete k or scaled logSNR),
    cond (N, ...) or None, cond_mask (N,) bool.

    Returns sample_window(x_init, plan, conditions, generator, context) ->
    (B, T, ...) samples. ``x_init`` is the noise-initialized window with the
    context installed; ``context`` the clean context (zeros elsewhere),
    which reconstruction guidance needs. ``cond_transform`` maps the
    NFE-expanded conditions once per window (e.g. poses -> ray maps -> pose
    FiLM terms), without gradient. ``state_codec`` = (to_state, from_state)
    keeps the loop state in the model's token layout.

    With ``reconstruction_guidance`` > 0 each denoising step takes the
    gradient of ``-w / 2 * sum(sqrt(alpha) * (x0_pred - context)^2)`` over
    the context frames (each row divided by its count of context frames)
    with respect to the model's input alone, and moves the predicted noise
    by ``sqrt(1 - alpha)`` times its negation (``dfot_tpu/sampling/
    sampler.py:362-383``).
    """
    rows = _data_rows(mesh)

    def noise_input(k_clipped):
        if dcfg.is_continuous:
            return continuous_model_noise_input(dcfg, sched, k_clipped)
        return k_clipped.float()

    def predictions(x_e, k_clip, cond_e, condmask_e):
        model_out = model_apply(x_e, noise_input(k_clip), cond_e, condmask_e)
        return dc.model_predictions(sched, dcfg, x_e, k_clip, model_out)

    def guided_predictions(x_e, k_clip, cond_e, condmask_e, ctx_e, ctxmask_e):
        """The model's predictions at x_e, the noise moved along the
        gradient of the reconstruction loss with respect to x_e."""
        alpha = dc.bcast_right(sched.alphas_cumprod[k_clip.long()], x_e.ndim)
        x_in = x_e.detach().requires_grad_(True)
        with torch.enable_grad():
            model_out = model_apply(x_in, noise_input(k_clip), cond_e, condmask_e)
            pred_in = dc.model_predictions(sched, dcfg, x_in, k_clip, model_out)
            mse = (pred_in.pred_x_start - ctx_e) ** 2 * alpha.sqrt()
            m = dc.bcast_right((ctxmask_e > 0).to(mse.dtype), mse.ndim)
            denom = m.sum(dim=1, keepdim=True).clamp(min=1)
            likelihood = -reconstruction_guidance * 0.5 * (mse * m / denom).sum()
            (grad,) = torch.autograd.grad(likelihood, x_in)
        grad = torch.nan_to_num(-grad)
        model_out = model_out.detach()
        pred = dc.model_predictions(sched, dcfg, x_e, k_clip, model_out)
        pred_noise = pred.pred_noise + (1 - alpha).sqrt() * grad
        x_start = torch.where(
            alpha > 0, dc.predict_start_from_noise(sched, x_e, k_clip, pred_noise),
            pred.pred_x_start)
        return dc.ModelPrediction(pred_noise, x_start, model_out)

    @torch.no_grad()
    def sample_window(x_init, plan: SamplingPlan, conditions, generator=None, context=None):
        if state_codec is not None:
            to_state, from_state = state_codec
            x_init = to_state(x_init)
        dev = x_init.device
        B = x_init.shape[0]
        nfe = plan.nfe
        cond_e = None if conditions is None else torch.repeat_interleave(conditions, nfe, dim=0)
        if cond_e is not None and cond_transform is not None:
            cond_e = cond_transform(cond_e)
        ctx_e = None
        if reconstruction_guidance > 0:
            if context is None:
                raise ValueError("reconstruction guidance needs the clean context")
            if state_codec is not None:
                context = to_state(context)
            ctx_e = torch.repeat_interleave(context, nfe, dim=0)
        steps = SamplingPlan(*(torch.as_tensor(a, device=dev) for a in plan))

        def noise_like(x):
            return dc.clipped_normal(x.shape, dcfg.clip_noise, generator, dev, x.dtype)

        def q_sample_fn(x, k):
            return dc.q_sample(sched, x, k.clamp(min=0), noise_like(x))

        xs = x_init
        for s in range(plan.num_steps):
            if plan.noop[s]:
                continue
            fl, tl, cmask = steps.from_levels[s], steps.to_levels[s], steps.context_masks[s]
            if plan.renoise[s]:
                xs = dc.q_sample_from_x_k(
                    sched, dcfg.timesteps, xs, fl.clamp(min=0), tl.clamp(min=0), noise_like(xs)
                )
                continue
            host_table = HGTable(*(a[s] for a in plan[3:9]))
            dev_table = HGTable(*(a[s] for a in steps[3:9]))
            x_e, from_e, to_e, condmask_e = hg_prepare(
                xs, fl, tl, cmask, host_table, dev_table, q_sample_fn,
                dcfg.timesteps, replacement_only, generator,
            )
            k_clip = from_e.clamp(min=0)
            if ctx_e is not None:
                pred = rows(guided_predictions, x_e, k_clip, cond_e, condmask_e, ctx_e,
                            torch.repeat_interleave(cmask, nfe, dim=0))
            else:
                pred = rows(predictions, x_e, k_clip, cond_e, condmask_e)
            # DDIM with eta = 0 multiplies its noise by zero: skip the draw
            noise = noise_like(x_e) if use_ddpm or dcfg.ddim_sampling_eta > 0 else 0.0
            if use_ddpm:
                x_pred = dc.ddpm_step(sched, dcfg, x_e, from_e, pred, noise)
            else:
                x_pred = dc.ddim_step(sched, dcfg, x_e, from_e, to_e, pred, noise)
            composed = hg_compose(x_pred, dev_table, B)
            # revert everything except the tokens being generated
            xs = torch.where(dc.bcast_right(cmask == 0, xs.ndim), composed, xs)
        return from_state(xs) if state_codec is not None else xs

    return sample_window
