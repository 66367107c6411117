"""History Guidance (HG): compositional guidance over history subsets.

Port of ``dfot_tpu/guidance/history_guidance.py``. The host planner
(:class:`HistorySegment`, :class:`HGTable`, :class:`HistoryGuidance`) is a
numpy copy of the JAX package's (whose module imports jax), with every
scheme's factory, ``from_config`` and ``plan_batched``;
``tests/test_torch_port_sampling.py`` and ``tests/test_torch_port_rollout.py``
hold its tables equal to the original's. :func:`hg_prepare` and
:func:`hg_compose` are the device side on tensors: expand the batch by NFE =
num_hist * num_gen and install the partial-history conditions, then take the
weighted composition.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

ALL = "all"
FreqRange = Union[Tuple[float, float], str]

__all__ = ["HistorySegment", "HistoryGuidance", "HGTable", "hg_prepare", "hg_compose"]


@dataclasses.dataclass(frozen=True)
class HistorySegment:
    """One chosen patch-set of the history's (time x frequency) grid: the
    chosen history tokens (or ALL) and per token a (lo, hi) noise band."""

    time_indices: Union[Sequence[int], str] = ALL
    freq_ranges: Tuple[FreqRange, ...] = (ALL,)
    freq_ranges_if_generated: Optional[Tuple[FreqRange, ...]] = None

    @staticmethod
    def _process(freq_ranges: Sequence[FreqRange], n: int) -> List[Tuple[float, float]]:
        fr = [(0.0, 1.0) if f == ALL else tuple(f) for f in freq_ranges]
        if len(fr) == n:
            return fr
        if len(fr) == 2:
            if n == 1:
                return [fr[1]]
            (s0, e0), (s1, e1) = fr
            return [
                (s0 + (s1 - s0) * t / (n - 1), e0 + (e1 - e0) * t / (n - 1))
                for t in range(n)
            ]
        if len(fr) == 1:
            return fr * n
        raise ValueError(f"freq_ranges length {len(fr)} incompatible with {n} tokens")

    def to_noise_levels(self, generated_mask: np.ndarray):
        """(start_levels, end_levels) over the history; unchosen tokens get
        (1, 1) == fully masked."""
        hist_len = int(generated_mask.shape[0])
        if hist_len == 0:
            return (), ()
        idx = (
            list(range(hist_len))
            if self.time_indices == ALL
            else [t if t >= 0 else hist_len + t for t in self.time_indices]
        )
        if any(t >= hist_len for t in idx):
            raise ValueError("time_indices out of range of the history")
        fr = self._process(self.freq_ranges, len(idx))
        fr_gen = self._process(
            self.freq_ranges if self.freq_ranges_if_generated is None
            else self.freq_ranges_if_generated,
            len(idx),
        )
        final = [(1.0, 1.0)] * hist_len
        for i, t in enumerate(idx):
            final[t] = fr_gen[i] if generated_mask[t] else fr[i]
        starts, ends = zip(*final)
        return tuple(starts), tuple(ends)

    @classmethod
    def full(cls) -> "HistorySegment":
        return cls(ALL, (ALL,))

    @classmethod
    def partial_constant(cls, lo: float, hi: float) -> "HistorySegment":
        return cls(ALL, ((lo, hi),))


class HGTable(NamedTuple):
    """Static-shape tables for one sampling step (host numpy), B' in {1, B}:
    override_mask/levels (B', H, T), cond_mask (H,), weights (H,),
    gen_excluded (B', G, T), gen_coverage (B', T)."""

    override_mask: np.ndarray
    override_levels: np.ndarray
    cond_mask: np.ndarray
    weights: np.ndarray
    gen_excluded: np.ndarray
    gen_coverage: np.ndarray

    @property
    def num_hist(self) -> int:
        return self.weights.shape[0]

    @property
    def num_gen(self) -> int:
        return self.gen_excluded.shape[1]


@dataclasses.dataclass(frozen=True)
class HistoryGuidance:
    """An HG scheme: the composition recipe, independent of any mask."""

    hist_segments: Tuple[HistorySegment, ...]
    hist_weights: Tuple[float, ...]
    gen_segments: Tuple[Union[Tuple[int, ...], str], ...] = (ALL,)
    timesteps: int = 1000
    use_external_cond_guidance: bool = False

    def __post_init__(self):
        if len(self.hist_segments) != len(self.hist_weights):
            raise ValueError("hist_segments and hist_weights length mismatch")
        if len(self.gen_segments) == 0:
            raise ValueError("need at least one gen_segment")

    # ----- factories of the reference schemes; ``**_`` lets from_config pass
    # a recipe's extra keys through

    @classmethod
    def conditional(cls, timesteps: int = 1000, **_) -> "HistoryGuidance":
        return cls((HistorySegment.full(),), (1.0,), timesteps=timesteps)

    @classmethod
    def stabilized_conditional(cls, stabilization_level: float, timesteps: int = 1000,
                               **_) -> "HistoryGuidance":
        seg = HistorySegment(ALL, (ALL,), ((stabilization_level, 1.0),))
        return cls((seg,), (1.0,), timesteps=timesteps)

    @classmethod
    def vanilla(cls, guidance_scale: float, timesteps: int = 1000,
                use_external_cond_guidance: bool = True, **_) -> "HistoryGuidance":
        return cls(
            (HistorySegment.full(),), (float(guidance_scale),), timesteps=timesteps,
            use_external_cond_guidance=use_external_cond_guidance,
        )

    @classmethod
    def stabilized_vanilla(cls, guidance_scale: float, stabilization_level: float,
                           timesteps: int = 1000, use_external_cond_guidance: bool = True,
                           **_) -> "HistoryGuidance":
        seg = HistorySegment(ALL, (ALL,), ((stabilization_level, 1.0),))
        return cls(
            (seg,), (float(guidance_scale),), timesteps=timesteps,
            use_external_cond_guidance=use_external_cond_guidance,
        )

    @classmethod
    def fractional(cls, guidance_scale: float, freq_scale: float, timesteps: int = 1000,
                   use_external_cond_guidance: bool = True, **_) -> "HistoryGuidance":
        return cls(
            (HistorySegment.full(), HistorySegment.partial_constant(freq_scale, 1.0)),
            (1.0, float(guidance_scale) - 1.0), timesteps=timesteps,
            use_external_cond_guidance=use_external_cond_guidance,
        )

    @classmethod
    def stabilized_fractional(cls, guidance_scale: float, freq_scale: float,
                              stabilization_level: float, timesteps: int = 1000,
                              use_external_cond_guidance: bool = True,
                              **_) -> "HistoryGuidance":
        return cls(
            (HistorySegment(ALL, (ALL,), ((stabilization_level, 1.0),)),
             HistorySegment.partial_constant(freq_scale, 1.0)),
            (1.0, float(guidance_scale) - 1.0), timesteps=timesteps,
            use_external_cond_guidance=use_external_cond_guidance,
        )

    @classmethod
    def temporal(cls, hist_subsequences: Sequence[Union[Sequence[int], str]],
                 hist_weights: Sequence[float], gen_segments: Optional[Sequence] = None,
                 timesteps: int = 1000, use_external_cond_guidance: bool = True,
                 **_) -> "HistoryGuidance":
        return cls(
            tuple(HistorySegment(tuple(s) if s != ALL else ALL) for s in hist_subsequences),
            tuple(float(w) for w in hist_weights),
            tuple(tuple(g) if g != ALL else ALL for g in (gen_segments or [ALL])),
            timesteps=timesteps,
            use_external_cond_guidance=use_external_cond_guidance,
        )

    @classmethod
    def custom(cls, hist_segments: Sequence[Dict], hist_weights: Sequence[float],
               gen_segments: Optional[Sequence] = None, timesteps: int = 1000,
               use_external_cond_guidance: bool = True, **_) -> "HistoryGuidance":
        def _tup(fr):
            if fr is None:
                return None
            return tuple(tuple(f) if f != ALL else ALL for f in fr)

        segs = tuple(
            HistorySegment(
                time_indices=tuple(s["time_indices"]) if s["time_indices"] != ALL else ALL,
                freq_ranges=_tup(s.get("freq_ranges")) or (ALL,),
                freq_ranges_if_generated=_tup(s.get("freq_ranges_if_generated")),
            )
            for s in hist_segments
        )
        return cls(
            segs,
            tuple(float(w) for w in hist_weights),
            tuple(tuple(g) if g != ALL else ALL for g in (gen_segments or [ALL])),
            timesteps=timesteps,
            use_external_cond_guidance=use_external_cond_guidance,
        )

    @classmethod
    def from_config(cls, cfg, timesteps: int = 1000) -> "HistoryGuidance":
        """The scheme a recipe names (``tasks.*.history_guidance``): a plain
        mapping, or any object with ``to_dict()``, holding ``name`` and the
        factory's arguments."""
        kwargs = cfg.to_dict() if hasattr(cfg, "to_dict") else dict(cfg)
        name = kwargs.pop("name")
        return getattr(cls, name)(**kwargs, timesteps=timesteps)

    def plan(self, context_mask: np.ndarray) -> HGTable:
        """Deduplicated condition table for one (T,) mask in {-1, 0, 1, 2}."""
        mask = np.asarray(context_mask, dtype=np.int64)
        if mask.ndim != 1:
            raise ValueError("plan() takes a single (T,) mask")
        T = mask.shape[0]
        hist_idx = np.flatnonzero(mask >= 1)
        gen_idx = np.flatnonzero(mask == 0)
        hist_len, gen_len = len(hist_idx), len(gen_idx)

        gen_segments = [list(range(gen_len)) if g == ALL else list(g) for g in self.gen_segments]
        G = len(gen_segments)
        gen_mask = np.zeros((G, T), dtype=bool)
        for i, seg in enumerate(gen_segments):
            gen_mask[i, gen_idx[seg]] = True

        # key = per-history-token noise fraction + external-cond-mask flag
        table: Dict[tuple, float] = {}
        uncond_key = (1.0,) * hist_len + (bool(self.use_external_cond_guidance),)
        table[uncond_key] = 1.0
        generated = mask[hist_idx] == 2
        for seg, w in zip(self.hist_segments, self.hist_weights):
            starts, ends = seg.to_noise_levels(generated)
            k_start = starts + (False,)
            k_end = ends + (bool(self.use_external_cond_guidance),)
            table[k_start] = table.get(k_start, 0.0) + w
            table[k_end] = table.get(k_end, 0.0) - w

        levels, cond, weights = [], [], []
        for key, w in table.items():
            if w == 0:
                continue
            levels.append(key[:-1])
            cond.append(key[-1])
            weights.append(w)
        H = len(weights)
        # fraction -> discrete level trunc(f * timesteps - 1), in float32
        lv = (
            np.trunc(
                np.asarray(levels, dtype=np.float32) * np.float32(self.timesteps)
                - np.float32(1.0)
            ).astype(np.int32)
            if hist_len > 0
            else np.zeros((H, 0), np.int32)
        )
        override_mask = np.zeros((H, T), dtype=bool)
        override_mask[:, hist_idx] = True
        override_levels = np.zeros((H, T), dtype=np.int32)
        override_levels[:, hist_idx] = lv
        gen_excluded = (~gen_mask) & (mask == 0)[None, :]
        coverage = np.clip(gen_mask.sum(axis=0), 1, None).astype(np.int32)
        return HGTable(
            override_mask[None],
            override_levels[None],
            np.asarray(cond, dtype=bool),
            np.asarray(weights, dtype=np.float32),
            gen_excluded[None],
            coverage[None],
        )

    def plan_batched(self, context_masks: np.ndarray) -> HGTable:
        """Plan for a (B, T) batch of masks, each of which may differ. All
        masks must give the same num_hist and weights (true of every factory
        scheme, whose table size does not depend on the mask)."""
        tables = [self.plan(m) for m in np.asarray(context_masks)]
        H = {t.num_hist for t in tables}
        if len(H) != 1:
            raise ValueError(
                "per-batch masks produced different numbers of history "
                f"conditions ({sorted(H)}); batch them separately"
            )
        if any((t.cond_mask != tables[0].cond_mask).any() for t in tables) or any(
            not np.allclose(t.weights, tables[0].weights) for t in tables
        ):
            raise ValueError("per-batch masks produced incompatible weight tables")
        return HGTable(
            np.concatenate([t.override_mask for t in tables]),
            np.concatenate([t.override_levels for t in tables]),
            tables[0].cond_mask,
            tables[0].weights,
            np.concatenate([t.gen_excluded for t in tables]),
            np.concatenate([t.gen_coverage for t in tables]),
        )


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def _b(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (ndim - x.ndim))


def hg_prepare(x, from_k, to_k, mask, table: HGTable, dev_table: HGTable, q_sample_fn,
               timesteps: int, replacement_only: bool = False,
               generator: Optional[torch.Generator] = None,
               fresh: Optional[torch.Tensor] = None):
    """Expand the batch by NFE and install the partial-history conditions.

    x: (B, T, *xs); from_k/to_k/mask: (B, T) integer tensors. ``table`` is the
    host table and ``dev_table`` the same arrays as tensors on x's device.
    q_sample_fn(x_flat, k_flat) -> noised x. ``fresh``: the (B, H, G, T,
    *xs) noise of the excluded generation tokens, given (an exported step's
    input) instead of drawn from ``generator``. Returns (x, from_k, to_k,
    cond_mask) with batch B * H * G in (b, h, g) row-major order.
    """
    B, T = from_k.shape
    H, G = table.num_hist, table.num_gen
    xs_shape = tuple(x.shape[1:])

    xh = x[:, None].expand((B, H) + xs_shape)
    fk = from_k[:, None].expand(B, H, T)
    tk = to_k[:, None].expand(B, H, T)
    mh = mask[:, None].expand(B, H, T)
    if not replacement_only:
        fk = torch.where(dev_table.override_mask, dev_table.override_levels, fk)
        tk = torch.where(dev_table.override_mask, dev_table.override_levels, tk)

    # re-noise history tokens to their condition level
    replace = (fk >= 0) & (mh >= 1)
    noised = q_sample_fn(
        xh.reshape((B * H,) + xs_shape), fk.reshape(B * H, T)
    ).reshape(xh.shape)
    xh = torch.where(_b(replace, xh.ndim), noised, xh)

    xg = xh[:, :, None].expand((B, H, G) + xs_shape)
    fk = fk[:, :, None].expand(B, H, G, T)
    tk = tk[:, :, None].expand(B, H, G, T)
    excl = dev_table.gen_excluded[:, None].expand(B, H, G, T)
    fk = torch.where(excl, timesteps - 1, fk)
    tk = torch.where(excl, timesteps - 1, tk)
    if table.gen_excluded.any():  # host check: no draw when nothing is excluded
        if fresh is None:
            fresh = torch.randn(xg.shape, generator=generator, device=xg.device, dtype=xg.dtype)
        xg = torch.where(_b(excl, xg.ndim), fresh, xg)

    cond_mask = dev_table.cond_mask[None, :, None].expand(B, H, G).reshape(B * H * G)
    return (
        xg.reshape((B * H * G,) + xs_shape),
        fk.reshape(B * H * G, T),
        tk.reshape(B * H * G, T),
        cond_mask,
    )


def hg_compose(x: torch.Tensor, dev_table: HGTable, batch_size: int) -> torch.Tensor:
    """Weighted composition of the NFE-expanded outputs back to (B, T, ...):
    zero excluded gen tokens, weight-sum over history conditions, sum over
    gen segments, divide by per-token coverage."""
    H = dev_table.weights.shape[0]
    G = dev_table.gen_excluded.shape[1]
    B, T = batch_size, dev_table.override_mask.shape[-1]
    x = x.reshape((B, H, G) + tuple(x.shape[1:]))
    excl = dev_table.gen_excluded[:, None].expand(B, H, G, T)
    x = torch.where(_b(excl, x.ndim), 0.0, x)
    x = (x * _b(dev_table.weights[None, :], x.ndim)).sum(dim=1).sum(dim=1)
    return x / _b(dev_table.gen_coverage.to(x.dtype), x.ndim)
