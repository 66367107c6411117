"""Training noise-level generation, per token (B, T).

Port of ``dfot_tpu/training/noise_levels.py``:

- random_independent : iid per token (Diffusion Forcing)
- random_uniform     : one level per video (classic video diffusion)
- interleaved        : one level for odd, one for even tokens
- uniform_future     : context keeps iid levels, future shares one level
- fixed/variable context masks for the standard-diffusion baselines, with
  context dropout (context tokens forced to max noise with prob ``dropout``),
- unavailable frames (mask False) forced to max noise.

Random draws come from an explicit ``torch.Generator`` on the device of the
frame mask. PyTorch and JAX draw different streams from one seed, so every
draw can also be injected (``draws``), which is how the parity tests feed
both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["NoiseLevelConfig", "draw_rows", "training_noise_levels"]


@dataclasses.dataclass(frozen=True)
class NoiseLevelConfig:
    noise_level: str = "random_independent"
    timesteps: int = 1000
    is_continuous: bool = False
    n_context_tokens: int = 0
    uniform_future: bool = False
    fixed_context: bool = False
    fixed_context_indices: Optional[Tuple[int, ...]] = None
    fixed_context_dropout: float = 0.0
    variable_context: bool = False
    variable_context_prob: float = 0.25
    variable_context_dropout: float = 0.3

    @classmethod
    def from_config(cls, algo_cfg, timesteps: int, n_context_tokens: int) -> "NoiseLevelConfig":
        """From the ``algorithm`` config node."""
        fc, vc = algo_cfg.fixed_context, algo_cfg.variable_context
        idx = fc.get("indices")
        return cls(
            noise_level=algo_cfg.noise_level,
            timesteps=timesteps,
            is_continuous=algo_cfg.diffusion.get("is_continuous", False),
            n_context_tokens=n_context_tokens,
            uniform_future=algo_cfg.uniform_future.enabled,
            fixed_context=fc.enabled,
            fixed_context_indices=tuple(idx) if idx else None,
            fixed_context_dropout=fc.get("dropout", 0.0),
            variable_context=vc.enabled,
            variable_context_prob=vc.get("prob", 0.25),
            variable_context_dropout=vc.get("dropout", 0.3),
        )


def draw_rows(fn: Callable, shape, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``fn(shape)``; with ``rows=(index, count)``, ``fn`` drawn for the
    global batch of ``count`` times ``shape[0]`` rows and this share's rows
    ``index::count`` taken, so that the processes together draw what one
    process draws for the global batch."""
    if rows is None:
        return fn(shape)
    index, count = rows
    return fn((shape[0] * count,) + tuple(shape[1:]))[index::count]


def training_noise_levels(
    generator: Optional[torch.Generator],
    cfg: NoiseLevelConfig,
    frame_mask: torch.Tensor,  # (B, T) bool: frame available?
    train: bool = True,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    rows: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(noise levels (B, T), loss mask (B, T) bool).

    Levels are fp32 in [0, 1) for continuous diffusion, int64 in
    [0, timesteps) otherwise. ``draws`` may hold any of the random parts and
    then replaces the generator for it: ``"levels"`` ((B, T), (B, 1) or
    (B, 2) by mode), ``"future"`` (B, 1), ``"context"`` (B, T) bool,
    ``"context_drop"`` (B, 1) bool. ``rows=(index, count)``: the batch is
    one of ``count`` data-parallel shares, the rows ``index::count`` of the
    global batch; each generator draw is then made for the global batch of
    ``count`` B rows and this share's rows taken, so that the processes
    together draw what one process draws for the global batch.
    """
    B, T = frame_mask.shape
    dev = frame_mask.device
    draws = draws or {}

    def levels_of(name, shape):
        if name in draws:
            got = torch.as_tensor(draws[name], device=dev)
            if tuple(got.shape) != shape:
                raise ValueError(f"draws[{name!r}] must be {shape}, got {tuple(got.shape)}")
            return got.float() if cfg.is_continuous else got.long()
        if cfg.is_continuous:
            return draw_rows(lambda s: torch.rand(s, generator=generator, device=dev), shape,
                             rows)
        return draw_rows(lambda s: torch.randint(0, cfg.timesteps, s, generator=generator,
                                                 device=dev), shape, rows)

    def bernoulli_of(name, p, shape):
        if name in draws:
            return torch.as_tensor(draws[name], device=dev).bool().reshape(shape)
        return draw_rows(lambda s: torch.rand(s, generator=generator, device=dev), shape,
                         rows) < p

    if cfg.noise_level == "random_independent":
        levels = levels_of("levels", (B, T))
    elif cfg.noise_level == "random_uniform":
        levels = levels_of("levels", (B, 1)).expand(B, T)
    elif cfg.noise_level == "interleaved":
        pair = levels_of("levels", (B, 2))
        levels = pair[:, torch.arange(T, device=dev) % 2]
    else:
        raise ValueError(f"unknown noise_level {cfg.noise_level}")

    if cfg.uniform_future:
        future = levels_of("future", (B, 1)).expand(B, T)
        is_future = torch.arange(T, device=dev)[None] >= cfg.n_context_tokens
        levels = torch.where(is_future, future, levels)

    max_level = 1.0 if cfg.is_continuous else cfg.timesteps - 1
    levels = torch.where(frame_mask, levels, torch.full_like(levels, max_level))

    loss_mask = frame_mask
    context_mask = None
    if cfg.variable_context:
        context_mask = bernoulli_of("context", cfg.variable_context_prob, (B, T))
        dropout = cfg.variable_context_dropout
    elif cfg.fixed_context:
        idx = (
            list(cfg.fixed_context_indices) if cfg.fixed_context_indices is not None
            else list(range(cfg.n_context_tokens))
        )
        context_mask = torch.zeros((B, T), dtype=torch.bool, device=dev)
        context_mask[:, idx] = True
        dropout = cfg.fixed_context_dropout

    if context_mask is not None:
        # per-video context dropout: the context is forced to max noise (CFG)
        dropped = bernoulli_of("context_drop", dropout if train else 0.0, (B, 1))
        ctx_levels = dropped.to(levels.dtype) * (1 if cfg.is_continuous else cfg.timesteps - 1)
        levels = torch.where(context_mask, ctx_levels.expand(B, T), levels)
        loss_mask = loss_mask & ~context_mask  # context frames carry no loss

    return levels, loss_mask
