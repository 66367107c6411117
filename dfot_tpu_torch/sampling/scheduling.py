"""Sampling scheduling matrices — host numpy.

A copy of the matrices of ``dfot_tpu/sampling/scheduling.py``:
``full_sequence`` (all tokens on one DDIM grid), ``autoregressive`` (a
pyramid: later tokens lag behind earlier ones), ``interleaved`` (tokens
advance in staggered bursts), ``gibbs`` (full_sequence swept one token at a
time per level) and the go-back refinement matrix. A scheduling matrix is an
(num_rows, horizon) int array of noise levels; consecutive rows define one
step. ``tests/test_torch_port_sampling.py`` holds the copy equal to the
original (the JAX package's ``sampling/__init__`` imports jax).
"""

from __future__ import annotations

import numpy as np

from ..diffusion.core import ddim_idx_to_noise_level

__all__ = [
    "full_sequence_scheduling_matrix",
    "pyramid_scheduling_matrix",
    "interleaved_scheduling_matrix",
    "gibbs_expand",
    "refine_index_sequence",
    "generate_scheduling_matrix",
    "generate_refine_scheduling_matrix",
]


def full_sequence_scheduling_matrix(horizon: int, sampling_timesteps: int) -> np.ndarray:
    """All tokens denoise in lockstep: rows S, S-1, ..., 0."""
    col = np.arange(sampling_timesteps, -1, -1, dtype=np.int64)
    return np.repeat(col[:, None], horizon, axis=1)


def pyramid_scheduling_matrix(horizon: int, sampling_timesteps: int,
                              uncertainty_scale: float = 1.0) -> np.ndarray:
    """Autoregressive pyramid: token t starts uncertainty_scale * t steps
    later."""
    height = sampling_timesteps + int((horizon - 1) * uncertainty_scale) + 1
    m = np.arange(height, dtype=np.int64)[:, None]
    t = np.arange(horizon, dtype=np.int64)[None, :]
    mat = sampling_timesteps + (t * uncertainty_scale).astype(np.int64) - m
    return np.clip(mat, 0, sampling_timesteps)


def interleaved_scheduling_matrix(horizon: int, interleaved_size: int = 3,
                                  sampling_timesteps: int = 50) -> np.ndarray:
    """Tokens advance in bursts of ``interleaved_size`` steps, staggered by
    their position modulo ``interleaved_size``."""
    rows = []
    max_length = sampling_timesteps + interleaved_size
    for i in range(horizon):
        start_idx = i % interleaved_size + 1
        levels = [sampling_timesteps] * start_idx
        for j in range(sampling_timesteps):
            idx = max(sampling_timesteps - start_idx - interleaved_size * j, 0)
            if idx == 0:
                levels += [idx] * (max_length - len(levels))
                break
            levels += [idx] * interleaved_size
        rows.append(levels)
    return np.asarray(rows, dtype=np.int64).T


def gibbs_expand(matrix: np.ndarray, horizon: int) -> np.ndarray:
    """Expand a full-sequence matrix into a Gibbs sweep: within each level
    transition tokens update one at a time left to right, while the tokens
    to their right stay at the previous level."""
    n_rows = matrix.shape[0]
    out = np.repeat(matrix, horizon, axis=0)
    for i in range(1, n_rows):
        for j in range(horizon):
            out[i * horizon + j, j + 1:] = out[(i - 1) * horizon + horizon - 1, j + 1:]
    return out


def refine_index_sequence(sampling_timesteps: int, goback_length: int, n_goback: int) -> np.ndarray:
    """DDIM-grid index sequence with periodic go-back excursions: descend
    S..0; at each anchor repeat n_goback times an up-excursion of
    goback_length and back down."""
    goback_idxs = set(range(1, sampling_timesteps - goback_length, goback_length))
    seq = []
    for t in range(sampling_timesteps, -1, -1):
        seq.append(t)
        if t in goback_idxs:
            for _ in range(n_goback):
                seq.extend(range(t + 1, t + goback_length + 1))
                seq.extend(range(t + goback_length - 1, t - 1, -1))
    return np.asarray(seq, dtype=np.int64)


def _pad(mat: np.ndarray, padding: int, timesteps: int) -> np.ndarray:
    if padding <= 0:
        return mat
    pad = np.full((mat.shape[0], padding), timesteps - 1, dtype=np.int64)
    return np.concatenate([mat, pad], axis=1)


def generate_scheduling_matrix(name: str, horizon: int, timesteps: int,
                               sampling_timesteps: int, padding: int = 0) -> np.ndarray:
    """Noise-level scheduling matrix, int64 (rows, horizon + padding);
    padded columns are pure noise (timesteps - 1)."""
    if name in ("full_sequence", "gibbs"):
        mat = full_sequence_scheduling_matrix(horizon, sampling_timesteps)
    elif name == "autoregressive":
        mat = pyramid_scheduling_matrix(horizon, sampling_timesteps)
    elif name == "interleaved":
        mat = interleaved_scheduling_matrix(horizon, 3, sampling_timesteps)
    else:
        raise ValueError(f"unknown scheduling matrix {name!r}")
    mat = ddim_idx_to_noise_level(timesteps, sampling_timesteps, mat)
    if name == "gibbs":
        mat = gibbs_expand(mat, horizon)
    return _pad(mat, padding, timesteps)


def generate_refine_scheduling_matrix(horizon: int, timesteps: int, sampling_timesteps: int,
                                      goback_length: int, n_goback: int,
                                      padding: int = 0) -> np.ndarray:
    """Full-sequence matrix with go-back resampling excursions."""
    idx = refine_index_sequence(sampling_timesteps, goback_length, n_goback)
    levels = ddim_idx_to_noise_level(timesteps, sampling_timesteps, idx)
    return _pad(np.repeat(levels[:, None], horizon, axis=1), padding, timesteps)
