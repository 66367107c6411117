"""Sampling scheduling matrices — host numpy.

A copy of the parts of ``dfot_tpu/sampling/scheduling.py`` the port's
sampler uses: the ``full_sequence`` matrix (all tokens on one DDIM grid)
and the go-back refinement matrix. A scheduling matrix is an
(num_rows, horizon) int array of noise levels; consecutive rows define one
step. ``tests/test_torch_port_sampling.py`` holds the copy equal to the
original (the JAX package's ``sampling/__init__`` imports jax).
"""

from __future__ import annotations

import numpy as np

from ..diffusion.core import ddim_idx_to_noise_level

__all__ = [
    "full_sequence_scheduling_matrix",
    "refine_index_sequence",
    "generate_scheduling_matrix",
    "generate_refine_scheduling_matrix",
]


def full_sequence_scheduling_matrix(horizon: int, sampling_timesteps: int) -> np.ndarray:
    """All tokens denoise in lockstep: rows S, S-1, ..., 0."""
    col = np.arange(sampling_timesteps, -1, -1, dtype=np.int64)
    return np.repeat(col[:, None], horizon, axis=1)


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
    if name != "full_sequence":
        raise NotImplementedError(f"scheduling matrix {name!r} is not ported")
    mat = full_sequence_scheduling_matrix(horizon, sampling_timesteps)
    mat = ddim_idx_to_noise_level(timesteps, sampling_timesteps, mat)
    return _pad(mat, padding, timesteps)


def generate_refine_scheduling_matrix(horizon: int, timesteps: int, sampling_timesteps: int,
                                      goback_length: int, n_goback: int,
                                      padding: int = 0) -> np.ndarray:
    """Full-sequence matrix with go-back resampling excursions."""
    idx = refine_index_sequence(sampling_timesteps, goback_length, n_goback)
    levels = ddim_idx_to_noise_level(timesteps, sampling_timesteps, idx)
    return _pad(np.repeat(levels[:, None], horizon, axis=1), padding, timesteps)
