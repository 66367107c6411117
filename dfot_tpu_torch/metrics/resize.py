"""Image resize as ``jax.image.resize`` computes it, on tensors.

The metrics resize with ``jax.image.resize`` (antialias on): ``bilinear``
256 -> 299 for InceptionV3 (``dfot_tpu/metrics/inception.py:33``),
``linear`` 256 -> 16 in the registry's Inception fallback
(``registry.py:325``), ``cubic`` 256 -> 224 for CLIP and DINO
(``encoders.py:52``) and ``bilinear`` to the motion tracker's 256
(``motion.py:205``). ``F.interpolate`` is another function: its cubic
coefficient is -0.75 where JAX's Keys kernel takes -0.5, it clamps at the
edges where JAX renormalizes the weights that fall inside, and it does not
widen the kernel when it downsamples.

So each resized dimension gets the weight matrix that JAX's
``scale_and_translate`` builds (``jax/_src/image/scale.py:
compute_weight_mat``), here in numpy float32 with the same operations: a
sample at ``(i + 0.5) / scale - 0.5``, the kernel widened by ``1 / scale``
when downsampling, columns normalized to sum 1, samples outside the input
zeroed. The matrix goes to the tensor's device and the resize is one
product per resized dimension, in the tensor's dtype.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

__all__ = ["resize", "weight_matrix"]

_EPS32 = float(np.finfo(np.float32).eps)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), 1 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic kernel with a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, np.float32(0), out).astype(np.float32)


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_matrix(in_size: int, out_size: int, method: str, antialias: bool = True) -> np.ndarray:
    """(in_size, out_size) float32 weights of one resized dimension."""
    kernel = _KERNELS[method]
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.float32(max(1.0 / scale, 1.0)) if antialias else np.float32(1.0)
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    w = kernel(x.astype(np.float32)).astype(np.float32)
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * _EPS32, w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0).astype(np.float32)
    w.setflags(write=False)
    return w


def resize(x: torch.Tensor, shape: Sequence[int], method: str,
           antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize(x, shape, method, antialias)`` for the linear and
    cubic methods: every dimension whose size changes is resampled."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {tuple(shape)} has not the {x.ndim} dimensions of {tuple(x.shape)}")
    if method not in _KERNELS:
        raise ValueError(f"unsupported resize method {method!r}")
    out = x if x.is_floating_point() else x.float()
    for d, (n_in, n_out) in enumerate(zip(x.shape, shape)):
        if n_in == n_out:
            continue
        w = torch.tensor(weight_matrix(n_in, int(n_out), method, antialias))
        w = w.to(device=out.device, dtype=out.dtype)
        out = torch.movedim(torch.movedim(out, d, -1) @ w, -1, d)
    return out
