"""Channel-wise latent statistics (``dfot_tpu/vae/stats.py``).

Per-channel mean and std over saved channel-last ``.npy`` latents, streamed
in float64: the values a dataset config takes as ``data_mean`` and
``data_std``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["estimate_latent_stats"]


def estimate_latent_stats(latent_paths: List[str],
                          max_files: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std) over the first ``max_files`` files, fp32 (C,) each."""
    count = 0.0
    s1 = s2 = None
    for path in latent_paths[:max_files]:
        arr = np.load(path).astype(np.float64)
        flat = arr.reshape(-1, arr.shape[-1])
        if s1 is None:
            s1, s2 = flat.sum(0), (flat ** 2).sum(0)
        else:
            s1 += flat.sum(0)
            s2 += (flat ** 2).sum(0)
        count += flat.shape[0]
    mean = s1 / count
    std = np.sqrt(np.clip(s2 / count - mean ** 2, 1e-12, None))
    return mean.astype(np.float32), std.astype(np.float32)
