"""Frechet distance (FID/FVD) and Inception Score accumulators.

A copy of ``dfot_tpu/metrics/frechet.py``: host code in numpy float64.
Features arrive as float64 arrays (the metric networks' outputs, moved off
the device); the accumulators keep feature sums and outer-product sums per
distribution, and ``compute`` returns
||mu1 - mu2||^2 + tr(S1 + S2 - 2 sqrt(S1 S2)) with ``scipy.linalg.sqrtm``,
retried with ``eps`` on the diagonal where the first root is not finite,
its real part taken.
"""

from __future__ import annotations


import numpy as np
from scipy import linalg

__all__ = ["FrechetDistance", "InceptionScore", "frechet_distance"]


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


class FrechetDistance:
    """Streaming mean/covariance accumulator over two feature sets."""

    def __init__(self, dim: int):
        self.dim = dim
        self.reset()

    def reset(self) -> None:
        self._sum = [np.zeros(self.dim), np.zeros(self.dim)]
        self._outer = [np.zeros((self.dim, self.dim)), np.zeros((self.dim, self.dim))]
        self._n = [0, 0]

    def update(self, features: np.ndarray, real: bool) -> None:
        i = 0 if real else 1
        f = np.asarray(features, dtype=np.float64)
        self._sum[i] += f.sum(0)
        self._outer[i] += f.T @ f
        self._n[i] += f.shape[0]

    def compute(self) -> float:
        stats = []
        for i in range(2):
            n = max(self._n[i], 1)
            mu = self._sum[i] / n
            denom = max(n - 1, 1)
            sigma = (self._outer[i] - n * np.outer(mu, mu)) / denom
            stats.append((mu, sigma))
        return frechet_distance(stats[0][0], stats[0][1], stats[1][0], stats[1][1])


class InceptionScore:
    """IS over accumulated class logits (reference: metrics/video/is.py)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._probs = []

    def update(self, logits: np.ndarray) -> None:
        logits = np.asarray(logits, dtype=np.float64)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        self._probs.append(e / e.sum(-1, keepdims=True))

    def compute(self) -> float:
        if not self._probs:
            return 0.0
        p = np.concatenate(self._probs, axis=0)
        marginal = p.mean(0, keepdims=True)
        kl = (p * (np.log(p + 1e-12) - np.log(marginal + 1e-12))).sum(-1)
        return float(np.exp(kl.mean()))
