"""Diagonal Gaussian posterior of the KL autoencoders.

Port of ``dfot_tpu/vae/distribution.py:DiagonalGaussian`` (:19): the
parameters are (mean | logvar) concatenated along the channel axis, which
is ``dim`` here (1 for the port's channel-first modules, -1 for
channel-last tensors); the log-variance is clipped to [-30, 20].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

__all__ = ["DiagonalGaussian"]


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_parameters(cls, parameters: torch.Tensor, dim: int = 1) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(parameters, 2, dim=dim)
        return cls(mean, logvar.clamp(-30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * eps, with ``eps`` given or drawn from ``generator``."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                              dtype=self.mean.dtype)
        return self.mean + self.std * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussian"] = None) -> torch.Tensor:
        """KL divergence, summed over all non-batch axes -> (B,)."""
        dims = tuple(range(1, self.mean.ndim))
        if other is None:
            return 0.5 * torch.sum(self.mean ** 2 + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var + self.var / other.var - 1.0
            - self.logvar + other.logvar, dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar + (sample - self.mean) ** 2 / self.var,
            dim=dims)
