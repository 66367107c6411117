"""I3D (inflated Inception-v1), the video feature network of FVD.

Port of ``dfot_tpu/metrics/i3d.py``: (B, T >= 9, H, W, 3) in [0, 1] ->
(logits (B, 400), pooled features (B, 1024)). Every unit is a bias-free
``Conv3d``, an eval ``BatchNorm3d(eps=1e-3)`` and a ReLU.

flax's ``padding="SAME"`` pads ``k - 1`` in all at stride 1, and at stride
``s`` the total ``(ceil(n / s) - 1) * s + k - n``, the smaller half before:
the 7^3 stride-2 stem pads (2, 3) on an even size, where ``Conv3d(padding=
3)`` would pad (3, 3). The SAME max-pools pad with -inf on the same rule.
Both pad explicitly with ``F.pad``.

Submodule names are the flax module names (``conv1.conv``, ``conv1.bn``,
``mixed_3b.b1b.conv``, ``logits``); ``utils/weights.py:
i3d_state_dict_from_flax`` carries the JAX package's variables across.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["I3D", "same_pads"]


def same_pads(sizes: Sequence[int], kernel: Sequence[int], strides: Sequence[int]) -> Tuple[int, ...]:
    """flax/XLA ``SAME`` padding of the trailing dims, in ``F.pad``'s order
    (last dim first, (before, after) each)."""
    pads = []
    for n, k, s in zip(sizes, kernel, strides):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for lo_hi in reversed(pads) for p in lo_hi)


class Unit3D(nn.Module):
    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), strides=(1, 1, 1)):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.conv = nn.Conv3d(cin, cout, self.kernel, stride=self.strides, bias=False)
        self.bn = nn.BatchNorm3d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, same_pads(x.shape[2:], self.kernel, self.strides))
        return F.relu(self.bn(self.conv(x)))


def max_pool_same(x: torch.Tensor, window, strides) -> torch.Tensor:
    """``nn.max_pool(..., padding="SAME")`` over (B, C, T, H, W)."""
    x = F.pad(x, same_pads(x.shape[2:], window, strides), value=float("-inf"))
    return F.max_pool3d(x, window, strides)


class Mixed(nn.Module):
    """Inception block: four parallel branches concatenated on channels."""

    def __init__(self, cin: int, b0: int, b1: Tuple[int, int], b2: Tuple[int, int], b3: int):
        super().__init__()
        self.b0 = Unit3D(cin, b0)
        self.b1a = Unit3D(cin, b1[0])
        self.b1b = Unit3D(b1[0], b1[1], (3, 3, 3))
        self.b2a = Unit3D(cin, b2[0])
        self.b2b = Unit3D(b2[0], b2[1], (3, 3, 3))
        self.b3 = Unit3D(cin, b3)
        self.out_channels = b0 + b1[1] + b2[1] + b3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y3 = self.b3(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), y3], dim=1)


_MIXED = (  # name, b0, b1, b2, b3; None: a max-pool (window, strides)
    ("mixed_3b", 64, (96, 128), (16, 32), 32),
    ("mixed_3c", 128, (128, 192), (32, 96), 64),
    None,
    ("mixed_4b", 192, (96, 208), (16, 48), 64),
    ("mixed_4c", 160, (112, 224), (24, 64), 64),
    ("mixed_4d", 128, (128, 256), (24, 64), 64),
    ("mixed_4e", 112, (144, 288), (32, 64), 64),
    ("mixed_4f", 256, (160, 320), (32, 128), 128),
    None,
    ("mixed_5b", 256, (160, 320), (32, 128), 128),
    ("mixed_5c", 384, (192, 384), (48, 128), 128),
)
_POOLS = (((3, 3, 3), (2, 2, 2)), ((2, 2, 2), (2, 2, 2)))


class I3D(nn.Module):
    """(B, T, H, W, 3) in [0, 1] -> (logits (B, 400), features (B, 1024))."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.conv1 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.conv2 = Unit3D(64, 64)
        self.conv3 = Unit3D(64, 192, (3, 3, 3))
        cin, self.order = 192, []
        pools = iter(_POOLS)
        for spec in _MIXED:
            if spec is None:
                self.order.append(next(pools))
                continue
            name, *widths = spec
            block = Mixed(cin, *widths)
            self.add_module(name, block)
            self.order.append(name)
            cin = block.out_channels
        self.logits = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor):
        h = (x * 2.0 - 1.0).permute(0, 4, 1, 2, 3)  # (B, 3, T, H, W)
        h = self.conv1(h)
        h = max_pool_same(h, (1, 3, 3), (1, 2, 2))
        h = self.conv3(self.conv2(h))
        h = max_pool_same(h, (1, 3, 3), (1, 2, 2))
        for step in self.order:
            h = getattr(self, step)(h) if isinstance(step, str) else max_pool_same(h, *step)
        pooled = h.mean(dim=(2, 3, 4))
        return self.logits(pooled), pooled
