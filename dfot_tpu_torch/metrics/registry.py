"""The frozen networks of the metrics, built once and shared.

Port of ``dfot_tpu/metrics/registry.py:SharedMetricModelRegistry`` on
``device`` (None: the card). Each network is built at its first use, on the
CPU, then moved to the device, frozen and put in eval mode:

- ``weights_dir/<name>.npz`` present: the flattened flax tree the JAX
  registry loads (``a/b/kernel`` keys, ``registry.py:33-43``), turned into
  the port's state dict by ``utils/weights.py:*_state_dict_from_flax`` and
  checked name for name and shape for shape against the network before it
  loads; a file that does not match raises ``ValueError`` naming it, as
  ``registry.py:_check_tree`` does. ``comparable[name]`` is then True.
- absent: seeded random weights of the port's own and ``comparable[name]``
  False; ``VideoMetric`` then names the metric ``<metric>_uncalibrated``.
  The draws come from a ``torch.Generator`` seeded as the JAX registry's
  ``PRNGKey`` (0; Inception's fallback 42), a different stream from
  JAX's, so the values differ from the JAX package's by construction
  (ROADMAP.md queue C, "Differences by construction"); the tests put JAX's
  draws in to hold the formulas.

Without ``inception.npz`` FID's features are the JAX registry's
random-projection map (``registry.py:309-331``): per-channel mean and
standard deviation under one random matrix, plus the tanh of the frame's
16 x 16 antialiased ``linear`` resize under another.

Every call runs under ``torch.no_grad``, with autocast off and TF32 off
(restored after): the sampler's bf16 autocast and the card's TF32 matmuls
would make the scores drift with the sampler's precision.

RAFT, AMT-S, PIPs2 and MUSIQ (``raft``, ``amt``, ``pips``, ``musiq``) have
no random fallback in JAX either: without their file they return None and
the metrics take their classical paths. With the file present they raise
``NotImplementedError``: those networks are ROADMAP.md queue A15c.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..diffusion.core import resolve_device
from ..utils.weights import (
    clip_vision_state_dict_from_flax,
    dino_state_dict_from_flax,
    i3d_state_dict_from_flax,
    inception_state_dict_from_flax,
    laion_state_dict_from_npz,
    lpips_state_dict_from_flax,
)
from .resize import resize

__all__ = ["SharedMetricModelRegistry", "RandomProjectionFeatures", "seeded_init", "frozen_math"]

@contextlib.contextmanager
def frozen_math(device: torch.device):
    """No autograd, no autocast on ``device``'s type, TF32 off."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad(), torch.autocast(device.type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


_EMBEDDINGS = ("class_embedding", "positional_embedding", "proj")


@torch.no_grad()
def seeded_init(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initial values for the metric networks, drawn from
    ``generator``: conv and dense weights N(0, 1 / fan_in) (flax's
    lecun_normal, untruncated), biases 0, norm scales 1, CLIP's embeddings
    and projection N(0, width^-1), DINO's position table N(0, 0.02^2) and
    CLS token 0. Running statistics stay at 0 and 1."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _EMBEDDINGS:
            width = p.shape[0] if leaf == "proj" else p.shape[-1]
            p.copy_(torch.randn(p.shape, generator=generator) * width**-0.5)
        elif leaf == "pos_embed":
            p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        elif leaf == "cls_token" or "bias" in leaf:
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator) * fan_in**-0.5)


class RandomProjectionFeatures(nn.Module):
    """FID's features without InceptionV3 weights: (B, H, W, C) in [0, 1]
    -> (B, dim) = tanh(r @ W2 / sqrt(16 * 16 * C)) + p @ W, r the frame
    resized to 16 x 16 (``linear``, antialiased), p the per-channel mean and
    population standard deviation, interleaved. ``matrices[C]`` holds (W,
    W2), drawn at the first frame of C channels (W scaled by 1 / sqrt(2 C)),
    and may be replaced."""

    def __init__(self, dim: int = 2048, seed: int = 42):
        super().__init__()
        self.dim, self.seed = dim, seed
        self.matrices: Dict[int, tuple] = {}

    def _matrices(self, channels: int, device) -> tuple:
        if channels not in self.matrices:
            g = torch.Generator().manual_seed(self.seed)
            w = torch.randn(2 * channels, self.dim, generator=g) / np.sqrt(2 * channels)
            w2 = torch.randn(16 * 16 * channels, self.dim, generator=g)
            self.matrices[channels] = (w.to(device), w2.to(device))
        return tuple(m.to(device=device, dtype=torch.float32) for m in self.matrices[channels])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        w, w2 = self._matrices(C, x.device)
        pooled = torch.stack([x.mean(dim=(1, 2)), x.std(dim=(1, 2), unbiased=False)], -1)
        flat = resize(x, (B, 16, 16, C), "linear").reshape(B, -1)
        return torch.tanh(flat @ w2 / np.sqrt(flat.shape[-1])) + pooled.reshape(B, -1) @ w


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _check_state(name: str, path: str, got: Dict[str, torch.Tensor],
                 want: Dict[str, torch.Tensor]) -> None:
    """Refuse a weights file whose names or shapes are not the network's."""
    got_s = {k: tuple(v.shape) for k, v in got.items()}
    want_s = {k: tuple(v.shape) for k, v in want.items()}
    if got_s != want_s:
        missing = sorted(set(want_s) - set(got_s))[:5]
        extra = sorted(set(got_s) - set(want_s))[:5]
        wrong = sorted(k for k in set(got_s) & set(want_s) if got_s[k] != want_s[k])[:5]
        raise ValueError(f"weights file {path} does not match the {name} model: "
                         f"missing={missing} extra={extra} wrong_shape={wrong}")


class SharedMetricModelRegistry:
    def __init__(self, weights_dir: Optional[str] = None, device=None):
        self.weights_dir = weights_dir
        self.device = resolve_device(device)
        self._models: Dict[str, Callable] = {}
        self.networks: Dict[str, nn.Module] = {}
        self.comparable: Dict[str, bool] = {}

    def _file(self, name: str) -> Optional[str]:
        path = os.path.join(self.weights_dir or "", f"{name}.npz")
        return path if self.weights_dir and os.path.exists(path) else None

    def _network(self, name: str, make: Callable[[], nn.Module], to_state: Callable) -> nn.Module:
        """``name``'s network on the device: the file's weights, else seeded
        random ones."""
        if name not in self.networks:
            with torch.random.fork_rng(devices=[]):
                model = make()
            path = self._file(name)
            if path is not None:
                with np.load(path) as f:
                    state = to_state(_unflatten(dict(f)))
                _check_state(name, path, state, model.state_dict())
                model.load_state_dict(state, strict=True)
            else:
                seeded_init(model, torch.Generator().manual_seed(0))
            self.comparable[name] = path is not None
            self.networks[name] = model.eval().requires_grad_(False).to(self.device)
        return self.networks[name]

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=torch.float32)

    def _serve(self, name: str, build: Callable[[], Callable]) -> Callable:
        if name not in self._models:
            fn = build()

            def call(*xs):
                with frozen_math(self.device):
                    return fn(*(self._input(x) for x in xs))

            self._models[name] = call
        return self._models[name]

    # ------------------------------------------------------------------
    def i3d(self) -> Callable:
        """(B, T >= 9, H, W, 3) in [0, 1] -> (logits (B, 400), feats (B, 1024))."""
        from .i3d import I3D

        return self._serve("i3d", lambda: self._network("i3d", I3D, i3d_state_dict_from_flax))

    def lpips(self) -> Callable:
        """(B, H, W, 3) pairs in [-1, 1] -> (B,) perceptual distances."""
        from ..vae.losses import LPIPS

        def build():
            net = self._network("lpips", LPIPS, lpips_state_dict_from_flax)
            return lambda a, b: net(a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2))

        return self._serve("lpips", build)

    def _encoder(self, name: str, make, to_state) -> Callable:
        return self._serve(name, lambda: self._network(name, make, to_state))

    def clip_b32(self) -> Callable:
        """(B, 224, 224, 3) CLIP-normalized -> (B, 512) embeddings."""
        from . import encoders

        return self._encoder("clip_b32", lambda: encoders.CLIPVisionEncoder(encoders.CLIP_B32),
                             clip_vision_state_dict_from_flax)

    def clip_l14(self) -> Callable:
        """(B, 224, 224, 3) CLIP-normalized -> (B, 768) embeddings."""
        from . import encoders

        return self._encoder("clip_l14", lambda: encoders.CLIPVisionEncoder(encoders.CLIP_L14),
                             clip_vision_state_dict_from_flax)

    def dino(self) -> Callable:
        """(B, 224, 224, 3) ImageNet-normalized -> (B, 768) CLS features."""
        from . import encoders

        return self._encoder("dino", lambda: encoders.DINOEncoder(encoders.DINO_B16),
                             dino_state_dict_from_flax)

    def laion(self) -> Callable:
        """l2-normalized CLIP-L/14 embeddings (B, 768) -> (B, 1) aesthetic
        score, a single ``nn.Linear`` (``laion.npz``: its torch ``weight``
        and ``bias``)."""
        return self._serve("laion", lambda: self._network(
            "laion", lambda: nn.Linear(768, 1), laion_state_dict_from_npz))

    def inception(self) -> Callable:
        """Frame features for FID: (B, H, W, 3) in [0, 1] -> (B, 2048); the
        random-projection map without ``inception.npz``."""
        from .inception import InceptionV3, inception_preprocess

        def build():
            if self._file("inception") is None:
                self.comparable["inception"] = False
                self.networks["inception"] = RandomProjectionFeatures().to(self.device)
                return self.networks["inception"]
            net = self._network("inception", InceptionV3, inception_state_dict_from_flax)
            return lambda x: net(inception_preprocess(x))[0]

        return self._serve("inception", build)

    # ------------------------------------------------------------------
    # the networks of A15c: None without their file, as in JAX
    def _not_ported(self, name: str, what: str) -> None:
        path = self._file(name)
        if path is not None:
            raise NotImplementedError(
                f"{path}: the {what} network is not ported yet (ROADMAP.md queue A15c); "
                f"remove the file to score with the classical fallback")
        self.comparable[name] = False
        return None

    def raft(self) -> Optional[Callable]:
        """RAFT optical flow (``raft.npz``): None without the file."""
        return self._not_ported("raft", "RAFT")

    def amt(self) -> Optional[Callable]:
        """AMT-S frame interpolation (``amt.npz``): None without the file."""
        return self._not_ported("amt", "AMT-S")

    def pips(self) -> Optional[Callable]:
        """PIPs2 point tracking for FVMD (``pips.npz``): None without the file."""
        return self._not_ported("pips", "PIPs2")

    def musiq(self) -> Optional[Callable]:
        """MUSIQ image quality (``musiq.npz``): None without the file."""
        return self._not_ported("musiq", "MUSIQ")
