"""Shared builders for the PyTorch-port parity tests (tests/test_torch_*.py).

A tiny UViT3DPose is built in the JAX package, every parameter is replaced
by seeded non-zero numpy values (the zero-initialized output layers would
otherwise hide most of the network), and the same weights are loaded into
the port through ``uvit3d_state_dict_from_flax``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dfot_tpu.models.uvit import UViT3DPose as JUViT3DPose
from dfot_tpu.models.uvit import UViTSpec as JUViTSpec
from dfot_tpu_torch.models.uvit import UViT3DPose, UViTSpec
from dfot_tpu_torch.utils.weights import uvit3d_state_dict_from_flax

POSE_DIM = 6  # 'ray' conditioning keeps the tiny maps small


@contextlib.contextmanager
def one_thread():
    """torch and the BLAS under numpy and scipy on one thread, restored
    after. The tests run one process a file on a shared host: a file whose
    torch or BLAS work spreads over every core oversubscribes it, and its
    spinning threads slow every other file (a 2048-wide ``scipy.linalg.
    sqrtm``, FID's, takes 14 s on one thread against 11 s on eight of an
    8-core CPU)."""
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # the BLAS keeps its threads
        blas = contextlib.nullcontext()
    else:
        blas = threadpool_limits(1)
    try:
        with blas:
            yield
    finally:
        torch.set_num_threads(torch_threads)


def pinned(shape) -> np.ndarray:
    """Fixed N(0, 1) noise for a shape: the same array on every call, so a
    JAX scan traced once and a PyTorch loop see identical draws."""
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    return np.random.default_rng(seed).standard_normal(tuple(shape)).astype(np.float32)


def tiny_spec(**kw) -> UViTSpec:
    base = dict(
        channels=(32, 32, 64, 64), emb_channels=32, patch_size=2,
        block_types=("ResBlock", "ResBlock", "TransformerBlock", "TransformerBlock"),
        block_dropouts=(0.0, 0.0, 0.0, 0.0), num_updown_blocks=(1, 1, 1),
        num_mid_blocks=1, num_heads=2, max_temporal_length=8,
    )
    base.update(kw)
    return UViTSpec(**base)


def _randomize_leaves(tree, rng: np.random.Generator):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize_leaves(dict(v), rng)
            continue
        v = np.asarray(v)
        if v.ndim == 1 and k in ("scale", "weight"):
            r = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif v.ndim == 1:
            r = 0.05 * rng.standard_normal(v.shape)
        else:
            r = rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))
        out[k] = r.astype(np.float32)
    return out


def randomize(tree, rng: np.random.Generator, patch_size: int):
    """Seeded non-zero values for every leaf of a flax params tree."""
    out = _randomize_leaves(tree, rng)
    # the output projection's bias is a p*p tile of a per-channel torch bias
    b = out["project_output"]["bias"]
    c = b.shape[0] // (patch_size * patch_size)
    out["project_output"]["bias"] = np.tile(b[:c], patch_size * patch_size)
    return out


def build_pair(spec: UViTSpec, resolution: int, seed: int = 0, token_io: bool = False):
    """(jax_model, jax_variables, port_model) on the same random weights."""
    jspec = JUViTSpec(**dataclasses.asdict(spec))
    jm = JUViT3DPose(
        spec=jspec, x_channels=3, resolution=resolution, external_cond_dim=POSE_DIM,
        use_fourier_noise_emb=True, token_io=token_io,
    )
    T = spec.max_temporal_length
    rk = jax.random.PRNGKey
    x = (
        jnp.zeros((1, T, (resolution // 2) ** 2, 12)) if token_io
        else jnp.zeros((1, T, resolution, resolution, 3))
    )
    variables = jm.init(
        {"params": rk(0), "dropout": rk(1)}, x, jnp.zeros((1, T)),
        jnp.zeros((1, T, resolution, resolution, POSE_DIM)),
    )
    params = randomize(jax.device_get(variables["params"]), np.random.default_rng(seed),
                       spec.patch_size)
    buffers = jax.device_get(variables["buffers"])
    pm = UViT3DPose(spec, 3, resolution, POSE_DIM, use_fourier_noise_emb=True, token_io=token_io)
    pm.load_state_dict(
        uvit3d_state_dict_from_flax(params, buffers, spec, 3, POSE_DIM), strict=True
    )
    jvars = {"params": jax.tree_util.tree_map(jnp.asarray, params),
             "buffers": jax.tree_util.tree_map(jnp.asarray, buffers)}
    return jm, jvars, pm.eval()


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))
