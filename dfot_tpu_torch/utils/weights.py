"""Weights for the port's models: from the JAX package, or seeded random.

:func:`uvit3d_state_dict_from_flax` is the inverse of
``dfot_tpu/utils/torch_ckpt.py:import_uvit3d_params``: it turns the JAX
package's UViT3D(+Pose) variables (``params`` and the Fourier-embedding
``buffers``, as numpy arrays) into a state dict of upstream torch names and
layouts, which the port's model loads with ``load_state_dict``. The same map
carries training state across: fp32 parameters become the port's fp32 master
weights, and with ``cotangent=True`` a tree of gradients (or of any other
quantity that is linear in them) lands on the port's parameter names, so the
two packages' trees can be compared leaf by leaf.
:func:`dit3d_state_dict_from_flax` is the same for DiT3D and DiT3DPose, the
inverse of ``import_dit3d_params``; there every leaf is a permutation of its
flax leaf (a matrix block's einsum factors are the leaf itself), so
parameters and gradients go through it alike.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["uvit3d_state_dict_from_flax", "dit3d_state_dict_from_flax", "init_random_weights"]


def _linear(k):  # flax Dense kernel (in, out) -> torch Linear weight (out, in)
    return np.ascontiguousarray(np.asarray(k).T)


def _conv(k):  # flax Conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def _patchify_conv(k, channels: int, p: int):
    """(p*p*C, D) dense in (p_h, p_w, C) order -> stride-p Conv2d (D, C, p, p)."""
    D = k.shape[1]
    return np.ascontiguousarray(np.asarray(k).reshape(p, p, channels, D).transpose(3, 2, 0, 1))


def _unpatchify_convT(k, p: int):
    """(C_in, p*p*C_out) dense -> stride-p ConvTranspose2d (C_in, C_out, p, p)."""
    C_in = k.shape[0]
    return np.ascontiguousarray(np.asarray(k).reshape(C_in, p, p, -1).transpose(0, 3, 1, 2))


# flax sub-path inside a U-ViT block -> (torch suffix, converter)
_BLOCK_LEAVES = {
    "in_norm/scale": ("in_layers.0.weight", np.asarray),
    "in_norm/bias": ("in_layers.0.bias", np.asarray),
    "in_conv/kernel": ("in_layers.2.weight", _conv),
    "in_conv/bias": ("in_layers.2.bias", np.asarray),
    "emb_layer/kernel": ("emb_layer.weight", _conv),
    "emb_layer/bias": ("emb_layer.bias", np.asarray),
    "out_norm/scale": ("out_norm.weight", np.asarray),
    "out_norm/bias": ("out_norm.bias", np.asarray),
    "out_conv/kernel": ("out_rest.1.weight", _conv),
    "out_conv/bias": ("out_rest.1.bias", np.asarray),
    "norm/emb_layer/kernel": ("norm.emb_layer.weight", _linear),
    "norm/emb_layer/bias": ("norm.emb_layer.bias", np.asarray),
    "norm/norm/weight": ("norm.norm.weight", np.asarray),
    "fused_proj/kernel": ("fused_attn_mlp_proj.weight", _linear),
    "fused_proj/bias": ("fused_attn_mlp_proj.bias", np.asarray),
    "q_norm/weight": ("q_norm.weight", np.asarray),
    "k_norm/weight": ("k_norm.weight", np.asarray),
    "attn_out/kernel": ("attn_out.weight", _linear),
    "attn_out/bias": ("attn_out.bias", np.asarray),
    "mlp_out/kernel": ("mlp_out.2.weight", _linear),
    "mlp_out/bias": ("mlp_out.2.bias", np.asarray),
    # the temporal attention of an axial block
    "temporal_attn/norm/emb_layer/kernel": ("another_attn.norm.emb_layer.weight", _linear),
    "temporal_attn/norm/emb_layer/bias": ("another_attn.norm.emb_layer.bias", np.asarray),
    "temporal_attn/norm/norm/weight": ("another_attn.norm.norm.weight", np.asarray),
    "temporal_attn/proj/kernel": ("another_attn.proj.weight", _linear),
    "temporal_attn/q_norm/weight": ("another_attn.q_norm.weight", np.asarray),
    "temporal_attn/k_norm/weight": ("another_attn.k_norm.weight", np.asarray),
    "temporal_attn/out/kernel": ("another_attn.out.weight", _linear),
}


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v), path))
        else:
            out[path] = v
    return out


def uvit3d_state_dict_from_flax(
    params: Dict[str, Any],
    buffers: Optional[Dict[str, Any]],
    spec,
    x_channels: int = 3,
    external_cond_dim: int = 0,
    cotangent: bool = False,
) -> Dict[str, torch.Tensor]:
    """JAX UViT3D(+Pose) variables -> the port's state dict (fp32 tensors).

    ``params``: the flax ``params`` tree; ``buffers``: the flax ``buffers``
    tree (the Fourier noise embedding's fixed freqs/phases) or None.
    ``spec``: the model's UViTSpec (JAX's or the port's).

    Every leaf but one is a permutation of its flax leaf. The exception is
    the output projection's bias: flax holds p*p copies of it (one per pixel
    of a patch), the upstream ConvTranspose2d one. As parameters
    (``cotangent=False``) the copies must be equal and one is taken; as
    gradients (``cotangent=True``) they are summed.
    """
    p = spec.patch_size
    L = len(spec.channels)
    out: Dict[str, np.ndarray] = {}
    for path, value in _flatten(params).items():
        head, _, rest = path.partition("/")
        if head == "embed_input":
            key = "embed_input.proj." + ("weight" if rest == "kernel" else "bias")
            out[key] = _patchify_conv(value, x_channels, p) if rest == "kernel" else np.asarray(value)
        elif head == "project_output":
            if rest == "kernel":
                out["project_output.proj.weight"] = _unpatchify_convT(value, p)
            else:
                b = np.asarray(value).reshape(p * p, -1)
                if cotangent:
                    out["project_output.proj.bias"] = b.sum(0)
                    continue
                if not (b == b[:1]).all():
                    raise ValueError("project_output bias is not a p*p tile of one bias")
                out["project_output.proj.bias"] = np.ascontiguousarray(b[0])
        elif head == "pose_embed":
            kind = rest.rsplit("/", 1)[-1]
            key = "external_cond_embedding.patch_embedder.proj." + ("weight" if kind == "kernel" else "bias")
            out[key] = (
                _patchify_conv(value, external_cond_dim, p) if kind == "kernel" else np.asarray(value)
            )
        elif head in ("noise_emb", "cond_emb"):
            sub, module = (("mlp", "noise_level_pos_embedding") if head == "noise_emb"
                           else ("embedding", "external_cond_embedding"))
            m = re.fullmatch(sub + r"/linear_(\d)/(kernel|bias)", rest)
            if m is None:
                raise KeyError(f"unmapped {head} parameter {path}")
            key = f"{module}.embedding.linear_{m.group(1)}."
            out[key + ("weight" if m.group(2) == "kernel" else "bias")] = (
                _linear(value) if m.group(2) == "kernel" else np.asarray(value)
            )
        elif m := re.fullmatch(r"(down|up)sample_(\d+)", head):
            i = int(m.group(2))
            prefix = (
                f"down_blocks.{i}.{spec.num_updown_blocks[i]}" if m.group(1) == "down"
                else f"up_blocks.{L - 2 - i}.0"
            )
            kind = rest.rsplit("/", 1)[-1]
            out[f"{prefix}.conv." + ("weight" if kind == "kernel" else "bias")] = (
                _conv(value) if kind == "kernel" else np.asarray(value)
            )
        elif m := re.fullmatch(r"(down|up)_(\d+)_(\d+)|mid_(\d+)", head):
            if m.group(4) is not None:
                prefix = f"mid_blocks.{m.group(4)}"
            elif m.group(1) == "down":
                prefix = f"down_blocks.{m.group(2)}.{m.group(3)}"
            else:
                prefix = f"up_blocks.{L - 2 - int(m.group(2))}.{int(m.group(3)) + 1}"
            if rest not in _BLOCK_LEAVES:
                raise KeyError(f"unmapped block parameter {path}")
            suffix, conv = _BLOCK_LEAVES[rest]
            out[f"{prefix}.{suffix}"] = conv(value)
        else:
            raise KeyError(f"unmapped parameter {path}")
    for path, value in _flatten(buffers or {}).items():
        m = re.fullmatch(r"noise_emb/fourier/(freqs|phases)", path)
        if m is None:
            raise KeyError(f"unmapped buffer {path}")
        out[f"noise_level_pos_embedding.timesteps.{m.group(1)}"] = np.asarray(value)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


# flax sub-path inside a DiT block -> torch module path
_DIT_BLOCK_MODULES = {
    "mod_attn/linear": "norm1.modulation.1",
    "mod_mlp/linear": "norm2.modulation.1",
    "attn/qkv": "attn.qkv",
    "attn/proj": "attn.proj",
    "mlp/fc1": "mlp.fc1",
    "mlp/fc2": "mlp.fc2",
}


# a matrix block's einsum factors: the flax layout is the upstream one
_MATRIX_LEAVES = ("qkv_u", "proj_u", "qkv_v", "proj_v", "qkv_bias", "proj_bias")


def _dense(prefix: str, kind: str, value):
    """A flax Dense leaf under the torch Linear ``prefix``."""
    if kind == "kernel":
        return prefix + ".weight", _linear(value)
    return prefix + ".bias", np.asarray(value)


def _dit3d_leaf(path: str, value, p: int):
    """(torch name, array) of one leaf of the flax DiT3D params tree."""
    module, _, kind = path.rpartition("/")
    if module in ("patch_embed/proj", "pose_embed/proj"):
        name = {"patch_embed/proj": "patch_embedder", "pose_embed/proj": "pose_embed"}[module]
        if kind == "bias":
            return f"{name}.proj.bias", np.asarray(value)
        return f"{name}.proj.weight", _patchify_conv(value, value.shape[0] // (p * p), p)
    if m := re.fullmatch(r"noise_emb/mlp/(linear_\d)", module):
        return _dense(f"noise_level_pos_embedding.embedding.{m.group(1)}", kind, value)
    if path == "cond_emb/embedding_table":
        return "external_cond_embedding.embedding_table.weight", np.asarray(value)
    if m := re.fullmatch(r"cond_emb/embedding/(linear_\d)", module):
        return _dense(f"external_cond_embedding.embedding.{m.group(1)}", kind, value)
    if path == "dit/pos_emb":
        return "dit_base.pos_emb.pos_emb", np.asarray(value)
    if m := re.fullmatch(r"dit/(temporal_)?block_(\d+)/(.+)", module):
        blocks = "temporal_blocks" if m.group(1) else "blocks"
        if m.group(3) in _DIT_BLOCK_MODULES:
            return _dense(
                f"dit_base.{blocks}.{m.group(2)}.{_DIT_BLOCK_MODULES[m.group(3)]}", kind, value)
        if m.group(3) == "attn" and kind in _MATRIX_LEAVES:
            return f"dit_base.{blocks}.{m.group(2)}.attn.{kind}", np.asarray(value)
    if module == "dit/final_layer/mod/linear":
        return _dense("dit_base.final_layer.norm_final.modulation.1", kind, value)
    if module == "dit/final_layer/proj":
        return _dense("dit_base.final_layer.linear", kind, value)
    raise KeyError(f"unmapped parameter {path}")


def dit3d_state_dict_from_flax(
    params: Dict[str, Any], buffers: Optional[Dict[str, Any]], patch_size: int,
) -> Dict[str, torch.Tensor]:
    """JAX DiT3D or DiT3DPose variables -> the port's state dict (fp32
    tensors). ``params``: the flax ``params`` tree (or a tree of gradients);
    ``buffers``: the flax ``buffers`` tree (the Fourier noise embedding's
    fixed freqs/phases) or None. A DiT3DPose tree holds its denoiser under
    ``trunk``, as the port's module does."""
    out: Dict[str, np.ndarray] = {}
    for path, value in _flatten(params).items():
        prefix = "trunk." if path.startswith("trunk/") else ""
        name, array = _dit3d_leaf(path[len(prefix):], np.asarray(value), patch_size)
        out[prefix + name] = array
    for path, value in _flatten(buffers or {}).items():
        m = re.fullmatch(r"(trunk/)?noise_emb/fourier/(freqs|phases)", path)
        if m is None:
            raise KeyError(f"unmapped buffer {path}")
        prefix = "trunk." if m.group(1) else ""
        out[f"{prefix}noise_level_pos_embedding.timesteps.{m.group(2)}"] = np.asarray(value)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


# parameters the JAX package initializes to zero (residual-branch outputs),
# but attn_out, get their random values scaled down by ZERO_INIT_SCALE:
# small, but not zero
_ZERO_INIT = re.compile(r".*(out_rest\.1|mlp_out\.2|project_output\.proj)\.(weight|bias)$")
ZERO_INIT_SCALE = 0.1
# q/k RMSNorm scales are QK_NORM_SCALE times the other norm scales: attention
# scores then have std ~4 and the softmax is peaked, as a trained model's is.
# At unit scales it is nearly flat over thousands of keys, and the output
# would hardly depend on the attention pattern.
QK_NORM_SCALE = 2.0
# A DiT has no q/k norm: the q and k rows of its qkv projections are
# DIT_QK_SCALE times the law, for scores of the same spread. Its AdaLN
# modulations (zero-initialized in the JAX package) are DIT_MODULATION_SCALE
# times the law, which puts shifts, scales and gates near 0.5: every block's
# attention and MLP then reach the output, and so does the conditioning.
DIT_QK_SCALE = 3.0
DIT_MODULATION_SCALE = 8.0


@torch.no_grad()
def init_random_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter and buffer with seeded random values.

    Weights are U(-1, 1) / sqrt(fan_in), biases U(-0.02, 0.02), norm scales
    1 + U(-0.1, 0.1) (q/k norm scales ``QK_NORM_SCALE`` times that). Layers
    the JAX package zero-initializes get the same law times
    ``ZERO_INIT_SCALE``, small but non-zero, except ``attn_out``, which
    keeps the plain law: the output depends on every block and on the
    attention pattern. Fourier buffers get their own law (2 pi N(0, 1)
    frequencies, 2 pi U(0, 1) phases). A DiT's modulation weights and the q and
    k rows of its qkv projections are scaled up (``DIT_MODULATION_SCALE``,
    ``DIT_QK_SCALE``): never zero, as its zero-initialized gates would be.
    """
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        u = torch.rand(t.shape, generator=generator, dtype=torch.float32) * 2 - 1
        if name.endswith("timesteps.freqs"):
            v = 2 * math.pi * torch.randn(t.shape, generator=generator)
        elif name.endswith("timesteps.phases"):
            v = 2 * math.pi * (u + 1) / 2
        elif t.ndim == 1 and re.search(r"(norm|in_layers\.0)(\.norm)?\.weight$", name):
            v = 1 + 0.1 * u
            if name.endswith(("q_norm.weight", "k_norm.weight")):
                v = v * QK_NORM_SCALE
        elif t.ndim == 1:
            v = 0.02 * u
        else:
            fan_in = t.shape[1] * math.prod(t.shape[2:])
            v = u / math.sqrt(fan_in)
        if name.endswith("modulation.1.weight"):
            v = v * DIT_MODULATION_SCALE
        elif name.endswith("attn.qkv.weight"):
            v[: 2 * (t.shape[0] // 3)] *= DIT_QK_SCALE
        if _ZERO_INIT.match(name):
            v = v * ZERO_INIT_SCALE
        t.copy_(v.to(t.dtype))
