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
:func:`imagevae_state_dict_from_flax`, :func:`videovae_state_dict_from_flax`
and :func:`dcae_state_dict_from_flax` carry the JAX package's VAE
parameters onto the port's VAEs (``vae/``): dense kernels transposed to
torch's (out, in), conv kernels HWIO/THWIO to OIHW/OITHW, norm ``scale`` to
``weight``; the DC-AE's the inverse of ``dfot_tpu/vae/dc_ae.py:
import_dc_ae_params``. The kl-f8 AutoencoderKL is an ImageVAE and takes
:func:`imagevae_state_dict_from_flax`.
:func:`discriminator_state_dict_from_flax` and
:func:`lpips_state_dict_from_flax` do the same for the VAE losses' modules
(the discriminator's ``batch_stats`` become its BatchNorms' running
statistics), and :func:`titok_state_dict_from_flax` is the inverse of
``dfot_tpu/vae/titok.py:import_titok_params``. The metric networks' own:
:func:`i3d_state_dict_from_flax` (the JAX package has no torch importer for
I3D), :func:`inception_state_dict_from_flax`,
:func:`clip_vision_state_dict_from_flax` and :func:`dino_state_dict_from_flax`
(the inverses of ``dfot_tpu/metrics/inception.py:import_inception_params``
and ``encoders.py:import_clip_vision_params`` / ``import_dino_params``) and
:func:`laion_state_dict_from_npz`; each takes the tree that
``metrics/registry.py`` reads from a ``<name>.npz``. So do
:func:`raft_state_dict_from_flax`, :func:`amt_state_dict_from_flax`,
:func:`pips_state_dict_from_flax` and :func:`musiq_state_dict_from_flax`, the
inverses of ``dfot_tpu/metrics/{raft,amt,pips,musiq}.py:import_<net>_params``
(AMT-S's ``ConvT4x4`` kernel flipped back to a ``ConvTranspose2d`` weight);
:func:`flax_tree_from_state_dict` goes the other way for those four, so that
a network of the port can be written as the ``.npz`` the JAX registry reads.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["uvit3d_state_dict_from_flax", "dit3d_state_dict_from_flax", "init_random_weights",
           "unet3d_state_dict_from_flax", "far_state_dict_from_flax", "dit1d_state_dict_from_flax",
           "imagevae_state_dict_from_flax", "videovae_state_dict_from_flax",
           "dcae_state_dict_from_flax", "discriminator_state_dict_from_flax",
           "lpips_state_dict_from_flax", "titok_state_dict_from_flax", "i3d_state_dict_from_flax",
           "inception_state_dict_from_flax", "clip_vision_state_dict_from_flax",
           "dino_state_dict_from_flax", "laion_state_dict_from_npz", "raft_state_dict_from_flax",
           "amt_state_dict_from_flax", "pips_state_dict_from_flax", "musiq_state_dict_from_flax",
           "flax_tree_from_state_dict"]


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


def _conv3d_1kk(k):  # flax per-frame Conv (kh, kw, in, out) -> torch Conv3d (out, in, 1, kh, kw)
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)[:, :, None])


def _dense_as_conv3d(k):  # flax Dense (in, out) -> torch 1x1x1 Conv3d (out, in, 1, 1, 1)
    return np.ascontiguousarray(np.asarray(k).T[:, :, None, None, None])


def _by_rules(flat: Dict[str, Any], rules) -> Dict[str, np.ndarray]:
    """flax path -> torch name by the first (regex, template, converter)
    rule that matches the whole path; an unmatched path raises."""
    out = {}
    for path, value in flat.items():
        for pattern, template, conv in rules:
            m = re.fullmatch(pattern, path)
            if m:
                out[m.expand(template)] = conv(value)
                break
        else:
            raise KeyError(f"unmapped parameter {path}")
    return out


def _fp32(out: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


# flax leaf under a UNet3D block -> (torch suffix, converter), by block kind
_UNET3D_LEAVES = {
    "res": {
        "norm1/gn/scale": ("in_layers.0.weight", np.asarray),
        "norm1/gn/bias": ("in_layers.0.bias", np.asarray),
        "conv1/kernel": ("in_layers.2.weight", _conv3d_1kk),
        "conv1/bias": ("in_layers.2.bias", np.asarray),
        "norm2/gn/scale": ("out_layers.0.weight", np.asarray),
        "norm2/gn/bias": ("out_layers.0.bias", np.asarray),
        "conv2/kernel": ("out_layers.2.weight", _conv3d_1kk),
        "conv2/bias": ("out_layers.2.bias", np.asarray),
        "emb_proj/kernel": ("emb_layers.1.weight", _linear),
        "emb_proj/bias": ("emb_layers.1.bias", np.asarray),
        "shortcut/kernel": ("skip_conv.weight", _dense_as_conv3d),
        "shortcut/bias": ("skip_conv.bias", np.asarray),
    },
    "attn": {
        "norm/scale": ("norm.weight", np.asarray),
        "norm/bias": ("norm.bias", np.asarray),
        "qkv/kernel": ("attn.to_qkv.weight", _linear),
        "proj/kernel": ("attn.to_out.weight", _linear),
        "proj/bias": ("attn.to_out.bias", np.asarray),
    },
    "conv": {"kernel": ("weight", _conv3d_1kk), "bias": ("bias", np.asarray)},
}


def _unet3d_module(head: str, num_levels: int, nrb: int):
    """(torch prefix, leaf kind) of a top-level flax UNet3D module."""
    up = lambda i: f"up_blocks.{num_levels - 1 - int(i)}"  # noqa: E731  (0 is the deepest)
    if head in ("init_conv", "out_conv"):
        return ("init_conv" if head == "init_conv" else "out.1"), "conv"
    if head == "out_res":
        return "out.0", "res"
    if head == "init_temporal_attn":
        return "init_temporal_attn.wrapper.module.attn_block", "attn"
    attn = {"sattn": ".wrapper.module", "tattn": ".wrapper.module.attn_block"}
    if m := re.fullmatch(r"mid_(res0|sattn|tattn|res1)", head):
        i = ("res0", "sattn", "tattn", "res1").index(m[1])
        return f"mid_block.{i}" + attn.get(m[1], ""), "attn" if i in (1, 2) else "res"
    if m := re.fullmatch(r"down_(\d+)_ds|up_(\d+)_us", head):
        return (f"down_blocks.{m[1]}.1.conv" if m[1] else f"{up(m[2])}.{nrb + 2}.conv"), "conv"
    if m := re.fullmatch(r"(down|up)_(\d+)_(?:res(\d+)|(sattn|tattn))", head):
        level = f"down_blocks.{m[2]}.0" if m[1] == "down" else up(m[2])
        if m[3] is not None:
            return f"{level}.{m[3]}", "res"
        return f"{level}.{nrb + (m[4] == 'tattn')}" + attn[m[4]], "attn"
    raise KeyError(f"unmapped UNet3D module {head}")


def unet3d_state_dict_from_flax(params: Dict[str, Any], buffers: Optional[Dict[str, Any]],
                                num_levels: int, num_res_blocks: int = 2
                                ) -> Dict[str, torch.Tensor]:
    """JAX UNet3D variables -> the port's state dict (fp32 tensors), the
    inverse of ``import_unet3d_params``: per-frame conv kernels to Conv3d
    (out, in, 1, k, k), the skip Dense to a 1x1x1 Conv3d, ``up_{i}`` to
    ``up_blocks.{num_levels - 1 - i}``. Every leaf is a permutation of its
    flax leaf, so a tree of gradients goes through alike. ``buffers``: the
    Fourier noise embedding's ``freqs`` and ``phases``, or None."""
    out: Dict[str, np.ndarray] = {}
    for path, value in _flatten(params).items():
        head, _, rest = path.partition("/")
        if m := re.fullmatch(r"(noise_emb/mlp|cond_emb/embedding)/(linear_\d)/(kernel|bias)", path):
            module = ("noise_level_pos_embedding" if m[1] == "noise_emb/mlp"
                      else "external_cond_embedding")
            name, array = _dense(f"{module}.embedding.{m[2]}", m[3], value)
        else:
            prefix, kind = _unet3d_module(head, num_levels, num_res_blocks)
            if rest not in _UNET3D_LEAVES[kind]:
                raise KeyError(f"unmapped parameter {path}")
            suffix, conv = _UNET3D_LEAVES[kind][rest]
            name, array = f"{prefix}.{suffix}", conv(value)
        out[name] = array
    for path, value in _flatten(buffers or {}).items():
        m = re.fullmatch(r"noise_emb/fourier/(freqs|phases)", path)
        if m is None:
            raise KeyError(f"unmapped buffer {path}")
        out[f"noise_level_pos_embedding.timesteps.{m[1]}"] = np.asarray(value)
    return _fp32(out)


def far_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX FARDiT ``params`` -> the port's state dict (fp32 tensors), the
    inverse of ``import_far_params``: the packed qkv Dense splits into
    ``to_q``, ``to_k`` and ``to_v`` (a split: a tree of gradients goes
    through alike)."""
    b = r"block_(\d+)"
    t = r"transformer_blocks.\1"
    out = _by_rules(_flatten(params), [
        (r"x_embedder/kernel", "x_embedder.weight", _linear),
        (r"x_embedder/bias", "x_embedder.bias", np.asarray),
        (r"t_embedder/(linear_\d)/kernel", r"timestep_embedder.\1.weight", _linear),
        (r"t_embedder/(linear_\d)/bias", r"timestep_embedder.\1.bias", np.asarray),
        (r"cond_emb/embedding_table", "external_cond_embedding.embedding_table.weight",
         np.asarray),
        (b + r"/norm(\d)/linear/kernel", t + r".norm\2.linear.weight", _linear),
        (b + r"/norm(\d)/linear/bias", t + r".norm\2.linear.bias", np.asarray),
        (b + r"/qkv/kernel", t + ".attn.QKV.weight", _linear),
        (b + r"/qkv/bias", t + ".attn.QKV.bias", np.asarray),
        (b + r"/q_norm/weight", t + ".attn.norm_q.weight", np.asarray),
        (b + r"/k_norm/weight", t + ".attn.norm_k.weight", np.asarray),
        (b + r"/attn_out/kernel", t + ".attn.to_out.0.weight", _linear),
        (b + r"/attn_out/bias", t + ".attn.to_out.0.bias", np.asarray),
        (b + r"/ff/fc1/kernel", t + ".mlp.net.0.proj.weight", _linear),
        (b + r"/ff/fc1/bias", t + ".mlp.net.0.proj.bias", np.asarray),
        (b + r"/ff/fc2/kernel", t + ".mlp.net.2.weight", _linear),
        (b + r"/ff/fc2/bias", t + ".mlp.net.2.bias", np.asarray),
        (r"norm_out/kernel", "norm_out.linear.weight", _linear),
        (r"norm_out/bias", "norm_out.linear.bias", np.asarray),
        (r"proj_out/kernel", "proj_out.weight", _linear),
        (r"proj_out/bias", "proj_out.bias", np.asarray),
    ])
    for key in [k for k in out if ".attn.QKV." in k]:
        for name, part in zip("qkv", np.split(out.pop(key), 3, axis=0)):
            out[key.replace("QKV", f"to_{name}")] = part
    return _fp32(out)


def dit1d_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX DiT1D ``params`` -> the port's state dict (fp32 tensors), the
    inverse of ``import_dit1d_params`` (which maps no label table; the
    port names it ``external_cond_embedding``). Every leaf is a permutation
    of its flax leaf: a tree of gradients goes through alike."""
    b = r"block_(\d+)"
    out = _by_rules(_flatten(params), [
        (r"x_embedder/kernel", "x_embedder.weight", _linear),
        (r"x_embedder/bias", "x_embedder.bias", np.asarray),
        (r"t_embedder/linear_1/kernel", "t_embedder.mlp.0.weight", _linear),
        (r"t_embedder/linear_1/bias", "t_embedder.mlp.0.bias", np.asarray),
        (r"t_embedder/linear_2/kernel", "t_embedder.mlp.2.weight", _linear),
        (r"t_embedder/linear_2/bias", "t_embedder.mlp.2.bias", np.asarray),
        (r"cond_emb/embedding_table", "external_cond_embedding.embedding_table.weight",
         np.asarray),
        (b + r"/adaLN_modulation/kernel", r"blocks.\1.adaLN_modulation.1.weight", _linear),
        (b + r"/adaLN_modulation/bias", r"blocks.\1.adaLN_modulation.1.bias", np.asarray),
        (b + r"/(qkv|proj)/kernel", r"blocks.\1.attn.\2.weight", _linear),
        (b + r"/(qkv|proj)/bias", r"blocks.\1.attn.\2.bias", np.asarray),
        (b + r"/(q|k)_norm/scale", r"blocks.\1.attn.\2_norm.weight", np.asarray),
        (b + r"/(q|k)_norm/bias", r"blocks.\1.attn.\2_norm.bias", np.asarray),
        (b + r"/mlp/(fc\d)/kernel", r"blocks.\1.mlp.\2.weight", _linear),
        (b + r"/mlp/(fc\d)/bias", r"blocks.\1.mlp.\2.bias", np.asarray),
        (r"final_linear/kernel", "final_layer.1.weight", _linear),
        (r"final_linear/bias", "final_layer.1.bias", np.asarray),
    ])
    return _fp32(out)


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
def _fp32_or_wider(value) -> np.ndarray:
    """fp32, or float64 where the leaf is float64 (a float64 comparison)."""
    v = np.asarray(value)
    return v.astype(np.float64 if v.dtype == np.float64 else np.float32)


def _vae_leaf(path: str, value):
    """One flax VAE leaf -> (torch name, tensor)."""
    parts = path.split("/")
    v = _fp32_or_wider(value)
    if parts[-1] == "kernel":
        parts[-1] = "weight"
        if v.ndim == 2:
            v = v.T
        elif v.ndim >= 3:  # (*spatial, in, out) -> (out, in, *spatial)
            v = v.transpose((v.ndim - 1, v.ndim - 2) + tuple(range(v.ndim - 2)))
    elif parts[-1] == "scale":
        parts[-1] = "weight"
    return ".".join(parts), torch.from_numpy(np.ascontiguousarray(v))


def imagevae_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ImageVAE ``params`` -> the port's state dict."""
    return dict(_vae_leaf(p, v) for p, v in _flatten(params).items())


def videovae_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's VideoVAE ``params`` -> the port's state dict."""
    return dict(_vae_leaf(p, v) for p, v in _flatten(params).items())


def _with_batch_counts(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``num_batches_tracked`` 0 beside every BatchNorm's running mean."""
    for name in [n for n in out if n.endswith(".running_mean")]:
        out[name[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out


def dcae_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's DCAE ``params`` -> the port's (diffusers) state dict,
    with ``num_batches_tracked`` 0 beside every BatchNorm's statistics."""
    out = {}
    for path, value in _flatten(params).items():
        path = re.sub(r"(down_blocks|up_blocks)_(\d+)_(\d+)", r"\1/\2/\3", path)
        path = re.sub(r"to_qkv_multiscale_(\d+)", r"to_qkv_multiscale/\1", path)
        name, t = _vae_leaf(path, value)
        out[name] = t
    return _with_batch_counts(out)


def discriminator_state_dict_from_flax(params: Dict[str, Any],
                                       batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's NLayerDiscriminator ``params`` and ``batch_stats``
    -> the port's state dict."""
    out = dict(_vae_leaf(p, v) for p, v in _flatten(params).items())
    for path, v in _flatten(batch_stats).items():
        bn, stat = path.split("/")
        out[f"{bn}.running_{stat}"] = torch.from_numpy(_fp32_or_wider(v))
    return out


def lpips_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS ``params`` -> the port's state dict."""
    return dict(_vae_leaf(p, v) for p, v in _flatten(params).items())


def i3d_state_dict_from_flax(params: Dict[str, Any],
                             batch_stats: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """The JAX package's I3D ``params`` (and ``batch_stats``; without them
    the running statistics of flax's init, mean 0 and variance 1, which is
    what the JAX registry applies, since ``i3d.npz`` holds ``params`` only)
    -> the port's ``metrics/i3d.py:I3D`` state dict."""
    out = dict(_vae_leaf(p, v) for p, v in _flatten(params).items())
    stats = _flatten(batch_stats) if batch_stats is not None else {}
    for name in [n[: -len(".weight")] for n in out if n.endswith(".bn.weight")]:
        flax = name.replace(".", "/")
        c = out[name + ".weight"].shape[0]
        for stat, default in (("mean", np.zeros(c)), ("var", np.ones(c))):
            out[f"{name}.running_{stat}"] = torch.from_numpy(
                _fp32_or_wider(stats.get(f"{flax}/{stat}", default)))
    return _with_batch_counts(out)


def inception_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's InceptionV3 ``params`` -> the port's (torchvision)
    state dict: the inverse of ``dfot_tpu/metrics/inception.py:
    import_inception_params``."""
    return _with_batch_counts(dict(_vae_leaf(p, v) for p, v in _flatten(params).items()))


def _encoder_leaf(path: str, value):
    """One flax CLIP/DINO leaf -> (torch name, tensor)."""
    v = np.asarray(value, dtype=np.float32)
    if path.endswith("attn/in_proj/kernel"):
        return path[: -len("/in_proj/kernel")].replace("/", ".") + ".in_proj_weight", \
            torch.from_numpy(np.ascontiguousarray(v.T))
    if path.endswith("attn/in_proj/bias"):
        return path[: -len("/in_proj/bias")].replace("/", ".") + ".in_proj_bias", torch.from_numpy(v)
    if path in ("proj", "class_embedding", "positional_embedding", "cls_token", "pos_embed"):
        return path, torch.from_numpy(v)
    return _vae_leaf(path, v)


def clip_vision_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``CLIPVisionEncoder`` ``params`` -> the port's
    state dict (OpenAI's ``visual.*`` names without the prefix): the inverse
    of ``dfot_tpu/metrics/encoders.py:import_clip_vision_params``."""
    out = {}
    for path, value in _flatten(params).items():
        path = re.sub(r"^resblocks_(\d+)", r"transformer/resblocks/\1", path)
        path = re.sub(r"mlp_(c_fc|c_proj)", r"mlp/\1", path)
        name, t = _encoder_leaf(path, value)
        out[name] = t
    return out


def dino_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``DINOEncoder`` ``params`` -> the port's (timm)
    state dict: the inverse of ``dfot_tpu/metrics/encoders.py:
    import_dino_params``."""
    out = {}
    for path, value in _flatten(params).items():
        path = re.sub(r"^blocks_(\d+)", r"blocks/\1", path)
        path = re.sub(r"mlp_(fc1|fc2)", r"mlp/\1", path)
        path = re.sub(r"^patch_embed/", "patch_embed/proj/", path)
        name, t = _encoder_leaf(path, value)
        out[name] = t
    return out


def laion_state_dict_from_npz(flat: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``laion.npz`` (the torch ``nn.Linear(768, 1)``'s ``weight`` (1, 768)
    and ``bias`` (1,), which the JAX registry reads as they are) -> the
    port's ``nn.Linear`` state dict."""
    return {k: torch.from_numpy(np.asarray(v, dtype=np.float32)) for k, v in flat.items()}


def _stat_leaf(path: str, value):
    """``_vae_leaf``, with a frozen BatchNorm's ``mean`` and ``var`` as
    torch's running statistics."""
    return _vae_leaf(re.sub(r"/(mean|var)$", r"/running_\1", path), value)


def raft_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's RAFT ``params`` -> the port's (upstream) state dict:
    the inverse of ``dfot_tpu/metrics/raft.py:import_raft_params``. A strided
    block's ``norm3`` is also its ``downsample.1``, as upstream registers it."""
    out = {}
    for path, value in _flatten(params).items():
        path = re.sub(r"layer(\d)_(\d)/", r"layer\1/\2/", path)
        path = path.replace("down_conv/", "downsample/0/").replace("flow_conv", "flow_head/conv")
        path = path.replace("mask_conv1/", "mask/0/").replace("mask_conv2/", "mask/2/")
        name, t = _stat_leaf(path, value)
        out[name] = t
        if ".norm3." in name:
            out[name.replace(".norm3.", ".downsample.1.")] = t
    return _with_batch_counts(out)


_CONV_PRELU = r"(pyramid\d/\d|convblock/0|conv[1-4])"


def amt_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's AMT-S ``params`` -> the port's (upstream) state dict:
    the inverse of ``dfot_tpu/metrics/amt.py:import_amt_params``. The
    decoders' ``ConvT4x4`` kernel (4, 4, in, out), flipped for the dilated
    convolution JAX runs, becomes the ``ConvTranspose2d`` weight (in, out,
    4, 4)."""
    out = {}
    for path, value in _flatten(params).items():
        path = re.sub(r"(layer|pyramid)(\d)_(\d)/", r"\1\2/\3/", path)
        path = path.replace("down_conv/", "downsample/0/")
        path = re.sub(r"(decoder\d)/block(\d)/", r"\1/convblock/\2/", path)
        path = re.sub(r"(gru|feat_head|flow_head)_(\d)/", r"\1/\2/", path)
        path = path.replace("comb_block_0/conv/", "comb_block/0/")
        path = path.replace("comb_block_0/prelu/alpha", "comb_block/1/weight")
        path = path.replace("comb_block_2/", "comb_block/2/")
        path = re.sub(_CONV_PRELU + r"/conv/", r"\1/0/", path)
        path = re.sub(_CONV_PRELU + r"/prelu/alpha$", r"\1/1/weight", path)
        path = re.sub(r"/prelu/alpha$", "/prelu/weight", path)
        if re.search(r"convblock/2/kernel$", path):
            k = np.asarray(value, dtype=np.float32)[::-1, ::-1].transpose(2, 3, 0, 1)
            out[path[: -len("kernel")].replace("/", ".") + "weight"] = torch.from_numpy(
                np.ascontiguousarray(k))
            continue
        name, t = _vae_leaf(path, value)
        out[name] = t
    return out


def pips_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's PIPs2 ``params`` -> the port's (upstream) state
    dict: the inverse of ``dfot_tpu/metrics/pips.py:import_pips_params``."""
    out = {}
    for path, value in _flatten(params).items():
        path = re.sub(r"layer(\d)_(\d)/", r"layer\1/\2/", path)
        path = path.replace("down_conv/", "downsample/0/")
        path = re.sub(r"delta_block/block_(\d+)/(conv\d)/",
                      r"delta_block/basicblock_list/\1/\2/conv/", path)
        path = path.replace("first_block_conv/", "first_block_conv/conv/")
        name, t = _vae_leaf(path, value)
        out[name] = t
    return out


_MUSIQ_NAMES = {"ln1": "norm1", "qkv": "attn/qkv", "attn_out": "attn/out", "ln2": "norm2",
                "mlp_in": "mlp/fc1", "mlp_out": "mlp/fc2"}


def musiq_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's MUSIQ ``params`` -> the port's state dict, whose
    names ``dfot_tpu/metrics/musiq.py:import_musiq_params`` maps back."""
    out = {}
    for path, value in _flatten(params).items():
        path = path.replace("patch_encoder/", "")
        path = {"hse_embedding": "pos_emb", "scale_embedding": "scale_emb"}.get(path, path)
        m = re.fullmatch(r"block_(\d+)/(\w+)/(\w+)", path)
        if m:
            path = f"blocks/{m[1]}/{_MUSIQ_NAMES[m[2]]}/{m[3]}"
        if "/" not in path:  # the embeddings and the CLS token, as they are
            out[path] = torch.from_numpy(np.array(value, dtype=np.float32))
            continue
        name, t = _vae_leaf(path, value)
        out[name] = t
    return out


# torch path -> flax path of the four networks above, applied in order
_TO_FLAX = {
    "raft": ((r"layer(\d)/(\d)/", r"layer\1_\2/"), (r"downsample/0/", "down_conv/"),
             (r"flow_head/conv", "flow_conv"), (r"mask/0/", "mask_conv1/"),
             (r"mask/2/", "mask_conv2/")),
    "amt": ((r"(layer|pyramid)(\d)/(\d)/", r"\1\2_\3/"), (r"downsample/0/", "down_conv/"),
            (r"(decoder\d)/convblock/(\d)/", r"\1/block\2/"),
            (r"(gru|feat_head|flow_head)/(\d)/", r"\1_\2/"),
            (r"comb_block/0/", "comb_block_0/conv/"),
            (r"comb_block/1/scale", "comb_block_0/prelu/alpha"),
            (r"comb_block/2/", "comb_block_2/"),
            (r"(pyramid\d_\d|block0|conv[1-4])/0/", r"\1/conv/"),
            (r"(pyramid\d_\d|block0|conv[1-4])/1/scale$", r"\1/prelu/alpha"),
            (r"/prelu/scale$", "/prelu/alpha")),
    "pips": ((r"layer(\d)/(\d)/", r"layer\1_\2/"), (r"downsample/0/", "down_conv/"),
             (r"basicblock_list/(\d+)/(conv\d)/conv/", r"block_\1/\2/"),
             (r"first_block_conv/conv/", "first_block_conv/")),
    "musiq": ((r"^(conv_root|gn_root|embedding)/", r"patch_encoder/\1/"),
              (r"^pos_emb$", "hse_embedding"), (r"^scale_emb$", "scale_embedding"),
              (r"^blocks/(\d+)/", r"block_\1/"), (r"/norm1/", "/ln1/"), (r"/attn/qkv/", "/qkv/"),
              (r"/attn/out/", "/attn_out/"), (r"/norm2/", "/ln2/"), (r"/mlp/fc1/", "/mlp_in/"),
              (r"/mlp/fc2/", "/mlp_out/")),
}


def flax_tree_from_state_dict(name: str, state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A state dict of the port's ``raft``, ``amt``, ``pips`` or ``musiq`` ->
    the JAX package's ``params`` tree of that network (what ``import_<name>_
    params`` makes of it): the inverse of ``<name>_state_dict_from_flax``."""
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        if key.endswith("num_batches_tracked") or ".downsample.1." in key:
            continue  # RAFT's norm3 under its second name
        v = t.detach().cpu().numpy().astype(np.float32)
        *parts, leaf = key.split(".")
        if leaf == "weight" and name == "amt" and key.endswith("convblock.2.weight"):
            v, leaf = v.transpose(2, 3, 0, 1)[::-1, ::-1], "kernel"
        elif leaf == "weight" and v.ndim >= 2:
            v = v.T if v.ndim == 2 else v.transpose(tuple(range(2, v.ndim)) + (1, 0))
            leaf = "kernel"
        elif leaf == "weight":
            leaf = "scale"
        leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        path = "/".join(parts + [leaf])
        for pattern, template in _TO_FLAX[name]:
            path = re.sub(pattern, template, path)
        node = tree
        *dirs, last = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = np.ascontiguousarray(v)
    return tree


# TiTok leaves that the upstream module holds as 1x1 convs (flax: Dense)
_TITOK_CONV1X1 = re.compile(r"(encoder/conv_out|decoder/ffn_\d|pixel_quantize_conv|"
                            r".*/nin_shortcut)/kernel$")


def titok_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's TiTokKL ``params`` -> the port's (upstream) state
    dict: the inverse of ``import_titok_params``."""
    out = {}
    for path, value in _flatten(params).items():
        v = np.asarray(value, dtype=np.float32)
        if path.endswith("attn/in_proj/kernel"):
            name, v = path[: -len("/in_proj/kernel")] + "/in_proj_weight", v.T
        elif path.endswith("attn/in_proj/bias"):
            name = path[: -len("/in_proj/bias")] + "/in_proj_bias"
        elif _TITOK_CONV1X1.match(path):
            name, v = path[: -len("kernel")] + "weight", v.T[:, :, None, None]
        else:
            name, t = _vae_leaf(path, v)
            name, v = name.replace(".", "/"), t.numpy()
        name = re.sub(r"(transformer|mid|block|up|ffn)_(\d+)", r"\1/\2", name)
        name = re.sub(r"mlp_(c_fc|c_proj)", r"mlp/\1", name)
        out[name.replace("/", ".")] = torch.from_numpy(np.ascontiguousarray(v))
    return out


DIT_QK_SCALE = 3.0
DIT_MODULATION_SCALE = 8.0


@torch.no_grad()
def init_random_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter and buffer with seeded random values.

    Weights are U(-1, 1) / sqrt(fan_in), biases U(-0.02, 0.02), norm scales
    1 + U(-0.1, 0.1) (q/k norm scales ``QK_NORM_SCALE`` times that; FAR-DiT
    names them ``norm_q``, ``norm_k``). Layers
    the JAX package zero-initializes get the same law times
    ``ZERO_INIT_SCALE``, small but non-zero, except ``attn_out``, which
    keeps the plain law: the output depends on every block and on the
    attention pattern. Fourier buffers get their own law (2 pi N(0, 1)
    frequencies, 2 pi U(0, 1) phases). A DiT's modulation weights (FAR-DiT's
    ``norm1.linear``, ``norm2.linear`` and ``norm_out.linear``) and the q and
    k rows of its qkv projections (a UNet3D's ``to_qkv`` too) are scaled up
    (``DIT_MODULATION_SCALE``, ``DIT_QK_SCALE``): never zero, as its
    zero-initialized gates would be, and attention peaked.
    """
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        u = torch.rand(t.shape, generator=generator, dtype=torch.float32) * 2 - 1
        if name.endswith("timesteps.freqs"):
            v = 2 * math.pi * torch.randn(t.shape, generator=generator)
        elif name.endswith("timesteps.phases"):
            v = 2 * math.pi * (u + 1) / 2
        elif t.ndim == 1 and re.search(r"(norm|norm_[qk]|(in|out)_layers\.0)(\.norm)?\.weight$",
                                       name):
            v = 1 + 0.1 * u
            if name.endswith(("q_norm.weight", "k_norm.weight", "norm_q.weight", "norm_k.weight")):
                v = v * QK_NORM_SCALE
        elif t.ndim == 1:
            v = 0.02 * u
        else:
            fan_in = t.shape[1] * math.prod(t.shape[2:])
            v = u / math.sqrt(fan_in)
        if re.search(r"(modulation\.1|norm\d\.linear|norm_out\.linear)\.weight$", name):
            v = v * DIT_MODULATION_SCALE
        elif name.endswith(("attn.qkv.weight", "attn.to_qkv.weight")):
            v[: 2 * (t.shape[0] // 3)] *= DIT_QK_SCALE
        if _ZERO_INIT.match(name):
            v = v * ZERO_INIT_SCALE
        t.copy_(v.to(t.dtype))
