"""Fused qkv preparation and attention-output collect, with plain versions.

Port of ``dfot_tpu/ops/qkv_prep.py`` (forward side). The chain between the
packed qkv projection and attention (head split, per-head RMSNorm, RoPE,
optional zero lane-pad) and the chain after it (drop pad lanes, merge
heads) are one pass each:

- :func:`qkv_prep` wraps kernel B2 (``csrc/qkv_prep.cu``, the port of
  ``_prep_kernel``);
- :func:`attn_out_collect` wraps kernel B3 (``csrc/attn_out_collect.cu``,
  the port of ``_collect_kernel``);
- :func:`attention_from_packed_qkv` runs B2 -> B1 -> B3, the route of every
  UViT transformer block.

A CUDA tensor goes to the kernels or the call raises; a CPU tensor takes the
plain versions. RoPE pairs are ADJACENT lanes (rotate_half is
(x0, x1) -> (-x1, x0)); the sign is folded into the sin table
(:func:`signed_sin`) and the learned RMSNorm scale into both tables before
their cast to the model dtype, exactly as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .attention import attention_reference, flash_attention

__all__ = [
    "signed_sin",
    "swap_pairs",
    "fold_qk_tables",
    "qkv_prep",
    "reference_qkv_prep",
    "attn_out_collect",
    "attention_from_packed_qkv",
]


def signed_sin(sin: np.ndarray) -> np.ndarray:
    """Fold rotate_half's (-1, +1) pair sign into the sin table."""
    out = np.array(sin, copy=True)
    out[..., 0::2] = -out[..., 0::2]
    return out


def swap_pairs(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Adjacent-pair swap along ``dim``: (x0, x1, x2, x3) -> (x1, x0, x3, x2)."""
    x = x.movedim(dim, -1)
    y = x.reshape(x.shape[:-1] + (-1, 2)).flip(-1).reshape(x.shape)
    return y.movedim(-1, dim)


def fold_qk_tables(cos, sin_signed, q_scale=None, k_scale=None, dtype=torch.bfloat16):
    """The (cos, sin) table pairs of q and of k, ``((cq, sq), (ck, sk))``.

    ``cos``/``sin_signed``: (N, D) fp32 tables, sign already folded. Each
    learned RMSNorm scale is folded into its pair in fp32 before the cast to
    ``dtype``: rope(u * s) = u * (s * cos) + swap(u) * (swap(s) * sin_signed).
    """
    c, s = cos.float(), sin_signed.float()
    out = []
    for scale in (q_scale, k_scale):
        if scale is None:
            pair = (c, s)
        else:
            pair = (c * scale.float(), s * swap_pairs(scale.float()))
        out.append(tuple(t.to(dtype).contiguous() for t in pair))
    return tuple(out)


def _prep_plain(qkv, tabs, heads, head_dim, d_out, norm, eps):
    """Plain version of kernel B2 on already folded tables."""
    B, N, _ = qkv.shape
    x = qkv.reshape(B, N, 3, heads, head_dim)
    outs = []
    for i in range(3):
        t = x[:, :, i].transpose(1, 2)  # (B, H, N, D)
        if i < 2:
            if norm:
                tf = t.float()
                r = torch.rsqrt(tf.pow(2).mean(-1, keepdim=True) + eps)
                t = (tf * r).to(qkv.dtype)
            c, s = tabs[i]
            t = t * c + swap_pairs(t) * s
        if d_out > head_dim:
            t = torch.nn.functional.pad(t, (0, d_out - head_dim))
        outs.append(t.contiguous())
    return tuple(outs)


def _prep_cuda(qkv, tabs, heads, head_dim, d_out, norm, eps):
    B, N, _ = qkv.shape
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"qkv_prep kernel takes bf16, got {qkv.dtype}")
    if qkv.stride(-1) != 1 or qkv.stride(0) % 2 or qkv.stride(1) % 2:
        raise ValueError(f"qkv_prep kernel needs a unit, even-aligned last dim, strides {qkv.stride()}")
    if head_dim % 2 or head_dim > 256 or d_out % 2:
        raise ValueError(f"qkv_prep kernel takes even head dims <= 256, got {head_dim}/{d_out}")
    (cq, sq), (ck, sk) = ((c.contiguous(), s.contiguous()) for c, s in tabs)
    if any(t.device != qkv.device for t in (cq, sq, ck, sk)):
        raise ValueError("RoPE tables must be on the device of qkv")
    _cuda.check_aligned("qkv_prep", 4, qkv, cq, sq, ck, sk)
    outs = [
        torch.empty((B, heads, N, d_out), dtype=qkv.dtype, device=qkv.device)
        for _ in range(3)
    ]
    lib = _cuda.library()
    _cuda.check(
        lib.dfot_qkv_prep(
            qkv.data_ptr(), qkv.stride(0), qkv.stride(1),
            cq.data_ptr(), sq.data_ptr(), ck.data_ptr(), sk.data_ptr(),
            *(o.data_ptr() for o in outs),
            B, N, heads, head_dim, d_out, int(norm), float(eps),
            _cuda.stream_handle(qkv.device),
        ),
        "qkv_prep",
    )
    qkv_prep.launches += 1
    return tuple(outs)


def _prep(qkv, tabs, heads, head_dim, d_out, norm, eps, plain=False):
    """Check the shapes, then kernel B2 for a CUDA tensor or its plain
    version for a CPU tensor (or on any device with ``plain``).
    ``tabs``: folded (N, head_dim) tables in qkv's dtype."""
    B, N, W = qkv.shape
    if W != 3 * heads * head_dim or head_dim % 2:
        raise ValueError(f"packed width {W} does not match 3 * {heads} * {head_dim}")
    if d_out < head_dim:
        raise ValueError(f"d_out {d_out} < head_dim {head_dim}")
    for t in (t for pair in tabs for t in pair):
        if t.shape != (N, head_dim) or t.dtype != qkv.dtype:
            raise ValueError(
                f"RoPE tables must be ({N}, {head_dim}) {qkv.dtype}, got {tuple(t.shape)} {t.dtype}"
            )
    if plain or qkv.device.type == "cpu":
        return _prep_plain(qkv, tabs, heads, head_dim, d_out, norm, eps)
    if not qkv.is_cuda:
        raise ValueError(f"no qkv_prep path for device {qkv.device}")
    return _prep_cuda(qkv, tabs, heads, head_dim, d_out, norm, eps)


def qkv_prep(
    qkv: torch.Tensor,
    heads: int,
    head_dim: int,
    cos: torch.Tensor,
    sin_signed: torch.Tensor,
    *,
    q_scale: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    norm: bool = False,
    eps: float = 1e-6,
    d_out: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N, 3*H*D) packed qkv -> q, k, v, each (B, H, N, d_out).

    ``cos``/``sin_signed``: (N, D) tables, sign already folded. With ``norm``,
    q and k get the per-head fp32 1/rms(x); their learned scales are folded
    into the tables here. ``d_out`` zero-pads each head. The JAX package's
    ones lane on v (``aug_v``) is a TPU matrix-unit device and not produced.
    """
    n = qkv.shape[1]
    tabs = fold_qk_tables(cos[:n], sin_signed[:n], q_scale, k_scale, qkv.dtype)
    return _prep(qkv, tabs, heads, head_dim, d_out or head_dim, norm, eps)


qkv_prep.launches = 0  # kernel launches since the last reset


def reference_qkv_prep(
    qkv, heads, head_dim, cos, sin_signed,
    *, q_scale=None, k_scale=None, norm=False, eps=1e-6, d_out=None,
):
    """Plain version of :func:`qkv_prep` on any device (the oracle the
    kernel is held against)."""
    n = qkv.shape[1]
    tabs = fold_qk_tables(cos[:n], sin_signed[:n], q_scale, k_scale, qkv.dtype)
    return _prep(qkv, tabs, heads, head_dim, d_out or head_dim, norm, eps, plain=True)


def reference_attn_out_collect(o: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Plain version of :func:`attn_out_collect` on any device."""
    B, H, N, _ = o.shape
    return o[..., :head_dim].transpose(1, 2).reshape(B, N, H * head_dim)


def _collect_cuda(o, head_dim):
    B, H, N, DP = o.shape
    if o.dtype != torch.bfloat16:
        raise TypeError(f"attn_out_collect kernel takes bf16, got {o.dtype}")
    if head_dim % 8 or DP % 8 or DP < head_dim:
        raise ValueError(f"attn_out_collect kernel takes D, DP multiples of 8, got {head_dim}/{DP}")
    o = o.contiguous()
    out = torch.empty((B, N, H * head_dim), dtype=o.dtype, device=o.device)
    _cuda.check_aligned("attn_out_collect", 16, o, out)
    lib = _cuda.library()
    _cuda.check(
        lib.dfot_attn_out_collect(
            o.data_ptr(), out.data_ptr(), B, H, N, head_dim, DP,
            _cuda.stream_handle(o.device),
        ),
        "attn_out_collect",
    )
    attn_out_collect.launches += 1
    return out


def attn_out_collect(o: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, H, N, DP) attention output -> (B, N, H*head_dim): drop the pad
    lanes and merge the heads in one pass."""
    if o.is_cuda:
        return _collect_cuda(o, head_dim)
    if o.device.type != "cpu":
        raise ValueError(f"no attn_out_collect path for device {o.device}")
    return reference_attn_out_collect(o, head_dim)


attn_out_collect.launches = 0  # kernel launches since the last reset


def attention_from_packed_qkv(
    qkv: torch.Tensor,
    heads: int,
    head_dim: int,
    tables=None,
    *,
    norm: bool = False,
    eps: float = 1e-6,
    causal: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """Packed (B, N, 3*H*D) qkv -> attention output (B, N, H*D).

    ``tables``: the folded ``((cq, sq), (ck, sk))`` of :func:`fold_qk_tables`
    in qkv's dtype, (>= N, D) each, or None for no rotation and no learned
    scale. Softmax scale is 1/sqrt(D) of the true head dim. ``plain=True``
    runs the plain versions of all three kernels on any device: the
    reference a caller compares the kernel route with.
    """
    B, N, _ = qkv.shape
    D = head_dim
    if tables is None:
        ones = torch.ones((N, D), dtype=torch.float32, device=qkv.device)
        tables = fold_qk_tables(ones, torch.zeros_like(ones), dtype=qkv.dtype)
    tabs = tuple((c[:N], s[:N]) for c, s in tables)
    scale = 1.0 / math.sqrt(D)
    q, k, v = _prep(qkv, tabs, heads, D, D, norm, eps, plain=plain)
    if plain:
        return reference_attn_out_collect(attention_reference(q, k, v, causal, scale), D)
    return attn_out_collect(flash_attention(q, k, v, causal, scale), D)
