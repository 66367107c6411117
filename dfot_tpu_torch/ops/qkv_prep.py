"""Fused qkv preparation and attention-output collect, with plain versions.

Port of ``dfot_tpu/ops/qkv_prep.py``. The chain between the packed qkv
projection and attention (head split, per-head RMSNorm, RoPE, optional zero
lane-pad) and the chain after it (drop pad lanes, merge heads) are one pass
each, forward and backward:

- :func:`qkv_prep` wraps kernel B2 (``csrc/qkv_prep.cu``, the port of
  ``_prep_kernel``); its backward is :func:`qkv_prep_bwd`, kernel B6
  (``csrc/qkv_prep_bwd.cu``, the port of ``_bwd_kernel``), which returns the
  packed dqkv and the fp32 cotangents of the four RoPE tables;
- :func:`attn_out_collect` wraps kernel B3 (``csrc/attn_out_collect.cu``,
  the port of ``_collect_kernel``); its backward is
  :func:`attn_out_scatter`, kernel B7 (``csrc/attn_out_scatter.cu``, the
  port of ``_scatter_kernel``);
- :func:`attention_from_packed_qkv` runs B2 -> B1 -> B3, the route of every
  UViT transformer block, and B7 -> B4, B5 -> B6 on the way back.

The two differentiable passes are ``torch.library`` custom ops with their
autograd formulas: ``dfot::qkv_prep`` (B2, B6) and ``dfot::attn_out_collect``
(B3, B7), one op each, as the JAX package's two ``custom_vjp``s, so that a
selective checkpoint (``models/remat.py``) sees them and can keep B3's
output. A CUDA tensor goes to the kernels or the call raises; a CPU tensor
takes the plain versions (the ops' CPU implementations). RoPE pairs are
ADJACENT lanes (rotate_half is (x0, x1) -> (-x1, x0)); the sign is folded
into the sin table (:func:`signed_sin`) and the learned RMSNorm scale into
both tables before their cast to the model dtype, exactly as the JAX
package does.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .attention import SM_COUNT, _f32, flash_attention, padded_head_dim

# the widest head the kernels B2 and B6 take (csrc/qkv_prep.cu and
# csrc/qkv_prep_bwd.cu: a warp a row, 5 16-byte or 20 4-byte chunks a lane)
PREP_MAX_HEAD_DIM = 1280

__all__ = [
    "signed_sin",
    "swap_pairs",
    "fold_qk_tables",
    "qkv_prep",
    "qkv_prep_bwd",
    "prep_bwd_plan",
    "reference_qkv_prep",
    "attn_out_collect",
    "collect_plan",
    "attn_out_scatter",
    "scatter_plan",
    "reference_attn_out_collect",
    "reference_attn_out_scatter",
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
    Plain differentiable tensor ops: the table cotangents that
    :func:`qkv_prep_bwd` returns reach the scales through them.
    """
    c, s = _f32(cos), _f32(sin_signed)
    out = []
    for scale in (q_scale, k_scale):
        if scale is None:
            pair = (c, s)
        else:
            pair = (c * _f32(scale), s * swap_pairs(_f32(scale)))
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
                tf = _f32(t)
                r = torch.rsqrt(tf.pow(2).mean(-1, keepdim=True) + eps)
                t = (tf * r).to(qkv.dtype)
            c, s = tabs[i]
            t = t * c + swap_pairs(t) * s
        if d_out > head_dim:
            t = torch.nn.functional.pad(t, (0, d_out - head_dim))
        # v with no pad is a view of qkv: the op's outputs must be fresh tensors
        outs.append(t.contiguous() if i < 2 or d_out > head_dim
                    else t.clone(memory_format=torch.contiguous_format))
    return tuple(outs)


def _prep_bwd_plain(qkv, tabs, dq, dk, dv, heads, head_dim, norm, eps):
    """Plain version of kernel B6: the VJP of :func:`_prep_plain`.

    Returns the packed dqkv (B, N, 3*H*D) in qkv's dtype and the table
    cotangents (dcq, dsq, dck, dsk), each (N, D) fp32, summed over batch
    and heads. Arithmetic in fp32, as the kernel's."""
    B, N, _ = qkv.shape
    D = head_dim
    x = qkv.reshape(B, N, 3, heads, D)
    streams, dtabs = [], []
    for i, dy in enumerate((dq, dk)):
        dy = _f32(dy[..., :D].transpose(1, 2))  # (B, N, H, D)
        c, s = (_f32(t)[None, :, None, :] for t in tabs[i])
        du = dy * c + swap_pairs(dy * s)
        xf = _f32(x[:, :, i])
        if norm:
            r = torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
            dx = r * du - xf * (r.pow(3) * (du * xf).mean(-1, keepdim=True))
            u = _f32((xf * r).to(qkv.dtype))  # the u the forward multiplied
        else:
            dx, u = du, xf
        streams.append(dx.to(qkv.dtype))
        dtabs += [(u * dy).sum((0, 2)), (swap_pairs(u) * dy).sum((0, 2))]
    streams.append(dv[..., :D].transpose(1, 2).to(qkv.dtype))
    return (torch.stack(streams, dim=2).reshape(B, N, 3 * heads * D), *dtabs)


def _check_prep_operands(what, qkv, tabs, head_dim, d_out):
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16, got {qkv.dtype}")
    if qkv.stride(-1) != 1 or qkv.stride(0) % 2 or qkv.stride(1) % 2:
        raise ValueError(f"{what} kernel needs a unit, even-aligned last dim, strides {qkv.stride()}")
    if head_dim % 2 or head_dim > PREP_MAX_HEAD_DIM or d_out % 2:
        raise ValueError(f"{what} kernel takes even head dims <= {PREP_MAX_HEAD_DIM}, "
                         f"got {head_dim}/{d_out}")
    flat = tuple(t.contiguous() for pair in tabs for t in pair)
    if any(t.device != qkv.device for t in flat):
        raise ValueError("RoPE tables must be on the device of qkv")
    _cuda.check_aligned(what, 4, qkv, *flat)
    return flat


def _prep_cuda(qkv, tabs, heads, head_dim, d_out, norm, eps):
    B, N, _ = qkv.shape
    cq, sq, ck, sk = _check_prep_operands("qkv_prep", qkv, tabs, head_dim, d_out)
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


# kernel B6's plan (csrc/qkv_prep_bwd.cu)
PREP_BWD_THREADS = 256
PREP_BWD_STAGES = 6         # a lane's ring of cp.async stages
PREP_BWD_STAGE_BYTES = 2 * 16 * PREP_BWD_THREADS  # a stage: every lane's x and dy chunks
PREP_BWD_BLOCKS_PER_SM = 3  # blocks an SM holds: the tile is chosen for this grid
# above a head dim of 256 a warp owns a row and a lane holds several chunks:
# one block an SM, three stages
PREP_BWD_WIDE_STAGES = 3
PREP_BWD_WIDE_BLOCKS_PER_SM = 1


@functools.lru_cache(maxsize=256)
def prep_bwd_plan(B: int, N: int, H: int, d: int, dp: int, chunk: int = 8) -> dict:
    """Plan of kernel B6 for a (B, N, 3*H*d) packed qkv and (B, H, N, dp)
    cotangents, as its C entry computes it again and checks it.

    ``chunk``: bf16 lanes a thread moves at once, 8 (16 bytes) or 2 (4
    bytes, where d, dp, a stride or a pointer is off 16 bytes). ``lanes``:
    the power of two of lanes that covers a row's d / chunk chunks (at most
    32). A block of 256 threads owns ``tile`` tokens of one stream, the
    largest of 32, 16, 8, 4, 2 whose rows fit the block and whose 2 x tiles
    blocks give the :data:`SM_COUNT` SMs :data:`PREP_BWD_BLOCKS_PER_SM` each,
    as many as one holds (else 1); its ``groups`` = 256 / (tile x lanes)
    lane groups take the B x H (batch, head) items in turns, ``rounds``
    items a group, each lane streaming its chunks through a private ring of
    ``stages`` cp.async stages. ``grid``: the 2 x tiles q and k blocks (each
    also copies the v cotangent of half the items of its tile).
    ``smem_bytes``: the rings (48 KB), where the groups' fp32 partials of
    the table cotangents (at most 16 KB) meet at the end. Above d = 256
    (up to :data:`PREP_MAX_HEAD_DIM`) a warp owns a row and a lane holds
    ``chunks`` chunks (2, 3 or 5 of 16 bytes by d, or 20 of 4), one block an
    SM (:data:`PREP_BWD_WIDE_BLOCKS_PER_SM`) and
    :data:`PREP_BWD_WIDE_STAGES` stages; the partials (64 d bytes) still fit
    the rings.
    """
    if (chunk not in (8, 2) or not 0 < d <= PREP_MAX_HEAD_DIM or d % chunk or dp < d
            or dp % chunk):
        raise ValueError(f"no qkv_prep backward plan for d {d}, dp {dp}, chunk {chunk}")
    if min(B, N, H) <= 0:
        raise ValueError(f"no qkv_prep backward plan for B {B}, N {N}, H {H}")
    wide = d > 256
    lanes = 1
    while lanes * chunk < d and lanes < 32:
        lanes *= 2
    per_sm = PREP_BWD_WIDE_BLOCKS_PER_SM if wide else PREP_BWD_BLOCKS_PER_SM
    tile = next((t for t in (32, 16, 8, 4, 2) if t * lanes <= PREP_BWD_THREADS
                 and 2 * -(-N // t) >= per_sm * SM_COUNT), 1)
    groups = PREP_BWD_THREADS // (tile * lanes)
    tiles = -(-N // tile)
    if not wide:
        chunks = 1 if chunk == 8 else 4
    else:
        chunks = 20 if chunk == 2 else 2 if d <= 512 else 3 if d <= 768 else 5
    stages = PREP_BWD_WIDE_STAGES if wide else PREP_BWD_STAGES
    return {"chunk": chunk, "lanes": lanes, "tile": tile, "groups": groups,
            "rounds": -(-(B * H) // groups), "stages": stages, "chunks": chunks,
            "smem_bytes": stages * 2 * chunks * PREP_BWD_THREADS * 2 * chunk,
            "partials_bytes": groups * 2 * tile * d * 4,
            "tiles": tiles, "grid": 2 * tiles}


def _prep_bwd_chunk(qkv, d, dp, tensors) -> int:
    """16-byte chunks (8) where d, dp, qkv's strides and every pointer allow
    them, else 4-byte ones (2): the rule the C entry checks."""
    B = qkv.shape[0]
    ok = (d % 8 == 0 and dp % 8 == 0 and qkv.stride(1) % 8 == 0
          and (B == 1 or qkv.stride(0) % 8 == 0)
          and all(t.data_ptr() % 16 == 0 for t in (qkv, *tensors)))
    return 8 if ok else 2


def _prep_bwd_cuda(qkv, tabs, dq, dk, dv, heads, head_dim, norm, eps):
    B, N, W = qkv.shape
    d_out = dq.shape[-1]
    cq, sq, ck, sk = _check_prep_operands("qkv_prep backward", qkv, tabs, head_dim, d_out)
    grads = tuple(g.contiguous() for g in (dq, dk, dv))
    for g in grads:
        if g.dtype != qkv.dtype or g.shape != (B, heads, N, d_out) or g.device != qkv.device:
            raise ValueError(
                f"qkv_prep backward: cotangents must be ({B}, {heads}, {N}, {d_out}) "
                f"{qkv.dtype} on {qkv.device}, got {tuple(g.shape)} {g.dtype} on {g.device}"
            )
    _cuda.check_aligned("qkv_prep backward", 4, *grads)
    dqkv = torch.empty((B, N, W), dtype=qkv.dtype, device=qkv.device)
    dtabs = [torch.empty((N, head_dim), dtype=torch.float32, device=qkv.device) for _ in range(4)]
    plan = prep_bwd_plan(B, N, heads, head_dim, d_out,
                         _prep_bwd_chunk(qkv, head_dim, d_out, (cq, sq, ck, sk, *grads, dqkv)))
    _cuda.check(
        _cuda.library().dfot_qkv_prep_bwd(
            qkv.data_ptr(), qkv.stride(0), qkv.stride(1),
            cq.data_ptr(), sq.data_ptr(), ck.data_ptr(), sk.data_ptr(),
            *(g.data_ptr() for g in grads),
            dqkv.data_ptr(), dqkv.stride(0), dqkv.stride(1),
            *(t.data_ptr() for t in dtabs),
            B, N, heads, head_dim, d_out, int(norm), float(eps), plan["chunk"], plan["tile"],
            plan["groups"], plan["stages"], plan["smem_bytes"], plan["grid"],
            _cuda.stream_handle(qkv.device),
        ),
        "qkv_prep backward",
    )
    qkv_prep_bwd.launches += 1
    return (dqkv, *dtabs)


def _check_prep_shapes(qkv, tabs, heads, head_dim, d_out):
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


def _prep(qkv, tabs, heads, head_dim, d_out, norm, eps, plain=False):
    """Check the shapes, then kernel B2 for a CUDA tensor or its plain
    version for a CPU tensor (or on any device with ``plain``).
    ``tabs``: folded (N, head_dim) tables in qkv's dtype."""
    _check_prep_shapes(qkv, tabs, heads, head_dim, d_out)
    if plain or qkv.device.type == "cpu":
        return _prep_plain(qkv, tabs, heads, head_dim, d_out, norm, eps)
    if not qkv.is_cuda:
        raise ValueError(f"no qkv_prep path for device {qkv.device}")
    return _prep_cuda(qkv, tabs, heads, head_dim, d_out, norm, eps)


def qkv_prep_bwd(qkv, tabs, dq, dk, dv, heads, head_dim, norm=False, eps=1e-6, plain=False):
    """VJP of the qkv preparation on folded tables.

    ``qkv``: the packed (B, N, 3*H*D) tensor the forward read (it may be a
    strided slice of a wider projection); ``tabs``: the folded
    ``((cq, sq), (ck, sk))`` in qkv's dtype; ``dq, dk, dv``: (B, H, N, d_out)
    cotangents. Returns ``(dqkv, dcq, dsq, dck, dsk)``: the packed gradient,
    contiguous, in qkv's dtype and the four (N, D) fp32 table cotangents,
    summed over batch and heads. Kernel B6 for a CUDA tensor, its plain
    version for a CPU tensor (or on any device with ``plain``)."""
    _check_prep_shapes(qkv, tabs, heads, head_dim, dq.shape[-1])
    if plain or qkv.device.type == "cpu":
        return _prep_bwd_plain(qkv, tabs, dq, dk, dv, heads, head_dim, norm, eps)
    if not qkv.is_cuda:
        raise ValueError(f"no qkv_prep path for device {qkv.device}")
    return _prep_bwd_cuda(qkv, tabs, dq, dk, dv, heads, head_dim, norm, eps)


def _cast_tables(qkv, cq, sq, ck, sk):
    return (cq.to(qkv.dtype), sq.to(qkv.dtype)), (ck.to(qkv.dtype), sk.to(qkv.dtype))


@torch.library.custom_op(
    "dfot::qkv_prep", mutates_args=(), device_types="cpu",
    schema=("(Tensor qkv, Tensor cq, Tensor sq, Tensor ck, Tensor sk, "
            "int heads, int head_dim, int d_out, bool norm, float eps, bool plain)"
            " -> (Tensor, Tensor, Tensor)"))
def _qkv_prep_op(qkv: torch.Tensor, cq: torch.Tensor, sq: torch.Tensor, ck: torch.Tensor,
                 sk: torch.Tensor, heads: int, head_dim: int, d_out: int, norm: bool,
                 eps: float, plain: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v from the packed qkv and folded tables of any float dtype (cast
    to qkv's here, after the fold): the plain version (the implementation for
    CPU tensors, and for any tensor with ``plain``)."""
    tabs = _cast_tables(qkv, cq, sq, ck, sk)
    _check_prep_shapes(qkv, tabs, heads, head_dim, d_out)
    return _prep_plain(qkv, tabs, heads, head_dim, d_out, norm, eps)


@_qkv_prep_op.register_kernel("cuda")
def _(qkv, cq, sq, ck, sk, heads, head_dim, d_out, norm, eps, plain):
    tabs = _cast_tables(qkv, cq, sq, ck, sk)
    return _prep(qkv, tabs, heads, head_dim, d_out, norm, eps, plain)


@_qkv_prep_op.register_fake
def _(qkv, cq, sq, ck, sk, heads, head_dim, d_out, norm, eps, plain):
    B, N, _ = qkv.shape
    return tuple(qkv.new_empty((B, heads, N, d_out)) for _ in range(3))


def _qkv_prep_setup(ctx, inputs, output):
    qkv, cq, sq, ck, sk, heads, head_dim, d_out, norm, eps, plain = inputs
    ctx.save_for_backward(qkv, cq, sq, ck, sk)
    ctx.args = (heads, head_dim, norm, eps, plain)


def _qkv_prep_backward(ctx, dq, dk, dv):
    """B6 (or its plain version): the packed gradient and the fp32 table
    cotangents, cast to each table's dtype."""
    qkv, *tables = ctx.saved_tensors
    dqkv, *dtabs = qkv_prep_bwd(qkv, _cast_tables(qkv, *tables), dq, dk, dv, *ctx.args)
    dtabs = [g.to(t.dtype) if need else None
             for g, t, need in zip(dtabs, tables, ctx.needs_input_grad[1:5])]
    return (dqkv if ctx.needs_input_grad[0] else None, *dtabs, *(None,) * 6)


_qkv_prep_op.register_autograd(_qkv_prep_backward, setup_context=_qkv_prep_setup)


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
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N, 3*H*D) packed qkv -> q, k, v, each (B, H, N, d_out).

    ``cos``/``sin_signed``: (N, D) tables, sign already folded. With ``norm``,
    q and k get the per-head fp32 1/rms(x); their learned scales are folded
    into the tables here. ``d_out`` zero-pads each head. Differentiable in
    qkv and in the scales. The JAX package's ones lane on v (``aug_v``) is a
    TPU matrix-unit device and not produced. ``plain`` runs the plain
    versions on any device.
    """
    n = qkv.shape[1]
    (cq, sq), (ck, sk) = fold_qk_tables(
        cos[:n], sin_signed[:n], q_scale, k_scale,
        torch.float64 if qkv.dtype == torch.float64 else torch.float32,
    )
    return _qkv_prep_op(qkv, cq, sq, ck, sk, heads, head_dim, d_out or head_dim, norm, eps, plain)


def reference_qkv_prep(qkv, heads, head_dim, cos, sin_signed, **kwargs):
    """Plain version of :func:`qkv_prep` on any device (the oracle the
    kernel is held against)."""
    return qkv_prep(qkv, heads, head_dim, cos, sin_signed, plain=True, **kwargs)


def reference_attn_out_collect(o: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Plain version of :func:`attn_out_collect` on any device."""
    B, H, N, _ = o.shape
    return o[..., :head_dim].transpose(1, 2).reshape(B, N, H * head_dim)


def reference_attn_out_scatter(g: torch.Tensor, heads: int, head_dim: int,
                               d_in: int) -> torch.Tensor:
    """Plain version of :func:`attn_out_scatter` on any device."""
    B, N, _ = g.shape
    do = g.reshape(B, N, heads, head_dim).transpose(1, 2)
    return torch.nn.functional.pad(do, (0, d_in - head_dim)).contiguous()


def _check_collect_operands(what, t, head_dim, d_in):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16, got {t.dtype}")
    if head_dim % 8 or d_in % 8 or d_in < head_dim:
        raise ValueError(f"{what} kernel takes D, DP multiples of 8, got {head_dim}/{d_in}")


# kernels B3's and B7's plan (csrc/attn_out_collect.cu, csrc/attn_out_scatter.cu)
COLLECT_THREADS = 256
COLLECT_VEC_PER_THREAD = 4   # 16-byte vectors in flight a thread
COLLECT_MIN_BLOCKS_PER_SM = 2


def _token_tile_plan(what: str, B: int, H: int, N: int, d: int, dp: int, row: int) -> dict:
    """A block owns ``tile`` whole token rows of one batch entry, the grid
    is (``grid_x`` token tiles, B), the last tile of a batch entry ragged.
    ``tile`` is the tokens whose ``row`` 16-byte vectors each a block's
    :data:`COLLECT_THREADS` threads move with :data:`COLLECT_VEC_PER_THREAD`
    each (at least 1, at most N), halved while the grid would give the
    :data:`SM_COUNT` SMs fewer than :data:`COLLECT_MIN_BLOCKS_PER_SM` blocks
    each."""
    if d <= 0 or d % 8 or dp % 8 or dp < d:
        raise ValueError(f"no {what} plan for d {d}, dp {dp} (multiples of 8, dp >= d)")
    if min(B, H, N) <= 0 or B > 65535:
        raise ValueError(f"no {what} plan for B {B}, H {H}, N {N}")
    tile = min(N, max(1, COLLECT_THREADS * COLLECT_VEC_PER_THREAD // row))
    while tile > 1 and -(-N // tile) * B < COLLECT_MIN_BLOCKS_PER_SM * SM_COUNT:
        tile //= 2
    return {"tile": tile, "grid": (-(-N // tile), B), "threads": COLLECT_THREADS}


@functools.lru_cache(maxsize=256)
def collect_plan(B: int, H: int, N: int, d: int, dp: int) -> dict:
    """Plan of kernel B3 for a (B, H, N, dp) input of true head dim ``d``,
    as its C entry computes it again and checks it: a block owns ``tile``
    whole token rows (all H heads, H * d / 8 16-byte vectors a token) of one
    batch entry (:func:`_token_tile_plan`), so every (batch, head, token) once.
    """
    return _token_tile_plan("attn_out_collect", B, H, N, d, dp, H * d // 8)


@functools.lru_cache(maxsize=256)
def scatter_plan(B: int, H: int, N: int, d: int, dp: int) -> dict:
    """Plan of kernel B7 for a (B, N, H * d) cotangent scattered to
    (B, H, N, dp), as its C entry computes it again and checks it: B3's
    blocks (:func:`_token_tile_plan`) over H * dp / 8 16-byte output slots a
    token (pad lanes included), so every (batch, token, head, output lane)
    once; a block's input is one contiguous run, its output one run of
    ``tile`` rows a head.
    """
    return _token_tile_plan("attn_out_scatter", B, H, N, d, dp, H * dp // 8)


def _collect_cuda(o, head_dim):
    B, H, N, DP = o.shape
    _check_collect_operands("attn_out_collect", o, head_dim, DP)
    o = o.contiguous()
    out = torch.empty((B, N, H * head_dim), dtype=o.dtype, device=o.device)
    _cuda.check_aligned("attn_out_collect", 16, o, out)
    plan = collect_plan(B, H, N, head_dim, DP)
    _cuda.check(
        _cuda.library().dfot_attn_out_collect(
            o.data_ptr(), out.data_ptr(), B, H, N, head_dim, DP, plan["tile"], plan["grid"][0],
            _cuda.stream_handle(o.device),
        ),
        "attn_out_collect",
    )
    attn_out_collect.launches += 1
    return out


def _scatter_cuda(g, heads, head_dim, d_in):
    B, N, W = g.shape
    _check_collect_operands("attn_out_scatter", g, head_dim, d_in)
    g = g.contiguous()
    do = torch.empty((B, heads, N, d_in), dtype=g.dtype, device=g.device)
    _cuda.check_aligned("attn_out_scatter", 16, g, do)
    plan = scatter_plan(B, heads, N, head_dim, d_in)
    _cuda.check(
        _cuda.library().dfot_attn_out_scatter(
            g.data_ptr(), do.data_ptr(), B, heads, N, head_dim, d_in, plan["tile"],
            plan["grid"][0], _cuda.stream_handle(g.device),
        ),
        "attn_out_scatter",
    )
    attn_out_scatter.launches += 1
    return do


def attn_out_scatter(g: torch.Tensor, heads: int, head_dim: int, d_in: int,
                     plain: bool = False) -> torch.Tensor:
    """(B, N, H*head_dim) merged-token cotangent -> (B, H, N, d_in): split
    the heads and zero the pad lanes in one pass (the VJP of
    :func:`attn_out_collect`). Kernel B7 for a CUDA tensor, its plain version
    for a CPU tensor (or on any device with ``plain``)."""
    if g.shape[-1] != heads * head_dim:
        raise ValueError(f"merged width {g.shape[-1]} does not match {heads} * {head_dim}")
    if plain or g.device.type == "cpu":
        return reference_attn_out_scatter(g, heads, head_dim, d_in)
    if not g.is_cuda:
        raise ValueError(f"no attn_out_scatter path for device {g.device}")
    return _scatter_cuda(g, heads, head_dim, d_in)


@torch.library.custom_op(
    "dfot::attn_out_collect", mutates_args=(), device_types="cpu",
    schema="(Tensor o, int head_dim, bool plain) -> Tensor")
def _collect_op(o: torch.Tensor, head_dim: int, plain: bool) -> torch.Tensor:
    """The merged heads: the plain version (the implementation for CPU
    tensors, and for any tensor with ``plain``), always a fresh tensor."""
    return reference_attn_out_collect(o, head_dim).clone(memory_format=torch.contiguous_format)


@_collect_op.register_kernel("cuda")
def _(o, head_dim, plain):
    if plain:
        return reference_attn_out_collect(o, head_dim).clone(memory_format=torch.contiguous_format)
    return _collect_cuda(o, head_dim)


@_collect_op.register_fake
def _(o, head_dim, plain):
    B, H, N, _ = o.shape
    return o.new_empty((B, N, H * head_dim))


def _collect_setup(ctx, inputs, output):
    o, head_dim, plain = inputs
    ctx.args = (o.shape[1], head_dim, o.shape[-1], plain)


def _collect_backward(ctx, g):
    return attn_out_scatter(g, *ctx.args), None, None


_collect_op.register_autograd(_collect_backward, setup_context=_collect_setup)


def attn_out_collect(o: torch.Tensor, head_dim: int, plain: bool = False) -> torch.Tensor:
    """(B, H, N, DP) attention output -> (B, N, H*head_dim), through the
    custom op ``dfot::attn_out_collect``: drop the pad lanes and merge the
    heads in one pass, kernel B3 for a CUDA tensor, its plain version for a
    CPU tensor (or on any device with ``plain``). Differentiable (B7 back).
    It makes the output that the JAX models tag ``attn_out`` on the packed
    route: the ``attn`` remat policies save it (``models/remat.py``)."""
    return _collect_op(o, head_dim, plain)


# kernel launches since the last reset
qkv_prep.launches = 0
qkv_prep_bwd.launches = 0
attn_out_collect.launches = 0
attn_out_scatter.launches = 0


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

    ``tables``: the folded ``((cq, sq), (ck, sk))`` of :func:`fold_qk_tables`,
    (>= N, D) each, or None for no rotation and no learned scale; in qkv's
    dtype, or in fp32 where their cotangents are wanted (they are cast after
    the fold either way). Softmax scale is 1/sqrt(D) of the true head dim,
    also where the heads are padded to a width the kernels take.
    Differentiable in qkv and the tables. ``plain=True`` runs the plain
    versions of all the kernels, forward and backward, on any device: the
    reference a caller compares the kernel route with.
    """
    B, N, _ = qkv.shape
    D = head_dim
    if tables is None:
        ones = torch.ones((N, D), dtype=torch.float32, device=qkv.device)
        tables = fold_qk_tables(ones, torch.zeros_like(ones), dtype=qkv.dtype)
    (cq, sq), (ck, sk) = ((c[:N], s[:N]) for c, s in tables)
    # a head dim the flash kernels are not compiled for (K600 @DiT/XL: 72) is
    # zero-padded to the next width they take by B2 and cut back by B3; the
    # pad lanes are inert in every product, B1, B4 and B5 compute only the
    # true head dim's lanes, and B6/B7 drop and re-zero the cotangents of the rest
    DP = padded_head_dim(D)
    q, k, v = _qkv_prep_op(qkv, cq, sq, ck, sk, heads, D, DP, norm, eps, plain)
    o = flash_attention(q, k, v, causal, 1.0 / math.sqrt(D), plain=plain, head_dim=D)
    return attn_out_collect(o, D, plain)
