"""Attention ops: the flash-attention kernels and their plain versions.

Port of ``dfot_tpu/ops/attention.py``. Layout (B, H, N, D) as in the JAX
package.

- :func:`flash_attention` is differentiable: its forward is kernel B1
  (``csrc/flash_fwd.cu``, the port of ``_flash_kernel``), which saves q, k,
  v, O and the LSE; its backward computes delta = rowsum(dO * O) with plain
  tensor ops, as the JAX package does, and calls :func:`flash_bwd_dq`
  (kernel B4, the port of ``_flash_bwd_dq_kernel`` and of its streaming twin)
  and :func:`flash_bwd_dkv` (kernel B5, the port of
  ``_flash_bwd_dkv_kernel``), both in ``csrc/flash_bwd.cu``. B1, B4 and B5
  are wgmma kernels whose tile plan (:func:`flash_plan`) is computed here
  and checked by their C entries; they take padded head dims of 64, 128 and
  256 (:data:`FLASH_WIDTHS`), and where q, k, v are zero-padded heads, the
  true head dim (``head_dim``) lets them compute only its lanes.
- A CUDA tensor goes to the kernels or the call raises; a CPU tensor takes
  the plain versions: :func:`attention_reference` (the counterpart of
  ``_xla_attention``: fp32 scores, fp32 softmax, one cast at the end) and
  :func:`attention_backward_reference` (the explicit backward formulas in
  fp32, not autograd of the forward).
- :func:`small_n_attention` is whole-row attention for N <= 32: its forward
  is kernel B10 (``csrc/small_n_attn.cu``, the port of ``_small_n_kernel``),
  its backward the plain backward formulas, as the JAX package leaves it to
  autodiff of its plain attention. Plain version:
  :func:`small_n_attention_reference`.
- :func:`attention` is the dispatcher (counterpart of ``attention``); its
  rule is :func:`attention_route`. With a ring set by
  :func:`set_sequence_parallel` (the counterpart of ``set_sequence_parallel``,
  :954), the non-causal shapes the ring owns go to
  ``ring_attention.sequence_parallel_attention``.

:func:`flash_attention` and :func:`small_n_attention` dispatch through the
``torch.library`` custom ops ``dfot::flash_attention`` (O and LSE; B1
forward, B4 + B5 backward) and ``dfot::small_n_attention`` (B10), whose CPU
implementations are the plain versions and CUDA ones the kernels, so that
``torch.utils.checkpoint``'s selective contexts see them
(``models/remat.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from . import _cuda

__all__ = [
    "attention", "attention_reference", "attention_backward_reference",
    "flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "flash_plan",
    "small_n_attention", "small_n_attention_reference", "small_n_plan", "attention_route",
    "padded_head_dim", "set_sequence_parallel",
    "attention_with_weights", "set_attention_capture", "attention_capture_enabled",
]

# debug switch (``dfot_tpu/ops/attention.py:61-73``): when on, the DiT's
# attention takes the weights-returning plain path and records its (B, H, N,
# N) maps (``utils/attn_capture.py``)
_CAPTURE_ATTENTION = False


def set_attention_capture(enabled: bool) -> bool:
    """Switch attention capture on or off; returns the setting it replaces."""
    global _CAPTURE_ATTENTION
    prior, _CAPTURE_ATTENTION = _CAPTURE_ATTENTION, bool(enabled)
    return prior


def attention_capture_enabled() -> bool:
    return _CAPTURE_ATTENTION


def attention_with_weights(q, k, v, causal: bool = False):
    """Plain attention that also returns the (B, H, N, N) fp32 weights
    (``dfot_tpu/ops/attention.py:1016``): the scores in fp32, scaled by
    1/sqrt(d), causal-masked, softmaxed, and the weights in q's dtype times
    v. A debug path, not a kernel."""
    d = q.shape[-1]
    s = torch.einsum("bhnd,bhmd->bhnm", q, k).float() / math.sqrt(d)
    if causal:
        n, m = s.shape[-2:]
        s = s.masked_fill(~torch.ones(n, m, dtype=torch.bool, device=s.device).tril(), -1e30)
    w = s.softmax(dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", w.to(q.dtype), v), w


def _full_precision(fn):
    """Run a plain version outside any autocast region: its fp32 products
    are the reference and must not be downcast."""

    @functools.wraps(fn)
    def wrapped(q, *args, **kwargs):
        with torch.autocast(device_type=q.device.type, enabled=False):
            return fn(q, *args, **kwargs)

    return wrapped


def _f32(t: torch.Tensor) -> torch.Tensor:
    """Upcast to the plain versions' working precision: fp32, or fp64 for an
    fp64 input (gradient checks)."""
    return t if t.dtype == torch.float64 else t.float()


def _scores(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    """fp32 scaled scores, -inf above the diagonal when causal."""
    s = torch.matmul(_f32(q), _f32(k).transpose(-1, -2)) * sm_scale
    if causal:
        n, m = s.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


@_full_precision
def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Plain attention: (B, H, N, D) -> (B, H, N, D) [, lse (B, H, N, 1)].

    The lse is in natural-log units of the scaled scores, as the kernel's.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.matmul(torch.exp(s - lse), _f32(v)).to(q.dtype)
    return (out, lse) if return_lse else out


@_full_precision
def _dq_plain(q, k, v, do, lse, delta, causal, sm_scale):
    """Plain version of kernel B4: dq = scale * (p * (dO v^T - delta)) k."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse)
    ds = p * (torch.matmul(_f32(do), _f32(v).transpose(-1, -2)) - delta)
    return (torch.matmul(ds, _f32(k)) * sm_scale).to(q.dtype)


@_full_precision
def _dkv_plain(q, k, v, do, lse, delta, causal, sm_scale):
    """Plain version of kernel B5: dk = scale * ds^T q, dv = p^T dO."""
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse)
    dv = torch.matmul(p.transpose(-1, -2), _f32(do))
    ds = p * (torch.matmul(_f32(do), _f32(v).transpose(-1, -2)) - delta)
    dk = torch.matmul(ds.transpose(-1, -2), _f32(q)) * sm_scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, do) -> torch.Tensor:
    """rowsum(dO * O) in fp32, (B, H, N, 1)."""
    return (_f32(do) * _f32(o)).sum(-1, keepdim=True)


def attention_backward_reference(q, k, v, o, lse, do, causal=False, sm_scale=None):
    """Plain attention backward from the saved forward results:
    (dq, dk, dv), each in its input's dtype. ``lse``: (B, H, N, 1) fp32."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    delta = _delta(o, do)
    dq = _dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    return (dq, *_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale))


def _check_qkv(what, q, *others):
    """The kernels' common contract: bf16 (B, H, N, D), one shape and
    device, D in :data:`FLASH_WIDTHS`, N a multiple of 64."""
    B, H, N, D = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, *others)):
        raise TypeError(f"{what} takes bf16, got {[t.dtype for t in (q, *others)]}")
    if any(t.shape != q.shape for t in others):
        raise ValueError(f"{what}: shapes differ: {[tuple(t.shape) for t in (q, *others)]}")
    if D not in FLASH_WIDTHS or N % 64 or B * H > 65535:
        raise ValueError(f"{what} takes d in {FLASH_WIDTHS} and N % 64 == 0, "
                         f"got {tuple(q.shape)}")
    if any(t.device != q.device for t in others):
        raise ValueError(f"{what}: tensors on different devices")


def _check_stats(what, q, *stats):
    B, H, N, _ = q.shape
    for t in stats:
        if t.dtype != torch.float32 or t.shape != (B, H, N, 1) or t.device != q.device:
            raise ValueError(
                f"{what}: lse/delta must be fp32 ({B}, {H}, {N}, 1) on {q.device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


# The wgmma kernels' tile plan (B1 csrc/flash_fwd.cu, B4 and B5
# csrc/flash_bwd.cu): each C entry takes it and refuses a plan other than the
# one it was built for. Tables by padded head dim; at d = 256 the tiles are
# narrower, for the O, dQ, dK and dV accumulators of 256 lanes take 128
# registers a consumer thread and Q, K, V rows twice the shared memory.
FLASH_WIDTHS = (64, 128, 256)  # padded head dims the kernels are compiled for
FLASH_BLOCK = 128           # query rows of a B1 or B4 block
FLASH_BWD_Q_ROWS = 64       # query rows of a tile that streams through B5
FLASH_FWD_KEYS = {64: 128, 128: 128, 256: 64}  # keys of a K/V tile that streams through B1
FLASH_DQ_KEYS = {64: 128, 128: 64, 256: 32}    # keys of a K/V tile that streams through B4
# keys of a B5 block: 64 for each of its two consumers, or at d = 256 64 that
# both share (consumer 0 accumulates their dV, consumer 1 their dK)
FLASH_DKV_KEYS = {64: 128, 128: 128, 256: 64}
FLASH_MAX_STAGES = 4
# lanes a kernel instantiation computes, by padded head dim: the true head dim
# rounded up to 16 and then to the next compiled width
FLASH_LANES = {64: (64,), 128: (80, 128), 256: (192, 256)}
SMEM_PER_BLOCK = 232448     # shared memory one H100 block can take (227 KB)


def padded_head_dim(d: int) -> int:
    """The head dim the kernels take for heads of ``d`` lanes: the smallest
    of :data:`FLASH_WIDTHS` that holds d (the JAX package pads to the next
    multiple of 64 instead: 192 where the port pads to 256; zero lanes are
    inert either way). Past the widest, the next multiple of 64, which no
    kernel takes."""
    return next((w for w in FLASH_WIDTHS if w >= d), d + (-d % 64))


def flash_plan(kernel: str, bh: int, n: int, d: int, head_dim: Optional[int] = None) -> dict:
    """Tile plan of kernel B1 (``kernel="fwd"``), B4 (``"dq"``) or B5
    (``"dkv"``) for ``bh`` heads of ``n`` tokens, padded head dim ``d`` and
    true head dim ``head_dim`` (default ``d``).

    Tiles are 64-lane column blocks of 128-byte rows (TMA's 128-byte swizzle).
    B1 holds a 128-row Q tile and streams K and V tiles of
    :data:`FLASH_FWD_KEYS` keys through ``stages`` ring slots; B4 holds 128
    rows of Q and dO and streams K and V tiles of :data:`FLASH_DQ_KEYS` keys;
    B5 holds :data:`FLASH_DKV_KEYS` keys of K and V and streams 64-row Q and
    dO tiles with their LSE and delta slices. ``tile_rows``: the rows of a
    streamed tile; ``block_rows``: the rows (B1, B4: queries; B5: keys) a
    block owns, which set the grid. Stages: as many as fit the block's shared
    memory, at most four. ``lanes``: the head-dim lanes the kernel computes
    (products contract over ``k_steps`` = lanes / 16 steps); ``smem_bytes``
    includes 1 KB of alignment slack and the mbarriers.
    """
    head_dim = d if head_dim is None else head_dim
    if d not in FLASH_LANES or not 0 < head_dim <= d:
        raise ValueError(f"no flash kernel for head dim {head_dim} padded to {d}")
    rounded = -(-head_dim // 16) * 16
    lanes = next(w for w in FLASH_LANES[d] if w >= rounded)
    row = d * 2  # bytes of one head-dim row of a tile
    if kernel == "fwd":
        block_rows, tile_rows = FLASH_BLOCK, FLASH_FWD_KEYS[d]
        resident, stage = block_rows * row, 2 * tile_rows * row               # Q; K, V
    elif kernel == "dq":
        block_rows, tile_rows = FLASH_BLOCK, FLASH_DQ_KEYS[d]
        resident, stage = 2 * block_rows * row, 2 * tile_rows * row           # Q, dO; K, V
    elif kernel == "dkv":
        block_rows, tile_rows = FLASH_DKV_KEYS[d], FLASH_BWD_Q_ROWS
        resident = 2 * block_rows * row                                       # K, V
        stage = 2 * tile_rows * row + 2 * tile_rows * 4                       # Q, dO, LSE, delta
    else:
        raise ValueError(f"unknown flash kernel {kernel!r}")
    barrier = 8
    stages = min(FLASH_MAX_STAGES,
                 (SMEM_PER_BLOCK - 1024 - resident - barrier) // (stage + 2 * barrier))
    return {
        "tile_rows": tile_rows, "block_rows": block_rows, "stages": stages,
        "smem_bytes": 1024 + resident + stages * stage + barrier * (1 + 2 * stages),
        "lanes": lanes, "k_steps": lanes // 16, "grid": (-(-n // block_rows), bh),
    }


def _flash_cuda(q, k, v, causal, sm_scale, return_lse, head_dim):
    B, H, N, D = q.shape
    _check_qkv("flash attention forward", q, k, v)
    plan = flash_plan("fwd", B * H, N, D, head_dim)
    q, k, v = (t.contiguous() for t in (q, k, v))
    _cuda.check_aligned("flash attention forward", 16, q, k, v)
    out = torch.empty_like(q)
    lse = (
        torch.empty((B, H, N, 1), dtype=torch.float32, device=q.device)
        if return_lse else None
    )
    lib = _cuda.library()
    _cuda.check(
        lib.dfot_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            B * H, N, D, plan["lanes"], plan["stages"], plan["smem_bytes"], float(sm_scale),
            int(causal), _cuda.stream_handle(q.device),
        ),
        "flash attention forward",
    )
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def _bwd_operands(what, q, k, v, do, lse, delta):
    _check_qkv(what, q, k, v, do)
    _check_stats(what, q, lse, delta)
    tensors = tuple(t.contiguous() for t in (q, k, v, do, lse, delta))
    _cuda.check_aligned(what, 16, *tensors)
    return tensors


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                 sm_scale: Optional[float] = None, *,
                 head_dim: Optional[int] = None) -> torch.Tensor:
    """dq of attention from the saved LSE and delta = rowsum(dO * O), both
    (B, H, N, 1) fp32. On a CUDA device this launches kernel B4 (bf16, D in
    {64, 128, 256}, N a multiple of 64; anything else raises); on the CPU it runs
    the plain version. ``head_dim``: the true head dim where q, k, v, do are
    heads zero-padded to D (the kernel then computes only its lanes and
    writes the pad lanes of dq as zeros)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    if not q.is_cuda:
        raise ValueError(f"no flash-attention path for device {q.device}")
    what = "flash attention backward (dq)"
    q, k, v, do, lse, delta = _bwd_operands(what, q, k, v, do, lse, delta)
    B, H, N, D = q.shape
    plan = flash_plan("dq", B * H, N, D, head_dim)
    dq = torch.empty_like(q)
    _cuda.check(
        _cuda.library().dfot_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B * H, N, D, plan["lanes"], plan["stages"],
            plan["smem_bytes"], float(sm_scale), int(causal), _cuda.stream_handle(q.device),
        ),
        what,
    )
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = False,
                  sm_scale: Optional[float] = None, *, head_dim: Optional[int] = None):
    """(dk, dv) of attention, arguments as :func:`flash_bwd_dq`. On a CUDA
    device this launches kernel B5 or raises; on the CPU it runs the plain
    version. ``head_dim``: the true head dim where q, k, v, do are heads
    zero-padded to D (the kernel then computes only its lanes and writes the
    pad lanes of dk and dv as zeros)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _dkv_plain(q, k, v, do, lse, delta, causal, sm_scale)
    if not q.is_cuda:
        raise ValueError(f"no flash-attention path for device {q.device}")
    what = "flash attention backward (dk, dv)"
    q, k, v, do, lse, delta = _bwd_operands(what, q, k, v, do, lse, delta)
    B, H, N, D = q.shape
    plan = flash_plan("dkv", B * H, N, D, head_dim)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _cuda.check(
        _cuda.library().dfot_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * H, N, D, plan["lanes"],
            plan["stages"], plan["smem_bytes"], float(sm_scale), int(causal),
            _cuda.stream_handle(q.device),
        ),
        what,
    )
    flash_bwd_dkv.launches += 1
    return dk, dv


@torch.library.custom_op(
    "dfot::flash_attention", mutates_args=(), device_types="cpu",
    schema=("(Tensor q, Tensor k, Tensor v, "
            "bool causal, float sm_scale, int head_dim, bool plain) -> (Tensor, Tensor)"))
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              sm_scale: float, head_dim: int, plain: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, LSE) of attention: the plain version (the implementation for CPU
    tensors, and for any tensor with ``plain``)."""
    return attention_reference(q, k, v, causal, sm_scale, True)


@_flash_op.register_kernel("cuda")
def _(q, k, v, causal, sm_scale, head_dim, plain):
    if plain:
        return attention_reference(q, k, v, causal, sm_scale, True)
    return _flash_cuda(q, k, v, causal, sm_scale, True, head_dim)


@_flash_op.register_fake
def _(q, k, v, causal, sm_scale, head_dim, plain):
    B, H, N, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, N, 1), dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, sm_scale, head_dim, plain = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.args = (causal, sm_scale, head_dim, plain)
    ctx.mark_non_differentiable(output[1])


def _flash_backward(ctx, do, _dlse):
    """B4 + B5 from the saved (q, k, v, O, LSE), or their plain versions."""
    q, k, v, out, lse = ctx.saved_tensors
    causal, sm_scale, head_dim, plain = ctx.args
    delta = _delta(out, do)
    if plain:
        dq = _dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
        dk, dv = _dkv_plain(q, k, v, do, lse, delta, causal, sm_scale)
    else:
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale, head_dim=head_dim)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale, head_dim=head_dim)
    return dq, dk, dv, None, None, None, None


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
    plain: bool = False,
    *,
    head_dim: Optional[int] = None,
):
    """Flash attention, (B, H, N, D) layout [, lse (B, H, N, 1)], through
    the custom op ``dfot::flash_attention``.

    ``sm_scale`` defaults to 1/sqrt(D). On a CUDA device this launches the
    hand-written kernels, forward and backward (bf16, D in {64, 128, 256}, N a
    multiple of 64; anything else raises); on the CPU, or on any device with
    ``plain``, it runs the plain versions. The LSE carries no gradient.
    ``head_dim`` is for the callers that zero-pad heads to D
    (:func:`_padded_flash`, ``qkv_prep.attention_from_packed_qkv``): the true
    head dim, whose lanes alone the kernels B1, B4 and B5 then compute.
    """
    head_dim = q.shape[-1] if head_dim is None else head_dim
    if not 0 < head_dim <= q.shape[-1]:
        raise ValueError(f"head_dim {head_dim} outside (0, {q.shape[-1]}]")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = _flash_op(q, k, v, causal, float(sm_scale), head_dim, plain)
    return (out, lse) if return_lse else out


# kernel launches since the last reset
flash_attention.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


SMALL_N_MAX = 32
SMALL_N_MAX_D = 256  # kernel B10 takes head dims that are multiples of 64 up to this


@_full_precision
def small_n_attention_reference(q, k, v) -> torch.Tensor:
    """Plain version of kernel B10 on any device: fp32 scaled scores, fp32
    softmax over the whole row, weights rounded to v's dtype, fp32-accumulated
    product, one cast at the end."""
    p = torch.softmax(_scores(q, k, False, 1.0 / math.sqrt(q.shape[-1])), dim=-1)
    return torch.matmul(_f32(p.to(v.dtype)), _f32(v)).to(q.dtype)


# kernel B10's plan (csrc/small_n_attn.cu): a persistent grid whose blocks
# walk groups of items through a ring of shared-memory stages
SM_COUNT = 132              # streaming multiprocessors of an H100 SXM
SMEM_PER_SM = 233472        # shared memory of one SM (228 KB)
SMEM_BLOCK_RESERVE = 1024   # of which the card keeps this much for each block
SMALL_N_MAX_WARPS = 4       # bf16: warps of a block, 16 query rows each
SMALL_N_WARPS_FP32 = 8      # fp32: warps of a block
SMALL_N_MAX_ITEMS_FP32 = 16
SMALL_N_MAX_STAGES = 4
SMALL_N_ROW_PAD = 16        # bytes after each shared-memory row (ldmatrix's banks)


@functools.lru_cache(maxsize=256)
def small_n_plan(items: int, n: int, d: int, dtype: torch.dtype) -> dict:
    """Plan of kernel B10 for ``items`` items of ``n`` tokens and head dim
    ``d`` in ``dtype`` (bf16 or fp32), as its C entry computes it again and
    checks it.

    A stage holds the q, k, v rows of ``items_per_stage`` items, rows padded
    by 16 bytes (``3 n (d e + 16)`` bytes an item). bf16: an item takes
    ``units`` warps (16 query rows each: one for n <= 16, two above) and a
    block ``warps`` = units x items_per_stage, from 4 items (or 2) down; fp32:
    a block is 8 warps whose threads share the stage's items, from as many
    as give its score phase 256 (row, 4-key) tasks (at most 16) down, and
    holds their n x (n + 1) fp32 scores beside the ring. The first count of
    items a stage that, at 4, 2 or 1 blocks an SM, leaves two stages in the
    block's share of the SM's shared memory is taken, with as many stages as
    fit (at most 4); ``grid``: that many blocks an SM over
    :data:`SM_COUNT` SMs, or fewer where there are fewer groups.
    """
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"no small-N kernel for {dtype}")
    if items <= 0 or not 1 <= n <= SMALL_N_MAX or d <= 0 or d % 16 or d > SMALL_N_MAX_D:
        raise ValueError(f"no small-N plan for {items} items of ({n}, {d})")
    fp32 = dtype == torch.float32
    item_bytes = 3 * n * (d * (4 if fp32 else 2) + SMALL_N_ROW_PAD)
    units = 1 if n <= 16 else 2
    tasks = n * -(-n // 4)
    most = (min(SMALL_N_MAX_ITEMS_FP32, -(-256 // tasks)) if fp32
            else SMALL_N_MAX_WARPS // units)
    for ipb in range(most, 0, -1):
        warps = SMALL_N_WARPS_FP32 if fp32 else ipb * units
        stage = ipb * item_bytes
        fixed = -(-ipb * n * (n + 1) * 4 // 16) * 16 if fp32 else 0
        for per_sm in (4, 2, 1):
            budget = min(SMEM_PER_BLOCK, (SMEM_PER_SM - per_sm * SMEM_BLOCK_RESERVE) // per_sm)
            stages = min(SMALL_N_MAX_STAGES, (budget - fixed) // stage)
            if stages >= 2:
                return {"units": 0 if fp32 else units, "warps": warps, "items_per_stage": ipb,
                        "stages": stages, "smem_bytes": fixed + stages * stage,
                        "blocks_per_sm": per_sm,
                        "grid": min(-(-items // ipb), per_sm * SM_COUNT)}
    raise ValueError(f"no small-N plan fits ({n}, {d}) {dtype}")


def _small_n_cuda(q, k, v):
    B, H, N, D = q.shape
    what = "small-N attention"
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes all bf16 or all fp32, got {[t.dtype for t in (q, k, v)]}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: shapes differ: {[tuple(t.shape) for t in (q, k, v)]}")
    if not 1 <= N <= SMALL_N_MAX or D % 64 or not 0 < D <= SMALL_N_MAX_D:
        raise ValueError(f"{what} takes N <= {SMALL_N_MAX} and d in multiples of 64 up to "
                         f"{SMALL_N_MAX_D}, got {tuple(q.shape)}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError(f"{what}: tensors on different devices")
    q, k, v = (t.contiguous() for t in (q, k, v))
    _cuda.check_aligned(what, 16, q, k, v)
    plan = small_n_plan(B * H, N, D, q.dtype)
    out = torch.empty_like(q)
    _cuda.check(
        _cuda.library().dfot_small_n_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N, D,
            1.0 / math.sqrt(D), int(q.dtype == torch.float32), plan["warps"],
            plan["items_per_stage"], plan["stages"], plan["smem_bytes"], plan["grid"],
            _cuda.stream_handle(q.device),
        ),
        what,
    )
    small_n_attention.launches += 1
    return out


@torch.library.custom_op(
    "dfot::small_n_attention", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, bool plain) -> Tensor")
def _small_n_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                plain: bool) -> torch.Tensor:
    """Whole-row attention: the plain version (the implementation for CPU
    tensors, and for any tensor with ``plain``)."""
    return _small_n_plain(q, k, v)


@_small_n_op.register_kernel("cuda")
def _(q, k, v, plain):
    return _small_n_plain(q, k, v) if plain else _small_n_cuda(q, k, v)


def _small_n_plain(q, k, v):
    if q.shape[-2] > SMALL_N_MAX:
        raise ValueError(f"small-N attention takes N <= {SMALL_N_MAX}, got {tuple(q.shape)}")
    return small_n_attention_reference(q, k, v)


@_small_n_op.register_fake
def _(q, k, v, plain):
    return torch.empty_like(q)


def _small_n_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:3])


def _small_n_backward(ctx, do):
    """The plain backward formulas on a recomputed plain forward: at these
    row lengths the N x N scores are tiny."""
    q, k, v = ctx.saved_tensors
    o, lse = attention_reference(q, k, v, return_lse=True)
    return (*attention_backward_reference(q, k, v, o, lse, do), None)


_small_n_op.register_autograd(_small_n_backward, setup_context=_small_n_setup)


def small_n_attention(q, k, v, plain: bool = False) -> torch.Tensor:
    """Non-causal attention for short rows, (B, H, N, D) with N <= 32, through
    the custom op ``dfot::small_n_attention``: the whole row at once, no
    online softmax. On a CUDA device this launches kernel B10 (bf16 or fp32,
    D a multiple of 64 up to 256; anything else raises); on the CPU, or on
    any device with ``plain``, it runs the plain version. Differentiable."""
    return _small_n_op(q, k, v, plain)


small_n_attention.launches = 0


# the sequence-parallel context: a ring (ops/ring_attention.py: a
# ProcessRing or a LocalRing) or None, read by attention_route at each call
_SEQUENCE_PARALLEL = None
RING_MIN_ROWS = 128  # the ring takes a shape only where each rank keeps this many query rows


def set_sequence_parallel(ring):
    """Route the big non-causal attentions of later calls through ring
    attention over ``ring`` (None: no ring). Returns the ring it replaces,
    for the caller to put back."""
    global _SEQUENCE_PARALLEL
    prior, _SEQUENCE_PARALLEL = _SEQUENCE_PARALLEL, ring
    return prior


def attention_route(n: int, d: int, causal: bool = False) -> str:
    """Which path :func:`attention` takes for N tokens of head dim d, the one
    place the rule is written:

    - ``"ring"``: a ring is set (:func:`set_sequence_parallel`) of R > 1
      ranks, the call is non-causal, R divides N and each rank keeps at
      least :data:`RING_MIN_ROWS` query rows (the JAX package's gate):
      ring attention, kernel B1 a block (B4, B5 back);
    - ``"small_n"``: non-causal, N <= 32, d a multiple of 64 up to 256 (the
      JAX package's gate, ``d % 64 == 0``): kernel B10;
    - ``"flash"``: d in {64, 128, 256} and N a multiple of 64: kernels B1,
      B4, B5;
    - ``"padded_flash"``: any other d up to 256 (:func:`padded_head_dim`) and
      N a multiple of 64: the same kernels on heads zero-padded to the next
      of those widths, with the true 1/sqrt(d) scale, sliced after;
    - ``"plain"``: what is left and the JAX package too computes outside any
      kernel (ragged N above 32, short causal rows): the plain version, on the
      card as well;
    - ``"unported"``: a shape the JAX package gives to a Pallas kernel and no
      kernel of the port takes (padded head dim above 256); it raises.

    The packed route of the models (``qkv_prep.attention_from_packed_qkv``)
    is taken only where this answers ``"flash"`` or ``"padded_flash"``: where
    the ring owns the shape they take q/k norm and RoPE in torch and then
    :func:`attention`, as ``fused_qkv_eligible`` sends the JAX models.
    """
    ring = _SEQUENCE_PARALLEL
    if (ring is not None and not causal and ring.size > 1 and n % ring.size == 0
            and n // ring.size >= RING_MIN_ROWS):
        return "ring"
    if not causal and n <= SMALL_N_MAX and d % 64 == 0:
        return "small_n" if d <= SMALL_N_MAX_D else "unported"
    if n % 64 == 0 and d <= FLASH_WIDTHS[-1]:
        return "flash" if d in FLASH_WIDTHS else "padded_flash"
    if n % 128 == 0 and n >= 512:
        return "unported"
    return "plain"


def _padded_flash(q, k, v, causal, plain):
    """Flash attention for a head dim the kernels are not compiled for (K600
    @DiT/XL: 1152 / 16 = 72): zero-pad to :func:`padded_head_dim`, run the
    kernels with the true 1/sqrt(d) scale, slice back. Zero lanes are inert
    in every product, forward and backward."""
    d = q.shape[-1]
    qp, kp, vp = (torch.nn.functional.pad(t, (0, padded_head_dim(d) - d)) for t in (q, k, v))
    return flash_attention(qp, kp, vp, causal, 1.0 / math.sqrt(d), plain=plain,
                           head_dim=d)[..., :d]


def attention(q, k, v, causal: bool = False, plain: bool = False) -> torch.Tensor:
    """Attention dispatcher, (B, H, N, D) layout, by :func:`attention_route`.
    Each route launches its kernels for a CUDA tensor or raises, and runs
    their plain versions for a CPU tensor (or on any device with ``plain``)."""
    route = attention_route(q.shape[-2], q.shape[-1], causal)
    if route == "ring":
        from .ring_attention import sequence_parallel_attention

        return sequence_parallel_attention(q, k, v, _SEQUENCE_PARALLEL, plain=plain)
    if route == "small_n":
        return small_n_attention(q, k, v, plain)
    if route == "flash":
        return flash_attention(q, k, v, causal, plain=plain)
    if route == "padded_flash":
        return _padded_flash(q, k, v, causal, plain)
    if route == "plain":
        return attention_reference(q, k, v, causal)
    raise NotImplementedError(
        f"attention of shape {tuple(q.shape)} (causal={causal}): no kernel of the port takes it "
        "(ROADMAP.md queue B)"
    )
