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
  true head dim (``head_dim``) lets them compute only its lanes. Every
  multiple of 64 above 256 goes to their wide family (``csrc/flash_wide.cu``:
  :func:`flash_fwd_wide`, :func:`flash_bwd_dq_wide`,
  :func:`flash_bwd_dkv_wide`), which slices the output lanes over the grid.
- A CUDA tensor goes to the kernels or the call raises; a CPU tensor takes
  the plain versions: :func:`attention_reference` (the counterpart of
  ``_xla_attention``: fp32 scores, fp32 softmax, one cast at the end) and
  :func:`attention_backward_reference` (the explicit backward formulas in
  fp32, not autograd of the forward).
- :func:`small_n_attention` is whole-row attention for N <= 32: its forward
  is kernel B10 (``csrc/small_n_attn.cu``, the port of ``_small_n_kernel``;
  above 256 lanes its wide entry, :func:`small_n_attention_wide`),
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
    "flash_fwd_wide", "flash_bwd_dq_wide", "flash_bwd_dkv_wide", "is_flash_width",
    "small_n_attention", "small_n_attention_wide", "small_n_attention_reference",
    "small_n_plan", "attention_route",
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
    device, D in :data:`FLASH_WIDTHS` or a multiple of 64 above them
    (:func:`is_flash_width`), N a multiple of 64."""
    B, H, N, D = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, *others)):
        raise TypeError(f"{what} takes bf16, got {[t.dtype for t in (q, *others)]}")
    if any(t.shape != q.shape for t in others):
        raise ValueError(f"{what}: shapes differ: {[tuple(t.shape) for t in (q, *others)]}")
    if not is_flash_width(D) or N % 64 or B * H > 65535:
        raise ValueError(f"{what} takes d in {FLASH_WIDTHS} or a multiple of 64 above, and "
                         f"N % 64 == 0, got {tuple(q.shape)}")
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
# The wide family (csrc/flash_wide.cu) at every multiple of 64 above 256: a
# block owns 64 rows (B1, B4: queries; B5: keys) and one output slice of at
# most 512 lanes (grid z; B4 and B5 256 lanes where those fill the card
# better, :func:`wide_slice_atoms`), each of its two consumers owning the
# output for its share of the slice's atoms. The scores of a 64-row tile of
# the streamed side are m64 n64 tiles contracted over the head's 64-lane
# atoms, once a block: one score product (B1's S, a dV block's) split by
# atoms between the consumers, two (S and dP: B4, a dK block) one each; the
# two tiles exchanged through shared memory. The block's own rows loaded once
# where they fit; the streamed tiles through stages of up to 8 atoms
FLASH_WIDE_ROWS = 64
FLASH_WIDE_SLICE = 512
FLASH_WIDE_SMALL_SLICE = 256
FLASH_WIDE_STAGE_ATOMS = 8
FLASH_WIDE_MAX_STAGES = 8
FLASH_WIDE_ATOM_BYTES = 64 * 128     # one 64-lane atom of 64 rows
FLASH_WIDE_EXCHANGE_BYTES = 2 * 64 * 64 * 4   # both consumers' 64 x 64 fp32 score tiles


def is_flash_width(d: int) -> bool:
    """A padded head dim some flash kernel takes: :data:`FLASH_WIDTHS`, or
    any multiple of 64 above them (the wide family)."""
    return d in FLASH_WIDTHS or (d > FLASH_WIDTHS[-1] and d % 64 == 0)


def padded_head_dim(d: int) -> int:
    """The head dim the kernels take for heads of ``d`` lanes: the smallest
    of :data:`FLASH_WIDTHS` that holds d (the JAX package pads to the next
    multiple of 64 instead: 192 where the port pads to 256; zero lanes are
    inert either way). Past the widest, the next multiple of 64, the JAX
    package's own padding, which the wide family takes."""
    return next((w for w in FLASH_WIDTHS if w >= d), d + (-d % 64))


# the ring hops' entries (csrc/flash_fwd.cu dfot_ring_fwd, csrc/flash_bwd.cu
# dfot_ring_bwd_dq, dfot_ring_bwd_dkv) are B1, B4 and B5 with another head
# index and epilogue: each takes the tile plan of the kernel it extends
RING_PLAN_OF = {"ring_fwd": "fwd", "ring_dq": "dq", "ring_dkv": "dkv"}


def flash_plan(kernel: str, bh: int, n: int, d: int, head_dim: Optional[int] = None) -> dict:
    """Tile plan of kernel B1 (``kernel="fwd"``), B4 (``"dq"``) or B5
    (``"dkv"``), or of a ring hop's entry (``"ring_fwd"``, ``"ring_dq"``,
    ``"ring_dkv"``: B1's, B4's, B5's plan, :data:`RING_PLAN_OF`) for ``bh``
    heads of ``n`` tokens, padded head dim ``d`` and true head dim
    ``head_dim`` (default ``d``).

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
    includes 1 KB of alignment slack and the mbarriers. Past 256 lanes the
    plan is the wide family's (:func:`_wide_plan`).
    """
    head_dim = d if head_dim is None else head_dim
    if not is_flash_width(d) or not 0 < head_dim <= d:
        raise ValueError(f"no flash kernel for head dim {head_dim} padded to {d}")
    rounded = -(-head_dim // 16) * 16
    kernel = RING_PLAN_OF.get(kernel, kernel)
    if kernel not in ("fwd", "dq", "dkv"):
        raise ValueError(f"unknown flash kernel {kernel!r}")
    if d > FLASH_WIDTHS[-1]:
        return _wide_plan(kernel, bh, n, rounded)
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
    barrier = 8
    stages = min(FLASH_MAX_STAGES,
                 (SMEM_PER_BLOCK - 1024 - resident - barrier) // (stage + 2 * barrier))
    return {
        "tile_rows": tile_rows, "block_rows": block_rows, "stages": stages,
        "smem_bytes": 1024 + resident + stages * stage + barrier * (1 + 2 * stages),
        "lanes": lanes, "k_steps": lanes // 16, "grid": (-(-n // block_rows), bh),
    }


def wide_split(sa: int, atoms: int) -> tuple:
    """How a wide block's two consumers share a slice of ``sa`` output
    atoms and the head's ``atoms`` score atoms of one score product
    (``csrc/flash_wide.cu:split``): consumer 0 owns output atoms [0, a0) of
    the slice and score atoms [0, t0), consumer 1 the rest; a0 = ceil(sa /
    2), t0 the split that gives both as even a count of atoms as it can (each
    is 4 k16 steps of n64 products in either product). With two score
    products (B4, B5's dK blocks) the output atoms are shared alike and
    consumer w contracts product w (S, dP) over every atom."""
    a0 = -(-sa // 2)
    return a0, min(atoms, max(0, atoms + sa - 2 * a0) // 2)


def wide_slice_atoms(kernel: str, bh: int, n: int, atoms: int) -> int:
    """The output atoms of a wide block's slice: 8 (:data:`FLASH_WIDE_SLICE`),
    but for B4 and B5 4 (:data:`FLASH_WIDE_SMALL_SLICE`) where the grid of
    256-lane slices fits one wave of :data:`SM_COUNT` blocks and has more
    blocks than the 512-lane one: every block then runs at once either way,
    and a 256-lane block computes the same scores and half the output
    product (``csrc/flash_wide.cu:slice_atoms_of``)."""
    big, small = FLASH_WIDE_SLICE // 64, FLASH_WIDE_SMALL_SLICE // 64
    if kernel == "fwd" or atoms <= small:
        return big
    blocks = -(-n // FLASH_WIDE_ROWS) * bh * -(-atoms // small) * (2 if kernel == "dkv" else 1)
    return small if blocks <= SM_COUNT else big


def _wide_plan(kernel: str, bh: int, n: int, lanes: int) -> dict:
    """The wide family's plan, B1's (``kernel`` "fwd"), B4's ("dq") or B5's
    ("dkv") (``csrc/flash_wide.cu:make_plan`` computes it again).
    ``atoms``: the 64-lane atoms of the ``lanes`` computed, over which the
    scores contract whole (the pad lanes of the last are zeros);
    ``slice_atoms`` (:func:`wide_slice_atoms`): the output atoms of a slice;
    ``slices``: the grid's z (twice over for B5: dK, then dV), each shared by
    the two consumers as ``splits`` says (:func:`wide_split`, per slice).
    The block's own rows of the score products' A operands (B1: Q; B4: Q
    and dO; B5: K and V) are ``resident`` (loaded once) where they fit
    beside the exchange of score tiles and two one-atom stages; a stage holds
    ``stage_atoms`` atoms of each score product's streamed operand (with the
    own rows' alongside where they stream), as many as let two stages fit, at
    most :data:`FLASH_WIDE_STAGE_ATOMS` and ``atoms``, and there are as many
    stages as fit; an output stage holds ``out_atoms`` atoms of the output
    product's operand, as many as its bytes take, at most a slice's."""
    atom = FLASH_WIDE_ATOM_BYTES
    atoms = -(-lanes // 64)
    sides = 1 if kernel == "fwd" else 2
    barrier = 8
    room = (SMEM_PER_BLOCK - 1024 - FLASH_WIDE_EXCHANGE_BYTES
            - barrier * (1 + 2 * FLASH_WIDE_MAX_STAGES))
    resident = room - sides * atoms * atom >= 2 * sides * atom
    resident_bytes = sides * atoms * atom if resident else 0
    unit = sides * atom * (1 if resident else 2)
    stage_atoms = min(FLASH_WIDE_STAGE_ATOMS, atoms, (room - resident_bytes) // (2 * unit))
    stage = stage_atoms * unit
    stages = min(FLASH_WIDE_MAX_STAGES, (room - resident_bytes) // stage)
    per = wide_slice_atoms(kernel, bh, n, atoms)
    slices = -(-atoms // per)
    return {
        "tile_rows": FLASH_WIDE_ROWS, "block_rows": FLASH_WIDE_ROWS, "stages": stages,
        "smem_bytes": 1024 + resident_bytes + FLASH_WIDE_EXCHANGE_BYTES + stages * stage
        + barrier * (1 + 2 * stages),
        "lanes": lanes, "k_steps": lanes // 16, "atoms": atoms,
        "slice_atoms": per, "slices": slices, "resident": resident,
        "resident_bytes": resident_bytes, "stage_atoms": stage_atoms, "stage_bytes": stage,
        "out_atoms": min(per, stage // atom),
        "splits": tuple(wide_split(min(per, atoms - per * z), atoms) for z in range(slices)),
        "grid": (-(-n // FLASH_WIDE_ROWS), bh, slices * (2 if kernel == "dkv" else 1)),
    }


def _flash_cuda(q, k, v, causal, sm_scale, return_lse, head_dim):
    B, H, N, D = q.shape
    _check_qkv("flash attention forward", q, k, v)
    if D > FLASH_WIDTHS[-1]:
        out, lse = flash_fwd_wide(q, k, v, causal, sm_scale, head_dim=head_dim)
        return (out, lse) if return_lse else out
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


def _check_wide(what, q, *others):
    """The wide family's contract: :func:`_check_qkv` with D above 256."""
    _check_qkv(what, q, *others)
    if q.shape[-1] <= FLASH_WIDTHS[-1]:
        raise ValueError(f"{what} takes head dims above {FLASH_WIDTHS[-1]}, got {tuple(q.shape)}")


def flash_fwd_wide(q, k, v, causal: bool = False, sm_scale: Optional[float] = None, *,
                   head_dim: Optional[int] = None):
    """(O, LSE) of attention at a padded head dim D above 256 (a multiple of
    64), (B, H, N, D) layout, LSE (B, H, N, 1) fp32. On a CUDA device this
    launches the wide B1 (``csrc/flash_wide.cu``; bf16, N a multiple of 64,
    anything else raises); on the CPU it runs the plain version.
    :func:`flash_attention` comes here for such heads. ``head_dim``: the true
    head dim, whose lanes alone are computed (the rest written as zeros)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal, sm_scale, True)
    if not q.is_cuda:
        raise ValueError(f"no flash-attention path for device {q.device}")
    what = "flash attention forward (wide)"
    _check_wide(what, q, k, v)
    B, H, N, D = q.shape
    plan = flash_plan("fwd", B * H, N, D, head_dim)
    q, k, v = (t.contiguous() for t in (q, k, v))
    _cuda.check_aligned(what, 16, q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, N, 1), dtype=torch.float32, device=q.device)
    _cuda.check(
        _cuda.library().dfot_flash_fwd_wide(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            B * H, N, D, plan["lanes"], plan["stages"], plan["smem_bytes"],
            int(plan["resident"]), float(sm_scale), int(causal), _cuda.stream_handle(q.device),
        ),
        what,
    )
    flash_fwd_wide.launches += 1
    return out, lse


def flash_bwd_dq_wide(q, k, v, do, lse, delta, causal: bool = False,
                      sm_scale: Optional[float] = None, *, head_dim: Optional[int] = None):
    """dq at a padded head dim above 256, arguments as :func:`flash_bwd_dq`:
    the wide B4 (``csrc/flash_wide.cu``) on a CUDA device, the plain version
    on the CPU. :func:`flash_bwd_dq` comes here for such heads."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    if not q.is_cuda:
        raise ValueError(f"no flash-attention path for device {q.device}")
    what = "flash attention backward (dq, wide)"
    _check_wide(what, q, k, v, do)
    q, k, v, do, lse, delta = _bwd_operands(what, q, k, v, do, lse, delta)
    B, H, N, D = q.shape
    plan = flash_plan("dq", B * H, N, D, head_dim)
    dq = torch.empty_like(q)
    _cuda.check(
        _cuda.library().dfot_flash_bwd_dq_wide(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), B * H, N, D, plan["lanes"], plan["stages"],
            plan["smem_bytes"], int(plan["resident"]), float(sm_scale), int(causal),
            _cuda.stream_handle(q.device),
        ),
        what,
    )
    flash_bwd_dq_wide.launches += 1
    return dq


def flash_bwd_dkv_wide(q, k, v, do, lse, delta, causal: bool = False,
                       sm_scale: Optional[float] = None, *, head_dim: Optional[int] = None):
    """(dk, dv) at a padded head dim above 256, arguments as
    :func:`flash_bwd_dkv`: the wide B5 (``csrc/flash_wide.cu``) on a CUDA
    device, the plain version on the CPU. :func:`flash_bwd_dkv` comes here
    for such heads."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _dkv_plain(q, k, v, do, lse, delta, causal, sm_scale)
    if not q.is_cuda:
        raise ValueError(f"no flash-attention path for device {q.device}")
    what = "flash attention backward (dk, dv, wide)"
    _check_wide(what, q, k, v, do)
    q, k, v, do, lse, delta = _bwd_operands(what, q, k, v, do, lse, delta)
    B, H, N, D = q.shape
    plan = flash_plan("dkv", B * H, N, D, head_dim)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _cuda.check(
        _cuda.library().dfot_flash_bwd_dkv_wide(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B * H, N, D, plan["lanes"],
            plan["stages"], plan["smem_bytes"], int(plan["resident"]), float(sm_scale),
            int(causal), _cuda.stream_handle(q.device),
        ),
        what,
    )
    flash_bwd_dkv_wide.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = False,
                 sm_scale: Optional[float] = None, *,
                 head_dim: Optional[int] = None) -> torch.Tensor:
    """dq of attention from the saved LSE and delta = rowsum(dO * O), both
    (B, H, N, 1) fp32. On a CUDA device this launches kernel B4 (bf16, D in
    {64, 128, 256}, or its wide family, :func:`flash_bwd_dq_wide`, at a
    multiple of 64 above; N a multiple of 64; anything else raises); on the
    CPU it runs the plain version. ``head_dim``: the true head dim where q, k, v, do are
    heads zero-padded to D (the kernel then computes only its lanes and
    writes the pad lanes of dq as zeros)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return _dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    if not q.is_cuda:
        raise ValueError(f"no flash-attention path for device {q.device}")
    if q.shape[-1] > FLASH_WIDTHS[-1]:
        return flash_bwd_dq_wide(q, k, v, do, lse, delta, causal, sm_scale, head_dim=head_dim)
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
    if q.shape[-1] > FLASH_WIDTHS[-1]:
        return flash_bwd_dkv_wide(q, k, v, do, lse, delta, causal, sm_scale, head_dim=head_dim)
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
    hand-written kernels, forward and backward (bf16, D in {64, 128, 256} or
    a multiple of 64 above, the wide family; N a multiple of 64; anything
    else raises); on the CPU, or on any device with
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
flash_fwd_wide.launches = 0
flash_bwd_dq_wide.launches = 0
flash_bwd_dkv_wide.launches = 0


SMALL_N_MAX = 32
# kernel B10 takes head dims up to this one on its narrow entry; above it, on
# its wide entry, which spreads an item's head over a block's warps
SMALL_N_WHOLE_D = 256
SMALL_N_CHUNK = 64


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
SMALL_N_WIDE_WARPS = 8      # the wide entry's whole items in bf16: warps of a block, at most


def _ring_plan(items, n, item_bytes, fp32, wide, wave):
    """B10's ring plan: items a stage from the most down (with ``wave``, no
    more than leave a group for every SM where the items allow), the first
    that leaves two stages at 4, 2 or 1 blocks an SM."""
    units = 1 if n <= 16 else 2
    tasks = n * -(-n // 4)
    most = (min(SMALL_N_MAX_ITEMS_FP32, -(-256 // tasks)) if fp32
            else SMALL_N_MAX_WARPS // units)
    while wave and most > 1 and -(-items // most) < min(items, SM_COUNT):
        most -= 1
    for ipb in range(most, 0, -1):
        warps = SMALL_N_WARPS_FP32 if fp32 else ipb * units
        stage = ipb * item_bytes
        fixed = -(-ipb * n * (n + 1) * 4 // 16) * 16 if fp32 else 0
        for per_sm in (4, 2, 1):
            budget = min(SMEM_PER_BLOCK, (SMEM_PER_SM - per_sm * SMEM_BLOCK_RESERVE) // per_sm)
            stages = min(SMALL_N_MAX_STAGES, (budget - fixed) // stage)
            if stages >= 2:
                return {"wide": wide, "whole": True, "units": 0 if fp32 else units,
                        "parts": 0 if fp32 else 1, "warps": warps, "items_per_stage": ipb,
                        "stages": stages, "stage_bytes": stage,
                        "smem_bytes": fixed + stages * stage, "blocks_per_sm": per_sm,
                        "grid": min(-(-items // ipb), per_sm * SM_COUNT)}
    return None


@functools.lru_cache(maxsize=256)
def small_n_plan(items: int, n: int, d: int, dtype: torch.dtype) -> dict:
    """Plan of kernel B10 for ``items`` items of ``n`` tokens and head dim
    ``d`` in ``dtype`` (bf16 or fp32), as its C entry computes it again and
    checks it.

    Narrow entry (``d`` up to :data:`SMALL_N_WHOLE_D`): a stage holds the q,
    k, v rows of ``items_per_stage`` items, rows padded by 16 bytes (``3 n (d
    e + 16)`` bytes an item); bf16: an item takes ``units`` warps (16 query
    rows each: one for n <= 16, two above) and a block ``warps`` = units x
    items_per_stage, from 4 items (or 2) down; fp32: a block is 8 warps whose
    threads share the stage's items, from as many as give its score phase
    256 (row, 4-key) tasks (at most 16) down, and holds their n x (n + 1)
    fp32 scores beside the ring. The first count of items a stage that, at
    4, 2 or 1 blocks an SM, leaves two stages in the block's share of the
    SM's shared memory is taken, with as many stages as fit (at most 4);
    ``grid``: that many blocks an SM over :data:`SM_COUNT` SMs, or fewer
    where there are fewer groups.

    Wide entry (``wide``: ``d`` a multiple of 64 above 256). Where two stages
    of a whole item fit a block (``whole``): in bf16 one item a stage, each
    16-row unit's head dealt over ``parts`` warps (64-lane chunks c = part,
    part + parts, ...: as many warps as leave each the fewest chunks, at most
    :data:`SMALL_N_WIDE_WARPS` a block), the warps' partial scores (``units
    x parts`` warps x key tiles of 8 x 512 bytes) beside the ring, at the
    most blocks an SM (4, 2, 1) that leave two stages, and a block for every
    item up to that many an SM; in fp32 the narrow entry's plan, with no
    more items a stage than leave a group for every SM where the items
    allow. Otherwise a stage holds one 64-lane chunk of q and k or of v and
    a free half, ``2 n (64 e + 16)`` bytes an item whatever ``d``, on the
    narrow entry's rule with that same wave of groups.
    """
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"no small-N kernel for {dtype}")
    wide = d > SMALL_N_WHOLE_D
    if items <= 0 or not 1 <= n <= SMALL_N_MAX or d <= 0 or d % (SMALL_N_CHUNK if wide else 16):
        raise ValueError(f"no small-N plan for {items} items of ({n}, {d})")
    fp32 = dtype == torch.float32
    e = 4 if fp32 else 2
    whole = 3 * n * (d * e + SMALL_N_ROW_PAD)
    plan = None
    if not wide:
        plan = _ring_plan(items, n, whole, fp32, False, False)
    elif fp32:
        if -(-n * (n + 1) * 4 // 16) * 16 + 2 * whole <= SMEM_PER_BLOCK:
            plan = _ring_plan(items, n, whole, True, True, True)
    else:
        units = 1 if n <= 16 else 2
        most, chunks = SMALL_N_WIDE_WARPS // units, d // SMALL_N_CHUNK
        per = -(-chunks // most)
        parts = -(-chunks // per)
        warps = units * parts
        fixed = warps * (1 if n <= 8 else 2 if n <= 16 else 4) * 4 * 32 * 4
        for per_sm in (4, 2, 1):
            budget = min(SMEM_PER_BLOCK, (SMEM_PER_SM - per_sm * SMEM_BLOCK_RESERVE) // per_sm)
            stages = min(SMALL_N_MAX_STAGES, (budget - fixed) // whole)
            if stages >= 2:
                plan = {"wide": True, "whole": True, "units": units, "parts": parts,
                        "warps": warps, "items_per_stage": 1, "stages": stages,
                        "stage_bytes": whole, "smem_bytes": fixed + stages * whole,
                        "blocks_per_sm": per_sm, "grid": min(items, per_sm * SM_COUNT)}
                break
    if wide and plan is None:
        plan = _ring_plan(items, n, 2 * n * (SMALL_N_CHUNK * e + SMALL_N_ROW_PAD), fp32, True,
                          True)
        if plan is not None:
            plan["whole"] = False
    if plan is None:
        raise ValueError(f"no small-N plan fits ({n}, {d}) {dtype}")
    return plan


def _small_n_cuda(q, k, v):
    B, H, N, D = q.shape
    what = "small-N attention"
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} takes all bf16 or all fp32, got {[t.dtype for t in (q, k, v)]}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: shapes differ: {[tuple(t.shape) for t in (q, k, v)]}")
    if not 1 <= N <= SMALL_N_MAX or D % 64 or D <= 0:
        raise ValueError(f"{what} takes N <= {SMALL_N_MAX} and d in multiples of 64, "
                         f"got {tuple(q.shape)}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError(f"{what}: tensors on different devices")
    q, k, v = (t.contiguous() for t in (q, k, v))
    _cuda.check_aligned(what, 16, q, k, v)
    plan = small_n_plan(B * H, N, D, q.dtype)
    lib = _cuda.library()
    entry, wrapper = ((lib.dfot_small_n_attn_wide, small_n_attention_wide) if plan["wide"]
                      else (lib.dfot_small_n_attn, small_n_attention))
    out = torch.empty_like(q)
    _cuda.check(
        entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N, D,
            1.0 / math.sqrt(D), int(q.dtype == torch.float32), plan["warps"],
            plan["items_per_stage"], plan["stages"], plan["smem_bytes"], plan["grid"],
            _cuda.stream_handle(q.device),
        ),
        what + (" (wide)" if plan["wide"] else ""),
    )
    wrapper.launches += 1
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
    D a multiple of 64; above 256 its wide entry, counted under
    :func:`small_n_attention_wide`; anything else raises); on the CPU, or on
    any device with ``plain``, it runs the plain version. Differentiable."""
    return _small_n_op(q, k, v, plain)


def small_n_attention_wide(q, k, v) -> torch.Tensor:
    """B10's wide entry (``dfot_small_n_attn_wide``: head dims above 256, a
    multiple of 64, the head spread over a block's warps, or streamed in
    64-lane chunks where whole items do not fit), forward only, (B, H, N, D)
    with N <= 32: the kernel on a CUDA device, the plain version on the CPU.
    :func:`small_n_attention` comes here for such heads."""
    if q.device.type == "cpu":
        return _small_n_plain(q, k, v)
    if q.shape[-1] <= SMALL_N_WHOLE_D:
        raise ValueError(f"B10's wide entry takes head dims above {SMALL_N_WHOLE_D}, "
                         f"got {tuple(q.shape)}")
    return _small_n_cuda(q, k, v)


small_n_attention.launches = 0
small_n_attention_wide.launches = 0


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
      ring attention, one ring-hop kernel a hop (the ring entries of B1,
      and of B4 and B5 back);
    - ``"small_n"``: non-causal, N <= 32, d a multiple of 64 (the JAX
      package's gate, ``d % 64 == 0``, with no upper limit): kernel B10,
      above 256 lanes its wide entry;
    - ``"flash"``: d in {64, 128, 256} or a multiple of 64 above (the wide
      family) and N a multiple of 64: kernels B1, B4, B5;
    - ``"padded_flash"``: any other d (:func:`padded_head_dim`) and N a
      multiple of 64: the same kernels on heads zero-padded to the next of
      those widths, with the true 1/sqrt(d) scale, sliced after;
    - ``"plain"``: what is left and the JAX package too computes outside any
      kernel (ragged N above 32, short causal rows): the plain version, on the
      card as well.

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
        return "small_n"
    if n % 64 == 0:
        return "flash" if is_flash_width(d) else "padded_flash"
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
    return attention_reference(q, k, v, causal)  # "plain"
