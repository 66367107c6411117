"""Ring (sequence-parallel) attention over R ranks.

Port of ``dfot_tpu/ops/ring_attention.py``. The token axis of q, k, v is
split over R ranks; each rank keeps its query rows and meets the R K/V
shards in ring order (its own, then rank r - 1's, ...), folding each block
into an online softmax in (O, LSE) space. No rank ever holds the whole
sequence's scores.

- A hop is one kernel launch on a CUDA tensor. Forward, :func:`ring_fwd_hop`:
  the ring entry of B1 (``csrc/flash_fwd.cu``, ``dfot_ring_fwd``), which
  computes the block (the port of ``_block_flash``, :49) and folds it into
  the running fp32 (O, LSE) in its epilogue (the fold of :99-111); the last
  hop writes O in the input dtype and the final LSE. Backward,
  :func:`ring_dq_hop` and :func:`ring_dkv_hop`: the ring entries of B4 and
  B5 (``csrc/flash_bwd.cu``), each adding its hop into fp32 sums in the
  kernel and writing them in the input dtype at the last hop. Heads above
  256 lanes take the wide family's ring entries (``csrc/flash_wide.cu``:
  :func:`ring_fwd_hop_wide`, :func:`ring_dq_hop_wide`,
  :func:`ring_dkv_hop_wide`), whose forward reads the running LSE from one
  buffer and writes the new one to another: the slice blocks of a row all
  read the old one.
- The backward is a ``torch.autograd.Function``, not autodiff of the fold
  (the block's LSE would carry no gradient): the forward saves q, k, v, the
  final O and the final LSE; the backward walks the ring again with
  delta = rowsum(dO * O) and the final LSE.
- A ring is one of two forms. :class:`LocalRing`: R virtual ranks in one
  process, their shards stacked on the leading axis (a merged batch of
  R x B, so R B H heads); no shard moves: at hop s query head h meets K/V
  head (h - s B H) mod R B H (``kv_shift``), which the kernels index, so a
  hop is one launch for all R ranks and copies nothing. :class:`ProcessRing`:
  the R processes of a ``torch.distributed`` group; its shards travel, one
  ``batch_isend_irecv`` to ``(rank + 1) % R`` a hop (the JAX ``ppermute``'s
  permutation, :97), hop s + 1's transfer posted before hop s's kernel and
  waited for after it (double-buffered K/V, as the JAX ring overlaps the
  transfer with the block, :3-8); backward, the dk, dv sums travel with their
  shard and come home with one more hop.
- On the CPU, or with ``plain``, each hop runs its plain version
  (:func:`ring_fwd_hop_plain`, :func:`ring_bwd_hop_plain`): the plain block
  of the shifted shard, with O rounded to the input dtype as
  ``_block_flash`` rounds it (:57), folded in fp32 ``logaddexp``; the plain
  backward formulas, each hop's gradients in the input dtype added into
  fp32 sums. That is the roll-based ring of before to the bit.

:func:`sequence_parallel_attention` takes the global (B, H, N, D) arrays,
keeps each rank's N / R rows, runs the ring and gathers O; the gradient of
each replicated input is the gather of the ranks' row gradients (a rank's
upstream gradient is the same on every rank, and is not summed R times).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _cuda
from .attention import (
    FLASH_WIDTHS,
    _bwd_operands,
    _check_wide,
    _check_qkv,
    _delta,
    _dkv_plain,
    _dq_plain,
    attention_reference,
    flash_plan,
    padded_head_dim,
)

__all__ = [
    "LocalRing", "ProcessRing", "ring_attention", "sequence_parallel_attention",
    "ring_fwd_hop", "ring_dq_hop", "ring_dkv_hop", "ring_fwd_hop_plain", "ring_bwd_hop_plain",
    "ring_fwd_hop_wide", "ring_dq_hop_wide", "ring_dkv_hop_wide",
]


class LocalRing:
    """R virtual ranks in this process. A rank's shard of a (B, H, N, D)
    tensor is its N / R rows; the R shards are stacked on the leading axis as
    one (R B, H, N / R, D) tensor, rank r at rows r B to (r + 1) B. The ring
    moves no shard: a hop's kernels read the visiting one by ``kv_shift``."""

    moves_shards = False

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a ring needs at least one rank, got {size}")
        self.size = size

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        B, H, N, D = x.shape
        n = N // self.size
        return x.reshape(B, H, self.size, n, D).permute(2, 0, 1, 3, 4).reshape(
            self.size * B, H, n, D)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        RB, H, n, D = x.shape
        B = RB // self.size
        return x.reshape(self.size, B, H, n, D).permute(1, 2, 0, 3, 4).reshape(
            B, H, self.size * n, D)

    def kv_shift(self, hop: int, x: torch.Tensor) -> int:
        """Heads of the stacked (R B, H, ...) ``x`` between a query head and
        the K/V head it meets at ``hop``: that hop's shard is rank r - hop's."""
        return hop * (x.shape[0] // self.size) * x.shape[1]

    def hop(self, *tensors: torch.Tensor):
        """Each rank's tensors to the next rank: rank r receives rank r - 1's
        (a copy; the ring itself indexes instead)."""
        return tuple(
            t.reshape(self.size, -1, *t.shape[1:]).roll(1, 0).reshape(t.shape) for t in tensors)


class _Transfer:
    """A posted hop: :meth:`wait` returns the received tensors once they
    have arrived (under NCCL: once the current stream waits for them)."""

    def __init__(self, requests, received):
        self.requests, self.received = requests, received

    def wait(self):
        for req in self.requests:
            req.wait()
        return self.received


class ProcessRing:
    """The processes of a ``torch.distributed`` group (None: the world); a
    rank's shard is the slice of rows at its rank in the group. Its shards
    travel from rank to rank."""

    moves_shards = True

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self._next = dist.get_global_rank(self.group, (self.rank + 1) % self.size)
        self._prev = dist.get_global_rank(self.group, (self.rank - 1) % self.size)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return _TakeRows.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherRows.apply(x, self)

    def kv_shift(self, hop: int, x: torch.Tensor) -> int:
        return 0  # the visiting shard is the one this process holds

    def start_hop(self, tensors, into=None) -> _Transfer:
        """Post each tensor's send to rank + 1 and the receive of the
        previous rank's into ``into`` (new tensors if None)."""
        import torch.distributed as dist

        if self.size == 1:
            return _Transfer((), tuple(tensors))
        received = tuple(into) if into is not None else tuple(torch.empty_like(t) for t in tensors)
        ops = []
        for t, r in zip(tensors, received):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self._next, self.group))
            ops.append(dist.P2POp(dist.irecv, r, self._prev, self.group))
        return _Transfer(dist.batch_isend_irecv(ops), received)

    def hop(self, *tensors: torch.Tensor):
        """Each tensor to rank + 1, the previous rank's in its place."""
        return self.start_hop(tensors).wait()

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=-2)

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-2] // self.size
        return x.narrow(-2, self.rank * n, n).contiguous()


class _TakeRows(torch.autograd.Function):
    """A replicated (B, H, N, D) tensor -> this rank's rows; back, the
    gradient of the replicated tensor is every rank's row gradient."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.own_rows(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.all_gather_rows(g), None


class _GatherRows(torch.autograd.Function):
    """This rank's rows -> the replicated whole; back, this rank's rows of
    the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        return ring.all_gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.own_rows(g), None


# ---------------------------------------------------------------------------
# plain versions of the hops
# ---------------------------------------------------------------------------


def _shift(t: torch.Tensor, kv_shift: int) -> torch.Tensor:
    """``t`` (R B, H, ...) with head i of its flattened R B H heads taking
    head (i - kv_shift) mod R B H: the shard a hop visits (a copy)."""
    if not kv_shift:
        return t
    return t.flatten(0, 1).roll(kv_shift, 0).reshape(t.shape)


def block_attention(q, k, v, sm_scale: float):
    """The plain block: (O, LSE (..., N, 1)) in fp32, the LSE in natural-log
    units of the scaled scores, O rounded to q's dtype first, as
    ``_block_flash`` rounds it."""
    o, lse = attention_reference(q, k, v, False, sm_scale, True)
    return o.float(), lse


def fold_block(o, lse, b_o, b_lse):
    """Fold a block's (O, LSE) into the running (O, LSE), fp32."""
    new_lse = torch.logaddexp(lse, b_lse)
    return o * torch.exp(lse - new_lse) + b_o * torch.exp(b_lse - new_lse), new_lse


def ring_fwd_hop_plain(q, k, v, o, lse, kv_shift: int, last: bool, sm_scale: float):
    """Plain version of :func:`ring_fwd_hop`: the plain block of q against
    the shard ``kv_shift`` heads back, folded into the running (O, LSE)
    (None at the first hop); the new state, or at the last hop O in q's
    dtype and the final LSE."""
    b_o, b_lse = block_attention(q, _shift(k, kv_shift), _shift(v, kv_shift), sm_scale)
    o, lse = (b_o, b_lse) if o is None else fold_block(o, lse, b_o, b_lse)
    return (o.to(q.dtype), lse) if last else (o, lse)


def _add(total, part, kv_shift: int):
    """fp32 ``total`` (None: none yet) plus ``part`` moved ``kv_shift`` heads
    back to its home shard."""
    part = _shift(part, -kv_shift)
    return part.float() if total is None else total.add_(part)


def _ring_dq_plain(q, k, v, do, lse, delta, dq, kv_shift, last, sm_scale):
    b = _dq_plain(q, _shift(k, kv_shift), _shift(v, kv_shift), do, lse, delta, False, sm_scale)
    dq = _add(dq, b, 0)
    return dq.to(q.dtype) if last else dq


def _ring_dkv_plain(q, k, v, do, lse, delta, dk, dv, kv_shift, last, sm_scale):
    b_dk, b_dv = _dkv_plain(q, _shift(k, kv_shift), _shift(v, kv_shift), do, lse, delta, False,
                            sm_scale)
    dk, dv = _add(dk, b_dk, kv_shift), _add(dv, b_dv, kv_shift)
    return (dk.to(k.dtype), dv.to(v.dtype)) if last else (dk, dv)


def ring_bwd_hop_plain(q, k, v, do, lse, delta, dq, dk, dv, kv_shift: int, last: bool,
                       sm_scale: float):
    """Plain version of :func:`ring_dq_hop` and :func:`ring_dkv_hop`: the
    plain dq and dk, dv of q against the shard ``kv_shift`` heads back, each
    in its input's dtype, added into the fp32 sums ``dq``, ``dk``, ``dv``
    (None at the first hop; dk, dv at the shard's home heads); the new sums,
    or at the last hop the sums in the inputs' dtypes."""
    return (_ring_dq_plain(q, k, v, do, lse, delta, dq, kv_shift, last, sm_scale),
            *_ring_dkv_plain(q, k, v, do, lse, delta, dk, dv, kv_shift, last, sm_scale))


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def _kernel_path(what: str, q: torch.Tensor, plain: bool) -> bool:
    """True where the hop launches its kernel: a CUDA tensor without
    ``plain``. A CPU tensor (or ``plain``) takes the plain version; another
    device raises."""
    if plain or q.device.type == "cpu":
        return False
    if not q.is_cuda:
        raise ValueError(f"{what}: no path for device {q.device}")
    return True


def _state(what: str, t, shape, device) -> Optional[torch.Tensor]:
    """A running fp32 state tensor as the kernels take it, or None."""
    if t is None:
        return None
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != device or (
            not t.is_contiguous()):
        raise ValueError(f"{what}: running state must be contiguous fp32 {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return t


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def ring_fwd_hop(q, k, v, o, lse, kv_shift: int, last: bool, sm_scale: float, *,
                 head_dim: Optional[int] = None, plain: bool = False):
    """One forward hop of the ring: the block of q (R B, H, n, D) against the
    K/V shard ``kv_shift`` heads back, folded into the running (O, LSE)
    (fp32 (..., n, D) and (..., n, 1); None at the first hop). Returns the
    new state, or at the ``last`` hop O in q's dtype and the final LSE. On a
    CUDA tensor one launch of the ring entry of B1 (bf16, D in {64, 128,
    256}, n a multiple of 64; else it raises), which updates the state in
    place, or above 256 lanes of :func:`ring_fwd_hop_wide`; on the CPU, or
    with ``plain``, :func:`ring_fwd_hop_plain`."""
    what = "ring attention hop"
    if not _kernel_path(what, q, plain):
        return ring_fwd_hop_plain(q, k, v, o, lse, kv_shift, last, sm_scale)
    if q.shape[-1] > FLASH_WIDTHS[-1]:
        return ring_fwd_hop_wide(q, k, v, o, lse, kv_shift, last, sm_scale, head_dim=head_dim)
    _check_qkv(what, q, k, v)
    B, H, N, D = q.shape
    q, k, v = (t.contiguous() for t in (q, k, v))
    _cuda.check_aligned(what, 16, q, k, v)
    if (o is None) != (lse is None):
        raise ValueError(f"{what}: O and LSE are running together or not at all")
    read_prev = lse is not None
    f32 = dict(dtype=torch.float32, device=q.device)
    lse = _state(what, lse, (B, H, N, 1), q.device)
    o = _state(what, o, (B, H, N, D), q.device)
    if lse is None:
        lse = torch.empty((B, H, N, 1), **f32)
    if o is None and not last:
        o = torch.empty((B, H, N, D), **f32)
    out = torch.empty_like(q) if last else None
    plan = flash_plan("ring_fwd", B * H, N, D, head_dim)
    _cuda.check(
        _cuda.library().dfot_ring_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(out), lse.data_ptr(), _ptr(o),
            B * H, N, D, plan["lanes"], plan["stages"], plan["smem_bytes"], float(sm_scale),
            int(kv_shift), int(read_prev), int(last), _cuda.stream_handle(q.device),
        ),
        what,
    )
    ring_fwd_hop.launches += 1
    return (out, lse) if last else (o, lse)


def ring_dq_hop(q, k, v, do, lse, delta, dq, kv_shift: int, last: bool, sm_scale: float, *,
                head_dim: Optional[int] = None, plain: bool = False):
    """One backward hop's dq: q's gradient from the K/V shard ``kv_shift``
    heads back, against the final LSE and delta = rowsum(dO * O) ((..., n,
    1) fp32), added into the fp32 sum ``dq`` (None at the first hop).
    Returns the new sum, or at the ``last`` hop dq in q's dtype. On a CUDA
    tensor one launch of the ring entry of B4, which adds in place (above 256
    lanes :func:`ring_dq_hop_wide`); on the CPU, or with ``plain``, the plain
    version (:func:`ring_bwd_hop_plain`)."""
    what = "ring attention hop backward (dq)"
    if not _kernel_path(what, q, plain):
        return _ring_dq_plain(q, k, v, do, lse, delta, dq, kv_shift, last, sm_scale)
    if q.shape[-1] > FLASH_WIDTHS[-1]:
        return ring_dq_hop_wide(q, k, v, do, lse, delta, dq, kv_shift, last, sm_scale,
                                head_dim=head_dim)
    q, k, v, do, lse, delta = _bwd_operands(what, q, k, v, do, lse, delta)
    B, H, N, D = q.shape
    dq = _state(what, dq, (B, H, N, D), q.device)
    read_prev = dq is not None
    if dq is None and not last:
        dq = torch.empty((B, H, N, D), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q) if last else None
    plan = flash_plan("ring_dq", B * H, N, D, head_dim)
    _cuda.check(
        _cuda.library().dfot_ring_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(out), _ptr(dq), B * H, N, D, plan["lanes"], plan["stages"],
            plan["smem_bytes"], float(sm_scale), int(kv_shift), int(read_prev), int(last),
            _cuda.stream_handle(q.device),
        ),
        what,
    )
    ring_dq_hop.launches += 1
    return out if last else dq


def ring_dkv_hop(q, k, v, do, lse, delta, dk, dv, kv_shift: int, last: bool, sm_scale: float,
                 *, head_dim: Optional[int] = None, plain: bool = False):
    """One backward hop's dk, dv: the gradients of the K/V shard ``kv_shift``
    heads back from q's rows, added into the fp32 sums ``dk``, ``dv`` at the
    shard's home heads (None at the first hop). Returns the new sums, or at
    the ``last`` hop dk, dv in k's and v's dtype. On a CUDA tensor one launch
    of the ring entry of B5, whose blocks own the keys of a K/V head and walk
    the query rows of the head ``kv_shift`` on, adding in place (above 256
    lanes :func:`ring_dkv_hop_wide`); on the CPU, or with ``plain``, the
    plain version (:func:`ring_bwd_hop_plain`)."""
    what = "ring attention hop backward (dk, dv)"
    if not _kernel_path(what, q, plain):
        return _ring_dkv_plain(q, k, v, do, lse, delta, dk, dv, kv_shift, last, sm_scale)
    if q.shape[-1] > FLASH_WIDTHS[-1]:
        return ring_dkv_hop_wide(q, k, v, do, lse, delta, dk, dv, kv_shift, last, sm_scale,
                                 head_dim=head_dim)
    q, k, v, do, lse, delta = _bwd_operands(what, q, k, v, do, lse, delta)
    B, H, N, D = q.shape
    dk = _state(what, dk, (B, H, N, D), q.device)
    dv = _state(what, dv, (B, H, N, D), q.device)
    if (dk is None) != (dv is None):
        raise ValueError(f"{what}: dk and dv are summed together or not at all")
    read_prev = dk is not None
    if dk is None and not last:
        dk, dv = (torch.empty((B, H, N, D), dtype=torch.float32, device=q.device)
                  for _ in range(2))
    out_k, out_v = (torch.empty_like(k), torch.empty_like(v)) if last else (None, None)
    plan = flash_plan("ring_dkv", B * H, N, D, head_dim)
    _cuda.check(
        _cuda.library().dfot_ring_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(out_k), _ptr(out_v), _ptr(dk), _ptr(dv), B * H, N, D,
            plan["lanes"], plan["stages"], plan["smem_bytes"], float(sm_scale), int(kv_shift),
            int(read_prev), int(last), _cuda.stream_handle(q.device),
        ),
        what,
    )
    ring_dkv_hop.launches += 1
    return (out_k, out_v) if last else (dk, dv)


def ring_fwd_hop_wide(q, k, v, o, lse, kv_shift: int, last: bool, sm_scale: float, *,
                      head_dim: Optional[int] = None, plain: bool = False):
    """:func:`ring_fwd_hop` at a padded head dim above 256: one launch of
    the wide family's ring entry of B1 (``csrc/flash_wide.cu``), which
    folds into the running fp32 O in place and writes the new running LSE to
    a new tensor (the one given is only read: each row's slice blocks all
    read it). On the CPU, or with ``plain``, :func:`ring_fwd_hop_plain`."""
    what = "ring attention hop (wide)"
    if not _kernel_path(what, q, plain):
        return ring_fwd_hop_plain(q, k, v, o, lse, kv_shift, last, sm_scale)
    _check_wide(what, q, k, v)
    B, H, N, D = q.shape
    q, k, v = (t.contiguous() for t in (q, k, v))
    _cuda.check_aligned(what, 16, q, k, v)
    if (o is None) != (lse is None):
        raise ValueError(f"{what}: O and LSE are running together or not at all")
    read_prev = lse is not None
    f32 = dict(dtype=torch.float32, device=q.device)
    lse = _state(what, lse, (B, H, N, 1), q.device)
    o = _state(what, o, (B, H, N, D), q.device)
    lse_new = torch.empty((B, H, N, 1), **f32)
    if o is None and not last:
        o = torch.empty((B, H, N, D), **f32)
    out = torch.empty_like(q) if last else None
    plan = flash_plan("ring_fwd", B * H, N, D, head_dim)
    _cuda.check(
        _cuda.library().dfot_ring_fwd_wide(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(out), _ptr(lse), lse_new.data_ptr(),
            _ptr(o), B * H, N, D, plan["lanes"], plan["stages"], plan["smem_bytes"],
            int(plan["resident"]), float(sm_scale), int(kv_shift), int(read_prev), int(last),
            _cuda.stream_handle(q.device),
        ),
        what,
    )
    ring_fwd_hop_wide.launches += 1
    return (out, lse_new) if last else (o, lse_new)


def ring_dq_hop_wide(q, k, v, do, lse, delta, dq, kv_shift: int, last: bool, sm_scale: float,
                     *, head_dim: Optional[int] = None, plain: bool = False):
    """:func:`ring_dq_hop` at a padded head dim above 256: one launch of the
    wide family's ring entry of B4 (``csrc/flash_wide.cu``), adding in
    place. On the CPU, or with ``plain``, the plain version."""
    what = "ring attention hop backward (dq, wide)"
    if not _kernel_path(what, q, plain):
        return _ring_dq_plain(q, k, v, do, lse, delta, dq, kv_shift, last, sm_scale)
    _check_wide(what, q, k, v, do)
    q, k, v, do, lse, delta = _bwd_operands(what, q, k, v, do, lse, delta)
    B, H, N, D = q.shape
    dq = _state(what, dq, (B, H, N, D), q.device)
    read_prev = dq is not None
    if dq is None and not last:
        dq = torch.empty((B, H, N, D), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q) if last else None
    plan = flash_plan("ring_dq", B * H, N, D, head_dim)
    _cuda.check(
        _cuda.library().dfot_ring_bwd_dq_wide(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(out), _ptr(dq), B * H, N, D, plan["lanes"], plan["stages"],
            plan["smem_bytes"], int(plan["resident"]), float(sm_scale), int(kv_shift),
            int(read_prev), int(last), _cuda.stream_handle(q.device),
        ),
        what,
    )
    ring_dq_hop_wide.launches += 1
    return out if last else dq


def ring_dkv_hop_wide(q, k, v, do, lse, delta, dk, dv, kv_shift: int, last: bool,
                      sm_scale: float, *, head_dim: Optional[int] = None, plain: bool = False):
    """:func:`ring_dkv_hop` at a padded head dim above 256: one launch of the
    wide family's ring entry of B5 (``csrc/flash_wide.cu``), adding in
    place. On the CPU, or with ``plain``, the plain version."""
    what = "ring attention hop backward (dk, dv, wide)"
    if not _kernel_path(what, q, plain):
        return _ring_dkv_plain(q, k, v, do, lse, delta, dk, dv, kv_shift, last, sm_scale)
    _check_wide(what, q, k, v, do)
    q, k, v, do, lse, delta = _bwd_operands(what, q, k, v, do, lse, delta)
    B, H, N, D = q.shape
    dk = _state(what, dk, (B, H, N, D), q.device)
    dv = _state(what, dv, (B, H, N, D), q.device)
    if (dk is None) != (dv is None):
        raise ValueError(f"{what}: dk and dv are summed together or not at all")
    read_prev = dk is not None
    if dk is None and not last:
        dk, dv = (torch.empty((B, H, N, D), dtype=torch.float32, device=q.device)
                  for _ in range(2))
    out_k, out_v = (torch.empty_like(k), torch.empty_like(v)) if last else (None, None)
    plan = flash_plan("ring_dkv", B * H, N, D, head_dim)
    _cuda.check(
        _cuda.library().dfot_ring_bwd_dkv_wide(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), _ptr(out_k), _ptr(out_v), _ptr(dk), _ptr(dv), B * H, N, D,
            plan["lanes"], plan["stages"], plan["smem_bytes"], int(plan["resident"]),
            float(sm_scale), int(kv_shift), int(read_prev), int(last),
            _cuda.stream_handle(q.device),
        ),
        what,
    )
    ring_dkv_hop_wide.launches += 1
    return (out_k, out_v) if last else (dk, dv)


# kernel launches since the last reset
ring_fwd_hop.launches = 0
ring_dq_hop.launches = 0
ring_dkv_hop.launches = 0
ring_fwd_hop_wide.launches = 0
ring_dq_hop_wide.launches = 0
ring_dkv_hop_wide.launches = 0


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------


def _visits(ring, k, v):
    """(hop, K, V) of each hop in ring order. On a LocalRing the home shards
    every time (the hop's ``kv_shift`` names the visiting one); on a
    ProcessRing the shard this process holds, hop s + 1's transfer posted
    before hop s's kernel runs and waited for after it, received into a
    second pair of buffers (the inputs are never written)."""
    ck, cv, spare = k, v, None
    for hop in range(ring.size):
        pending = None
        if ring.moves_shards and hop < ring.size - 1:
            pending = ring.start_hop((ck, cv), spare)
        yield hop, ck, cv
        if pending is not None:
            spare = (ck, cv) if hop else None
            ck, cv = pending.wait()


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, sm_scale, head_dim, plain):
        o = lse = None
        for hop, ck, cv in _visits(ring, k, v):
            o, lse = ring_fwd_hop(q, ck, cv, o, lse, ring.kv_shift(hop, q), hop == ring.size - 1,
                                  sm_scale, head_dim=head_dim, plain=plain)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (ring, sm_scale, head_dim, plain)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ring, sm_scale, head_dim, plain = ctx.args
        do = do.contiguous()
        delta = _delta(o, do)
        dq = dk = dv = None
        for hop, ck, cv in _visits(ring, k, v):
            shift, last = ring.kv_shift(hop, q), hop == ring.size - 1
            dq = ring_dq_hop(q, ck, cv, do, lse, delta, dq, shift, last, sm_scale,
                             head_dim=head_dim, plain=plain)
            dk, dv = ring_dkv_hop(q, ck, cv, do, lse, delta, dk, dv, shift, last, sm_scale,
                                  head_dim=head_dim, plain=plain)
            if ring.moves_shards and ring.size > 1:
                # the sums travel with their shard; after the last hop, home
                dk, dv = ring.hop(dk, dv)
        return dq, dk, dv, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring,
                   sm_scale: Optional[float] = None, plain: bool = False) -> torch.Tensor:
    """Non-causal attention of this rank's (B, H, N_local, D) q, k, v, the
    global sequence being the R ranks' shards in rank order (``ring``: a
    :class:`ProcessRing`, or a :class:`LocalRing` with its ranks' shards
    stacked). ``sm_scale`` defaults to 1/sqrt(D). Differentiable. On a CUDA
    tensor every hop is one launch of the ring entry of B1 forward and one
    each of B4's and B5's backward (bf16, N_local a multiple of 64; else it
    raises; their wide family's above 256 lanes), heads of other widths
    zero-padded to the next the kernels take;
    on the CPU, or with ``plain``, the plain hops run."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if plain or not q.is_cuda or d == padded_head_dim(d):
        return _Ring.apply(q, k, v, ring, float(sm_scale), d, plain)
    pad = padded_head_dim(d) - d
    qp, kp, vp = (F.pad(t, (0, pad)) for t in (q, k, v))
    return _Ring.apply(qp, kp, vp, ring, float(sm_scale), d, plain)[..., :d]


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring,
                                sm_scale: Optional[float] = None,
                                plain: bool = False) -> torch.Tensor:
    """Global (B, H, N, D) in and out: each rank keeps its N / R rows, runs
    :func:`ring_attention` and gathers O. N must divide by the ring's size."""
    if q.shape[-2] % ring.size:
        raise ValueError(
            f"sequence length {q.shape[-2]} not divisible by the ring of size {ring.size}")
    o = ring_attention(ring.shard(q), ring.shard(k), ring.shard(v), ring, sm_scale, plain)
    return ring.gather(o)
