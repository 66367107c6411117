"""Ring (sequence-parallel) attention over R ranks.

Port of ``dfot_tpu/ops/ring_attention.py``. The token axis of q, k, v is
split over R ranks; each rank keeps its query rows and the K/V shards travel
around the ring, one hop to ``(rank + 1) % R`` at a time, while each
visiting shard's block is folded into an online softmax in (O, LSE) space.
No rank ever holds the whole sequence's scores.

- A block (one rank's queries against one K/V shard) is kernel B1,
  ``flash_attention(..., return_lse=True, sm_scale=...)``, on a CUDA
  tensor (the port of ``_block_flash``, :49), and the plain
  ``attention_reference(..., return_lse=True)`` on the CPU or with
  ``plain``. Its O is cast to fp32 before the fold, as ``_block_flash``
  casts it (:57); the fold is fp32 elementwise torch (``logaddexp``, as
  :99-111); the output is cast back to the input dtype.
- The backward is a ``torch.autograd.Function``, not autodiff of the fold:
  the custom op ``dfot::flash_attention`` gives its LSE no gradient, so
  autodiff through the fold would lose every term that goes through the
  LSE. The forward saves q, k, v, the final O and the final LSE; the
  backward walks the ring again with delta = rowsum(dO * O) and the final
  LSE: kernel B4 (``flash_bwd_dq``) and kernel B5 (``flash_bwd_dkv``) for
  each hop, dq summed in place, the dk and dv sums travelling with their
  shard and brought home by one more hop after the last.
- A ring is one of two forms, with one fold: :class:`ProcessRing`, the R
  processes of a ``torch.distributed`` group, whose hop is one
  ``batch_isend_irecv`` to ``(rank + 1) % R`` (the JAX ``ppermute``'s
  permutation, :97); and :class:`LocalRing`, R virtual ranks in one process,
  their shards stacked on the leading axis (a merged batch of R x B), whose
  hop is ``torch.roll`` by one along the ranks and whose block is one launch
  of B1 (B4, B5 back) for all R ranks together.

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

from .attention import (
    FLASH_WIDTHS,
    _delta,
    _dkv_plain,
    _dq_plain,
    flash_attention,
    flash_bwd_dkv,
    flash_bwd_dq,
    padded_head_dim,
)

__all__ = ["LocalRing", "ProcessRing", "ring_attention", "sequence_parallel_attention"]


class LocalRing:
    """R virtual ranks in this process. A rank's shard of a (B, H, N, D)
    tensor is its N / R rows; the R shards are stacked on the leading axis as
    one (R B, H, N / R, D) tensor, rank r at rows r B to (r + 1) B."""

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

    def hop(self, *tensors: torch.Tensor):
        """Each rank's tensors to the next rank: rank r receives rank r - 1's."""
        return tuple(
            t.reshape(self.size, -1, *t.shape[1:]).roll(1, 0).reshape(t.shape) for t in tensors)


class ProcessRing:
    """The processes of a ``torch.distributed`` group (None: the world); a
    rank's shard is the slice of rows at its rank in the group."""

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

    def hop(self, *tensors: torch.Tensor):
        """Each tensor to rank + 1, the previous rank's in its place."""
        import torch.distributed as dist

        if self.size == 1:
            return tensors
        received = tuple(torch.empty_like(t) for t in tensors)
        ops = []
        for t, r in zip(tensors, received):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self._next, self.group))
            ops.append(dist.P2POp(dist.irecv, r, self._prev, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return received

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


def block_attention(q, k, v, sm_scale: float, head_dim: int, plain: bool):
    """One (queries x visiting K/V shard) block: (O fp32, LSE fp32 (..., N, 1)),
    the LSE in natural-log units of the scaled scores. Kernel B1 on a CUDA
    tensor, the plain version on the CPU or with ``plain``."""
    o, lse = flash_attention(q, k, v, False, sm_scale, return_lse=True, plain=plain,
                             head_dim=head_dim)
    if q.is_cuda and not plain:
        ring_attention.launches += 1
    return o.float(), lse


def fold_block(o, lse, b_o, b_lse):
    """Fold a block's (O, LSE) into the running (O, LSE), fp32."""
    new_lse = torch.logaddexp(lse, b_lse)
    return o * torch.exp(lse - new_lse) + b_o * torch.exp(b_lse - new_lse), new_lse


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, sm_scale, head_dim, plain):
        o, lse = block_attention(q, k, v, sm_scale, head_dim, plain)
        ck, cv = k, v
        for _ in range(ring.size - 1):
            ck, cv = ring.hop(ck, cv)
            o, lse = fold_block(o, lse, *block_attention(q, ck, cv, sm_scale, head_dim, plain))
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (ring, sm_scale, head_dim, plain)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ring, sm_scale, head_dim, plain = ctx.args
        do = do.contiguous()
        delta = _delta(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        ck, cv = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for hop in range(ring.size):
            if hop:
                ck, cv, dk, dv = ring.hop(ck, cv, dk, dv)
            if plain:
                b_dq = _dq_plain(q, ck, cv, do, lse, delta, False, sm_scale)
                b_dk, b_dv = _dkv_plain(q, ck, cv, do, lse, delta, False, sm_scale)
            else:
                b_dq = flash_bwd_dq(q, ck, cv, do, lse, delta, False, sm_scale,
                                    head_dim=head_dim)
                b_dk, b_dv = flash_bwd_dkv(q, ck, cv, do, lse, delta, False, sm_scale,
                                           head_dim=head_dim)
            dq += b_dq
            dk += b_dk
            dv += b_dv
        if ring.size > 1:
            dk, dv = ring.hop(dk, dv)  # each shard's sums back to its rank
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ring,
                   sm_scale: Optional[float] = None, plain: bool = False) -> torch.Tensor:
    """Non-causal attention of this rank's (B, H, N_local, D) q, k, v, the
    global sequence being the R ranks' shards in rank order (``ring``: a
    :class:`ProcessRing`, or a :class:`LocalRing` with its ranks' shards
    stacked). ``sm_scale`` defaults to 1/sqrt(D). Differentiable. On a CUDA
    tensor every block launches B1 forward and B4 + B5 backward (bf16, N_local
    a multiple of 64; else it raises), heads of other widths zero-padded to
    the next the kernels take; on the CPU, or with ``plain``, the plain
    versions run."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if plain or not q.is_cuda or d in FLASH_WIDTHS:
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


# B1 launches made for ring blocks since the last reset (each also counts in
# flash_attention.launches)
ring_attention.launches = 0
