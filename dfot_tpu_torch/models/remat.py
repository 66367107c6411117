"""Rematerialization policies for checkpointed backbone blocks.

Port of ``dfot_tpu/models/remat.py``. A U-ViT level with
``use_checkpointing`` runs its transformer blocks, and a DiT with
``use_gradient_checkpointing`` every block, under ``torch.utils.checkpoint``
(non-reentrant, random state preserved so dropout replays). The policy picks
what the forward keeps; the backward runs the rest of the block again:

- ``None`` / ``"none"``: keep nothing (upstream semantics).
- ``"dots"``: keep the outputs of the linear layers as they dispatch
  (``aten.mm``, ``aten.addmm``), JAX's ``dots_with_no_batch_dims_saveable``.
  Batched products (``aten.bmm``: JAX's einsums with batch dims),
  convolutions and the attention ops are recomputed.
- ``"attn"``: keep the tensors the JAX models tag ``attn_out``
  (``tag_attn_out``): the attention output of each route. A tensor is tagged
  by the op that makes it, for ``torch.utils.checkpoint``'s selective
  contexts see ops, not names: ``dfot::attn_out_collect`` (kernel B3, the
  packed route's last op) and ``dfot::small_n_attention`` (kernel B10). The
  flash op ``dfot::flash_attention`` (kernel B1) is never kept: its
  backward needs q, k, v, O and the LSE, residuals JAX does not name, so
  JAX runs B1 (and B2 before it) again under ``attn`` too (ROADMAP.md C6).
- ``"dots_attn"``: the union of the two.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

__all__ = ["REMAT_POLICIES", "remat", "remat_policy", "saved_ops"]

REMAT_POLICIES = ("none", "dots", "attn", "dots_attn")


def _dot_ops() -> frozenset:
    aten = torch.ops.aten
    return frozenset({aten.mm.default, aten.addmm.default})


def _attn_out_ops() -> frozenset:
    from ..ops import attention, qkv_prep  # noqa: F401  (registers the dfot ops)

    return frozenset({torch.ops.dfot.attn_out_collect.default,
                      torch.ops.dfot.small_n_attention.default})


def saved_ops(name: Optional[str]) -> frozenset:
    """The ops whose outputs a policy keeps."""
    if name is None or name == "none":
        return frozenset()
    if name == "dots":
        return _dot_ops()
    if name == "attn":
        return _attn_out_ops()
    if name == "dots_attn":
        return _dot_ops() | _attn_out_ops()
    raise ValueError(f"unknown remat_policy {name!r}: want none|dots|attn|dots_attn")


def remat_policy(name: Optional[str]) -> Optional[Callable]:
    """A policy function for ``create_selective_checkpoint_contexts``, or
    None for ``none`` (keep nothing)."""
    keep = saved_ops(name)
    if not keep:
        return None

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in keep else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def remat(policy: Optional[str]) -> Callable:
    """``run(fn, *args)`` for a policy name: calls ``fn(*args)`` so that its
    intermediates, but for what the policy keeps, are recomputed in the
    backward."""
    fn = remat_policy(policy)
    kw = {} if fn is None else {
        "context_fn": functools.partial(create_selective_checkpoint_contexts, fn)}
    return lambda block, *args: checkpoint(
        block, *args, use_reentrant=False, preserve_rng_state=True, **kw)
