"""Rematerialization of checkpointed backbone blocks.

Port of ``dfot_tpu/models/remat.py``. A U-ViT level with
``use_checkpointing`` runs its transformer blocks, and a DiT with
``use_gradient_checkpointing`` every block, under ``torch.utils.checkpoint``
(non-reentrant, random state preserved so dropout replays): nothing inside the block is
kept, and the whole block, attention kernels included, runs again in the
backward. That is the policy ``None`` / ``"none"``, the one the recipes use.
The JAX package's selective policies (``dots``: keep matmul outputs;
``attn``: keep attention outputs; ``dots_attn``: both) are not ported yet
and raise by name (ROADMAP.md queue A10): ``torch.utils.checkpoint``'s
selective contexts see only dispatched operators, and the attention
kernels launch inside ``torch.autograd.Function``s, so ``attn`` needs the
attention forward registered as a ``torch.library`` custom op first.
"""

from __future__ import annotations

from typing import Callable, Optional

from torch.utils.checkpoint import checkpoint

__all__ = ["REMAT_POLICIES", "remat"]

REMAT_POLICIES = ("none", "dots", "attn", "dots_attn")


def remat(policy: Optional[str]) -> Callable:
    """``run(fn, *args)`` for a policy name: calls ``fn(*args)`` so that its
    intermediates are recomputed in the backward."""
    if policy is None or policy == "none":
        return lambda fn, *args: checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=True
        )
    if policy in REMAT_POLICIES:
        raise NotImplementedError(
            f"remat_policy {policy!r} (selective rematerialization) is not ported yet "
            "(ROADMAP.md queue A10); use 'none'"
        )
    raise ValueError(f"unknown remat_policy {policy!r}: want none|dots|attn|dots_attn")
