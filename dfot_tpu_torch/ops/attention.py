"""Attention ops: the flash-attention forward kernel and its plain version.

Port of ``dfot_tpu/ops/attention.py`` (forward side). Layout (B, H, N, D)
as in the JAX package.

- :func:`flash_attention` is the wrapper of kernel B1
  (``csrc/flash_fwd.cu``, the port of ``_flash_kernel``): a CUDA tensor goes
  to the kernel or the call raises; a CPU tensor takes the plain version.
- :func:`attention_reference` is the plain version, the counterpart of
  ``_xla_attention``: fp32 scores, fp32 softmax, one cast at the end.
- :func:`attention` is the dispatcher (counterpart of ``attention``).
  Sequence-parallel ring attention and the small-N kernel are not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _cuda

__all__ = ["attention", "attention_reference", "flash_attention"]


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
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        n, m = s.shape[-2:]
        keep = torch.ones(n, m, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    out = torch.matmul(torch.exp(s - lse), v.float()).to(q.dtype)
    return (out, lse) if return_lse else out


def _flash_cuda(q, k, v, causal, sm_scale, return_lse):
    B, H, N, D = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if D not in (64, 128) or N % 64 or B * H > 65535:
        raise ValueError(f"flash kernel takes d in (64, 128) and N % 64 == 0, got {q.shape}")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v on different devices")
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
            B * H, N, D, float(sm_scale), int(causal), _cuda.stream_handle(q.device),
        ),
        "flash attention forward",
    )
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Flash attention forward, (B, H, N, D) layout [, lse (B, H, N, 1)].

    ``sm_scale`` defaults to 1/sqrt(D). On a CUDA device this launches the
    hand-written kernel (bf16, D in {64, 128}, N a multiple of 64; anything
    else raises); on the CPU it runs :func:`attention_reference`.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _flash_cuda(q, k, v, causal, sm_scale, return_lse)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    return attention_reference(q, k, v, causal, sm_scale, return_lse)


flash_attention.launches = 0  # kernel launches since the last reset


def attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Attention dispatcher, (B, H, N, D) layout: the flash kernel on the
    card, its plain version on the CPU."""
    return flash_attention(q, k, v, causal)
