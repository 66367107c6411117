"""Fused LayerNorm + AdaLN modulate, with plain versions.

Port of ``dfot_tpu/ops/ln_modulate.py``. A DiT block computes
``modulate(ln(x), shift, scale)`` with a LayerNorm that has neither scale nor
bias; with token-wise conditioning, shift and scale have x's shape.

- :func:`ln_modulate` is differentiable: its forward is kernel B8
  (``csrc/ln_modulate.cu``, the port of ``_fwd_kernel``), its backward
  :func:`ln_modulate_bwd`, kernel B9 (same source, the port of
  ``_bwd_kernel``), which recomputes the statistics from the saved x, so
  nothing but x and scale is kept for the backward.
- A CUDA tensor goes to the kernels or the call raises; a CPU tensor takes
  the plain versions :func:`reference_ln_modulate` and
  :func:`reference_ln_modulate_bwd` (the explicit backward formulas, not
  autograd of the forward).

Rounding points, the same in the kernels and the plain versions: fp32
statistics with var = E[x^2] - mu^2; the normalized value is cast to x's dtype
before the modulate and before dscale; dx comes from the fp32 one. The kernels
take bf16 or fp32, any token count and any even C; B8's launch is planned by
:func:`ln_modulate_plan`, B9's by :func:`ln_modulate_bwd_plan` (the same plan:
at the bf16 DiT widths both are width-exact kernels, a lane group a token).
"""

from __future__ import annotations

import functools

import torch

from . import _cuda
from .attention import _f32

__all__ = [
    "ln_modulate", "ln_modulate_bwd", "ln_modulate_bwd_plan", "ln_modulate_plan",
    "reference_ln_modulate", "reference_ln_modulate_bwd",
]

# kernels B8's and B9's plan (csrc/ln_modulate.cu)
LN_THREADS = 128    # threads of a block
LN_MAX_LANES = 32   # width-exact kernel: lanes of a token, at most
LN_MAX_REG_WIDTH = 2048  # generic kernel: widest row held in registers
# bf16 widths with a width-exact instantiation: the DiT family's hidden sizes
# (S 384, B 768, ABL 896, L 1024, XL 1152) and 2048
LN_EXACT_WIDTHS = (384, 768, 896, 1024, 1152, 2048)


@functools.lru_cache(maxsize=256)
def ln_modulate_plan(tokens: int, C: int, dtype: torch.dtype) -> dict:
    """Plan of kernel B8 for ``tokens`` rows of ``C`` channels in ``dtype``,
    as its C entry computes it again and checks it.

    ``kernel``: "exact" for bf16 at :data:`LN_EXACT_WIDTHS`, where a group of
    ``lanes`` lanes owns a token (the largest power of two up to 32 that
    divides the C / 8 16-byte vectors of a row) and each lane holds
    ``vectors`` of them of x, shift and scale; else "registers" (a warp a
    token, C a multiple of the 16-byte vector up to 2048) or "pairs" (a warp
    a token walking the row in pairs). ``block_tokens``: the tokens of a
    block of :data:`LN_THREADS` threads; ``grid``: the blocks, one for each
    ``block_tokens`` tokens, the last one ragged.
    """
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ln_modulate kernel takes bf16 or fp32, got {dtype}")
    if tokens <= 0 or C <= 0 or C % 2:
        raise ValueError(f"no ln_modulate plan for {tokens} tokens of C {C} (C even)")
    vec = 8 if dtype == torch.bfloat16 else 4  # elements of a 16-byte vector
    if dtype == torch.bfloat16 and C in LN_EXACT_WIDTHS:
        lanes = 1
        while lanes < LN_MAX_LANES and (C // 8) % (2 * lanes) == 0:
            lanes *= 2
        kernel, vectors = "exact", C // (8 * lanes)
    else:
        lanes, vectors = 32, None
        kernel = "registers" if C % vec == 0 and C <= LN_MAX_REG_WIDTH else "pairs"
    # the C entry refuses more tokens than 2^31 - 1 blocks of a warp a token take
    if -(-tokens // (LN_THREADS // 32)) >= 2 ** 31:
        raise ValueError(f"no ln_modulate plan for {tokens} tokens")
    block_tokens = LN_THREADS // lanes
    grid = -(-tokens // block_tokens)
    return {"kernel": kernel, "lanes": lanes, "vectors": vectors,
            "block_tokens": block_tokens, "threads": LN_THREADS, "grid": grid}


def ln_modulate_bwd_plan(tokens: int, C: int, dtype: torch.dtype) -> dict:
    """Plan of kernel B9, as its C entry computes it again and checks it:
    the forward's (:func:`ln_modulate_plan`). At :data:`LN_EXACT_WIDTHS` in
    bf16 a group of ``lanes`` lanes owns a token and each lane holds
    ``vectors`` 16-byte vectors of x, scale and g, loaded together; the
    other shapes take a warp a token."""
    return ln_modulate_plan(tokens, C, dtype)


def _normalized(x: torch.Tensor, eps: float):
    """(yn, rstd) in the working precision: fp32 (fp64 for an fp64 x)."""
    xf = _f32(x)
    mu = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf * xf).mean(-1, keepdim=True) - mu * mu + eps)
    return (xf - mu) * rstd, rstd


def reference_ln_modulate(x, shift, scale, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of kernel B8 on any device."""
    yn, _ = _normalized(x, eps)
    return yn.to(x.dtype) * (1 + scale) + shift


def reference_ln_modulate_bwd(x, scale, g, eps: float = 1e-6):
    """Plain version of kernel B9 on any device: ``(dx, dscale)`` from the
    saved x and scale and the cotangent g of the output (the cotangent of
    shift is g itself)."""
    yn, rstd = _normalized(x, eps)
    gl = _f32(g * (1 + scale))
    dx = rstd * (gl - gl.mean(-1, keepdim=True) - yn * (gl * yn).mean(-1, keepdim=True))
    return dx.to(x.dtype), g * yn.to(x.dtype)


def _operands(what, x, *others):
    """The kernels' contract: one shape, dtype (bf16 or fp32) and device,
    even C, contiguous and 16-byte aligned. Returns the tensors and the
    (tokens, C, is_fp32) the C entry points take."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel takes bf16 or fp32, got {x.dtype}")
    if x.ndim < 2 or x.shape[-1] % 2 or x.numel() == 0:
        raise ValueError(f"{what} kernel takes (..., C) with C even, got {tuple(x.shape)}")
    for t in others:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"{what}: operands must share x's shape {tuple(x.shape)}, dtype {x.dtype} and "
                f"device {x.device}; got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    tensors = tuple(t.contiguous() for t in (x, *others))
    _cuda.check_aligned(what, 16, *tensors)
    C = x.shape[-1]
    return tensors, (x.numel() // C, C, int(x.dtype == torch.float32))


def _fwd_cuda(x, shift, scale, eps):
    (x, shift, scale), (tokens, C, is_fp32) = _operands("ln_modulate", x, shift, scale)
    y = torch.empty_like(x)
    plan = ln_modulate_plan(tokens, C, x.dtype)
    _cuda.check(
        _cuda.library().dfot_ln_modulate_fwd(
            x.data_ptr(), shift.data_ptr(), scale.data_ptr(), y.data_ptr(), tokens, C,
            float(eps), is_fp32, plan["lanes"], plan["block_tokens"], plan["grid"],
            _cuda.stream_handle(x.device),
        ),
        "ln_modulate",
    )
    ln_modulate.launches += 1
    return y


def _forward(x, shift, scale, eps, plain):
    """Kernel B8 for a CUDA tensor, its plain version for a CPU tensor (or on
    any device with ``plain``)."""
    if shift.shape != x.shape or scale.shape != x.shape:
        raise ValueError(
            f"ln_modulate is for token-wise conditioning: shift {tuple(shift.shape)} and scale "
            f"{tuple(scale.shape)} must have x's shape {tuple(x.shape)}"
        )
    if plain or x.device.type == "cpu":
        return reference_ln_modulate(x, shift, scale, eps)
    if not x.is_cuda:
        raise ValueError(f"no ln_modulate path for device {x.device}")
    return _fwd_cuda(x, shift, scale, eps)


def ln_modulate_bwd(x, scale, g, eps: float = 1e-6, plain: bool = False):
    """``(dx, dscale)`` of :func:`ln_modulate` from the saved x and scale and
    the output's cotangent g. Kernel B9 for a CUDA tensor or the call raises;
    its plain version for a CPU tensor (or on any device with ``plain``)."""
    if plain or x.device.type == "cpu":
        return reference_ln_modulate_bwd(x, scale, g, eps)
    if not x.is_cuda:
        raise ValueError(f"no ln_modulate path for device {x.device}")
    (x, scale, g), (tokens, C, is_fp32) = _operands("ln_modulate backward", x, scale, g)
    dx, dscale = torch.empty_like(x), torch.empty_like(x)
    plan = ln_modulate_bwd_plan(tokens, C, x.dtype)
    _cuda.check(
        _cuda.library().dfot_ln_modulate_bwd(
            x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
            tokens, C, float(eps), is_fp32, plan["lanes"], plan["block_tokens"], plan["grid"],
            _cuda.stream_handle(x.device),
        ),
        "ln_modulate backward",
    )
    ln_modulate_bwd.launches += 1
    return dx, dscale


class _LnModulate(torch.autograd.Function):
    """B8 forward, B9 backward (or their plain versions)."""

    @staticmethod
    def forward(ctx, x, shift, scale, eps, plain):
        ctx.save_for_backward(x, scale)
        ctx.args = (eps, plain)
        return _forward(x, shift, scale, eps, plain)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = ln_modulate_bwd(x, scale, g, *ctx.args)
        return dx, g, dscale, None, None


def ln_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6, plain: bool = False) -> torch.Tensor:
    """``modulate(LayerNorm(x), shift, scale)`` in one pass, LayerNorm without
    scale and bias. x, shift, scale: one shape (..., C) and dtype; under
    autocast all three are taken as they come (the modulation of an
    autocast linear is bf16, so the caller casts x to match). Differentiable
    in all three. ``plain`` runs the plain versions on any device."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (x, shift, scale))):
        return _forward(x, shift, scale, eps, plain)  # no autograd bookkeeping in sampling
    return _LnModulate.apply(x, shift, scale, eps, plain)


# kernel launches since the last reset
ln_modulate.launches = 0
ln_modulate_bwd.launches = 0
