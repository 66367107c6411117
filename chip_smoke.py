#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dfot_tpu_torch) on one NVIDIA Hopper GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. builds the port's CUDA kernels from ``dfot_tpu_torch/csrc`` with nvcc
   (one compile per source, all started together);
2. checks each kernel (B1 flash forward, B2 qkv_prep, B3 attn_out_collect,
   B4 flash backward dq, B5 flash backward dk/dv, B6 qkv_prep backward, B7
   attn_out_scatter) against its plain PyTorch version at the DFoT_RE10K
   flagship shapes, B = 1 (the train step) and B = 2 (the window), in bf16
   on seeded inputs, times both, computes each kernel's bound (the least
   time the card could take) and, where one PyTorch call computes the same
   function, times that call as a yardstick;
3. runs one full-width flagship UViT3DPose forward (B = 2, T = 8, 256 px,
   seeded random bf16 weights) on the kernel route and on the plain route;
4. samples a small 3-step window on both routes with the same random
   stream and compares them;
5. drives the sampling path: ``DFoTRollout.sample_sequence`` for the
   8-frame quick-start window (1 context frame, identity poses, vanilla
   history guidance at scale 4, 50 DDIM steps), with every kernel's launch
   count reset just before and read just after;
6. samples a shorter window under ``torch.profiler``: device time by
   kernel class and the device's idle share;
7. runs one full-width forward and backward (B = 1, fp32 master weights,
   bf16 compute) on the kernel route and on the plain route and compares
   the loss and the gradients of named parameters;
8. drives the training path: ``make_train_state`` + ``make_train_step`` of
   the flagship recipe, a warm-up step and then five steps on a seeded
   synthetic batch, launch counts reset just before and read just after,
   time per step and peak memory;
9. takes one more train step under ``torch.profiler``.

Steps 3, 4 and 7 also run a control (an attention that ignores q and k; a
backward whose dq is zero) and fail unless their bound rejects it. Any
failed check exits non-zero. The last two lines of standard output are the
kernels' JSON record and ``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# (name, C source, TPU kernel it replaces)
KERNELS = (
    ("flash_fwd", "dfot_tpu_torch/csrc/flash_fwd.cu", "dfot_tpu/ops/attention.py:114"),
    ("qkv_prep", "dfot_tpu_torch/csrc/qkv_prep.cu", "dfot_tpu/ops/qkv_prep.py:115"),
    ("attn_out_collect", "dfot_tpu_torch/csrc/attn_out_collect.cu", "dfot_tpu/ops/qkv_prep.py:528"),
    ("flash_bwd_dq", "dfot_tpu_torch/csrc/flash_bwd.cu", "dfot_tpu/ops/attention.py:378"),
    ("flash_bwd_dkv", "dfot_tpu_torch/csrc/flash_bwd.cu", "dfot_tpu/ops/attention.py:500"),
    ("qkv_prep_bwd", "dfot_tpu_torch/csrc/qkv_prep_bwd.cu", "dfot_tpu/ops/qkv_prep.py:147"),
    ("attn_out_scatter", "dfot_tpu_torch/csrc/attn_out_scatter.cu", "dfot_tpu/ops/qkv_prep.py:534"),
)
FORWARD_KERNELS = ("flash_fwd", "qkv_prep", "attn_out_collect")
# the batch each path gives its kernels: the window runs the denoiser at
# B * NFE = 2, the train step at B = 1; the kernels line reports the forward
# kernels at the window's batch and the backward kernels at the train step's
BATCHES = (1, 2)
WINDOW_BATCH, TRAIN_BATCH = 2, 1
# published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12   # tensor cores, bf16
PEAK_FP32_FLOPS = 67e12    # outside the tensor cores
PEAK_BYTES = 3.35e12       # device memory, bytes/s
# flagship attention sites: (level, tokens N, heads, head dim)
SITES = ((2, 8192, 9, 64), (3, 2048, 9, 128))
# bf16 kernel route vs plain route, relative L2: about 3x the sound route's
# reading (7.5e-3, 6.6e-3) and 6-10x under the control's (0.20, 0.12),
# both at the random-weight law of dfot_tpu_torch/utils/weights.py
FORWARD_REL_TOL = 2e-2
WINDOW_REL_TOL = 2e-2
# forward + backward, kernel route vs plain route at B = 1: relative
# difference of the loss, relative L2 of each named parameter's gradient
GRAD_LOSS_TOL = 1e-3
GRAD_REL_TOL = 5e-2
PROFILED_WINDOW_STEPS = 10
TRAIN_STEPS = 5
# device kernels by class for the profiled window: (class, name substrings),
# first match wins; anything else is eager elementwise work and copies
KERNEL_CLASSES = (
    ("B1 flash_fwd", ("flash_fwd_kernel",)),
    ("B2 qkv_prep", ("qkv_prep_kernel",)),
    ("B3 attn_out_collect", ("attn_out_collect_kernel",)),
    ("B4 flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("B5 flash_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("B6 qkv_prep_bwd", ("qkv_prep_bwd_kernel",)),
    ("B7 attn_out_scatter", ("attn_out_scatter_kernel",)),
    ("optimizer, clipping, EMA (foreach)", ("multi_tensor_apply",)),
    ("cuDNN layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("cuDNN backward convolutions", ("dgrad", "wgrad", "bwd_data", "bwd_filter", "backward_data",
                                     "backward_filter")),
    ("cuDNN convolutions", ("fprop", "implicit_gemm", "convolve", "winograd")),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "cutlass")),
    ("GroupNorm (statistics, apply, backward)",
     ("RowwiseMoments", "GroupNorm", "group_norm", "ComputeInternalGradients",
      "ComputeBackwardFusedParams", "GammaBetaBackward")),
    ("avg-pool, nearest upsample", ("avg_pool", "upsample")),
)


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


@functools.lru_cache(maxsize=None)
def _hold_operands():
    """Operands of the holding product and the time one product takes."""
    import torch

    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    out = torch.empty_like(a)
    return a, out, _event_ms(lambda: torch.mm(a, a, out=out), 5)


def hold_device(ms: float = 10.0) -> None:
    """Queue about ``ms`` of matrix products, so that what the host queues
    next waits on the device and runs there back to back."""
    import torch

    a, out, each = _hold_operands()
    for _ in range(max(1, round(ms / each))):
        torch.mm(a, a, out=out)


def _event_ms(fn, reps: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls. The calls are queued behind :func:`hold_device`, so a short
    kernel's time is the device's and not the rate at which the host (Python
    and ctypes) can launch it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    hold_device()
    return _event_ms(fn, reps)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bound(flops: float, nbytes: float, peak_flops: float) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate and its operations over the peak rate of their
    type."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def ref_tol(rel: float, *refs) -> float:
    """``rel`` times the references' largest magnitude, at least ``rel``."""
    return rel * max(1.0, max(float(r.float().abs().max()) for r in refs))


def check_kernels(record: dict) -> dict:
    """Each kernel against its plain version at the flagship shapes, at the
    train step's batch and at the window's."""
    import torch
    import torch.nn.functional as F
    from dfot_tpu_torch.models.embeddings import make_rope_3d
    from dfot_tpu_torch.ops import attention as A, qkv_prep as Q

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    results = {name: {"by_site": {}} for name, _, _ in KERNELS}

    def note(name, site, err, tol, ms, plain_ms, bnd, library_ms=None, **extra):
        results[name]["by_site"][site] = {
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bnd, **extra,
        }
        lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        log(f"  {name:17s} {site}: max_abs_err {err:.3e} (tol {tol:.3e})  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}){lib}")
        require(err <= tol, f"{name} at {site}: error {err} above {tol}")

    for B in BATCHES:
        for level, N, H, D in SITES:
            site = f"level{level} B={B} N={N} H={H} d={D}"
            C = H * D
            # B2: packed qkv sliced out of the fused qkv+mlp projection (strided
            # rows, as in the model), tables and norm scales as in the model
            fused = torch.randn(B, N, 7 * C, generator=gen, device="cuda").to(bf16)
            qkv = fused[..., : 3 * C]
            side = int(math.isqrt(N // 8))
            rope = make_rope_3d(D, (8, side, side))
            cos = torch.as_tensor(rope.cos, device="cuda")
            sin = torch.as_tensor(Q.signed_sin(rope.sin), device="cuda")
            scales = [(1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(bf16)
                      for _ in range(2)]
            kw = dict(q_scale=scales[0], k_scale=scales[1], norm=True)
            got = Q.qkv_prep(qkv, H, D, cos, sin, **kw)
            torch.cuda.synchronize()
            want = Q.reference_qkv_prep(qkv, H, D, cos, sin, **kw)
            err = max(max_err(g, w) for g, w in zip(got, want))
            # times of the kernel and of its plain version alone, on tables
            # already folded (the fold is the same small torch ops on both routes)
            tabs = Q.fold_qk_tables(cos, sin, *scales, dtype=bf16)
            flat_tabs = [t for pair in tabs for t in pair]
            packed_bytes = B * N * 3 * C * 2
            note("qkv_prep", site, err, ref_tol(2e-2, *want),
                 cuda_ms(lambda: Q._prep_cuda(qkv, tabs, H, D, D, True, 1e-6)),
                 cuda_ms(lambda: Q._prep_plain(qkv, tabs, H, D, D, True, 1e-6)),
                 # per q/k element: square + sum, scale, two multiply-adds
                 bound(7 * B * N * 2 * C, packed_bytes + nbytes(*flat_tabs, *got),
                       PEAK_FP32_FLOPS))

            # B6: the cotangents of q, k, v back to the packed layout
            dys = [torch.randn(B, H, N, D, generator=gen, device="cuda").to(bf16)
                   for _ in range(3)]
            got = Q.qkv_prep_bwd(qkv, tabs, *dys, H, D, True)
            torch.cuda.synchronize()
            want = Q.qkv_prep_bwd(qkv, tabs, *dys, H, D, True, plain=True)
            require(all(g.dtype == torch.float32 for g in got[1:]),
                    "qkv_prep_bwd: table cotangents are not fp32")
            err_t = max(max_err(g, w) for g, w in zip(got[1:], want[1:]))
            tol_t = ref_tol(5e-3, *want[1:])
            log(f"  qkv_prep_bwd tabs  {site}: max_abs_err {err_t:.3e} (tol {tol_t:.3e})")
            require(err_t <= tol_t, f"qkv_prep_bwd table cotangents at {site}: {err_t} > {tol_t}")
            note("qkv_prep_bwd", site, max_err(got[0], want[0]), ref_tol(2e-2, want[0]),
                 cuda_ms(lambda: Q.qkv_prep_bwd(qkv, tabs, *dys, H, D, True)),
                 cuda_ms(lambda: Q.qkv_prep_bwd(qkv, tabs, *dys, H, D, True, plain=True)),
                 # per q/k element: the forward's norm again, the rotation
                 # back, the norm's backward and two table products
                 bound(20 * B * N * 2 * C,
                       packed_bytes + nbytes(*flat_tabs, *dys) + nbytes(*got), PEAK_FP32_FLOPS),
                 table_err=err_t, table_tol=tol_t)
            del fused, qkv, got, want, dys

            # B1: peaked attention (score std ~3) so outputs are O(1)
            q, k, v = (torch.randn(B, H, N, D, generator=gen, device="cuda") for _ in range(3))
            q, k, v = (q * 1.7).to(bf16), (k * 1.7).to(bf16), v.to(bf16)
            o, lse = A.flash_attention(q, k, v, return_lse=True)
            torch.cuda.synchronize()
            o_ref, lse_ref = A.attention_reference(q, k, v, return_lse=True)
            err_l = max_err(lse, lse_ref)
            require(err_l <= 1e-3, f"flash_fwd lse at {site}: error {err_l} above 1e-3")
            log(f"  flash_fwd lse     {site}: max_abs_err {err_l:.3e} (tol 1.000e-03)")
            pairs = B * H * N * N * D  # multiply-adds of one N x N x d product
            note("flash_fwd", site, max_err(o, o_ref), ref_tol(1e-2, o_ref),
                 cuda_ms(lambda: A.flash_attention(q, k, v)),
                 cuda_ms(lambda: A.attention_reference(q, k, v), reps=3, warmup=1),
                 bound(4 * pairs, nbytes(q, k, v, o, lse), PEAK_BF16_FLOPS),
                 cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)), lse_err=err_l)

            # B4, B5 on the forward's saved results; the plain versions are
            # the explicit fp32 formulas on the same O and LSE
            do = torch.randn(B, H, N, D, generator=gen, device="cuda").to(bf16)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            dq = A.flash_bwd_dq(q, k, v, do, lse, delta)
            dk, dv = A.flash_bwd_dkv(q, k, v, do, lse, delta)
            torch.cuda.synchronize()
            dq_ref, dk_ref, dv_ref = A.attention_backward_reference(q, k, v, o, lse, do)
            scale = 1.0 / math.sqrt(D)
            # the yardstick: the backward of PyTorch's fused attention, one
            # call that gives dq, dk and dv (what B4 and B5 give together)
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            ol = F.scaled_dot_product_attention(ql, kl, vl)
            sdpa_bwd = cuda_ms(
                lambda: torch.autograd.grad(ol, (ql, kl, vl), do, retain_graph=True))
            del ol, ql, kl, vl
            note("flash_bwd_dq", site, max_err(dq, dq_ref), ref_tol(2e-2, dq_ref),
                 cuda_ms(lambda: A.flash_bwd_dq(q, k, v, do, lse, delta)),
                 cuda_ms(lambda: A._dq_plain(q, k, v, do, lse, delta, False, scale),
                         reps=3, warmup=1),
                 bound(6 * pairs, nbytes(q, k, v, do, lse, delta, dq), PEAK_BF16_FLOPS),
                 sdpa_bwd, library_covers="dq, dk and dv")
            note("flash_bwd_dkv", site, max(max_err(dk, dk_ref), max_err(dv, dv_ref)),
                 ref_tol(2e-2, dk_ref, dv_ref),
                 cuda_ms(lambda: A.flash_bwd_dkv(q, k, v, do, lse, delta)),
                 cuda_ms(lambda: A._dkv_plain(q, k, v, do, lse, delta, False, scale),
                         reps=3, warmup=1),
                 bound(8 * pairs, nbytes(q, k, v, do, lse, delta, dk, dv), PEAK_BF16_FLOPS),
                 sdpa_bwd, library_covers="dq, dk and dv")
            del o_ref, lse_ref, dq_ref, dk_ref, dv_ref, dq, dk, dv

            # B3 and B7: exact copies; PyTorch's strided copy is both the
            # plain version and the one library call
            got = Q.attn_out_collect(o, D)
            torch.cuda.synchronize()
            plain = cuda_ms(lambda: Q.reference_attn_out_collect(o, D).contiguous())
            note("attn_out_collect", site, max_err(got, Q.reference_attn_out_collect(o, D)), 0.0,
                 cuda_ms(lambda: Q.attn_out_collect(o, D)), plain,
                 bound(0, nbytes(o, got), PEAK_FP32_FLOPS), plain)
            g = torch.randn(B, N, C, generator=gen, device="cuda").to(bf16)
            got = Q.attn_out_scatter(g, H, D, D)
            torch.cuda.synchronize()
            plain = cuda_ms(lambda: Q.reference_attn_out_scatter(g, H, D, D))
            note("attn_out_scatter", site, max_err(got, Q.reference_attn_out_scatter(g, H, D, D)),
                 0.0, cuda_ms(lambda: Q.attn_out_scatter(g, H, D, D)), plain,
                 bound(0, nbytes(g, got), PEAK_FP32_FLOPS), plain)
            del q, k, v, o, lse, do, delta, g, got
    record["kernel_checks"] = results
    _hold_operands.cache_clear()  # the later phases read peak memory
    return results


def kernel_summary(results: dict, launches: dict) -> list:
    """One record per kernel for the kernels line: errors are the largest
    over every site and batch checked; times and bounds are summed over the
    two flagship sites at the batch of the kernel's own path (the window's
    for the forward kernels, the train step's for the backward kernels)."""
    out = []
    for name, src, rep in KERNELS:
        B = WINDOW_BATCH if name in FORWARD_KERNELS else TRAIN_BATCH
        sites = results[name]["by_site"]
        mine = [r for s, r in sites.items() if f" B={B} " in s]
        bounds = {r["bound_by"] for r in mine}
        lib = [r["library_ms"] for r in mine]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(launches[name].values()), "launches_by_path": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in sites.values()),
            "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": bounds.pop() if len(bounds) == 1 else "bytes",
            "library_ms": None if None in lib else sum(lib),
            "timed_at": f"B={B}, level 2 + level 3",
        })
    return out


def flagship_inputs(fs, model, B: int, gen):
    """Seeded flagship-shaped inputs: token-layout x, noise input, pose
    conditioning (identity poses), and a cond mask with one dropped row."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import sampling_cond_transform
    from dfot_tpu_torch.diffusion.continuous import continuous_model_noise_input
    from dfot_tpu_torch.diffusion.core import make_schedule

    s = fs.spec
    T, R, p = s.max_temporal_length, fs.resolution, s.patch_size
    x = torch.randn(B, T, (R // p) ** 2, p * p * fs.x_channels, generator=gen, device="cuda")
    k = torch.randint(0, fs.dcfg.timesteps, (B, T), generator=gen, device="cuda")
    noise_in = continuous_model_noise_input(fs.dcfg, make_schedule(fs.dcfg, "cuda"), k)
    cond = sampling_cond_transform(model, fs.conditioning_type)(identity_poses(B, T, "cuda"))
    mask = torch.arange(B, device="cuda") % 2 == 1
    return x, noise_in, cond, mask


def identity_poses(B: int, T: int, device):
    """Valid (B, T, 16) camera vectors: unit intrinsics and identity pose."""
    import torch

    pose = torch.zeros(B, T, 16, device=device)
    pose[..., :4] = torch.tensor([1.0, 1.0, 0.5, 0.5], device=device)
    pose[..., 4] = pose[..., 9] = pose[..., 14] = 1.0
    return pose


def make_rollout(fs, model, dcfg):
    from dfot_tpu_torch.algorithms.dfot_video import sampling_cond_transform
    from dfot_tpu_torch.diffusion.core import make_schedule
    from dfot_tpu_torch.models.uvit import patchify_tokens, unpatchify_tokens
    from dfot_tpu_torch.sampling import DFoTRollout, RolloutConfig

    p, R = fs.spec.patch_size, fs.resolution
    cfg = RolloutConfig(
        max_tokens=fs.spec.max_temporal_length,
        x_shape=(R, R, fs.x_channels),
        cond_transform=sampling_cond_transform(model, fs.conditioning_type),
        state_codec=(lambda x: patchify_tokens(x, p), lambda x: unpatchify_tokens(x, p, R, R)),
    )
    return DFoTRollout(cfg, dcfg, make_schedule(dcfg, "cuda"), model)


def run_window(ro, fs, seed: int):
    import numpy as np
    import torch

    T = fs.spec.max_temporal_length
    R = fs.resolution
    ctx = torch.zeros(1, T, R, R, fs.x_channels, device="cuda")
    mask = np.zeros((1, T), dtype=np.int64)
    mask[:, 0] = 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return ro.sample_sequence(
        gen, 1, length=T, context=ctx, context_mask=mask,
        conditions=identity_poses(1, T, "cuda"), history_guidance=fs.history_guidance,
    )


def build_random_model(fs, seed: int, token_io: bool = True):
    """The recipe's model on the card with seeded random fp32 weights."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import build_model
    from dfot_tpu_torch.utils.weights import init_random_weights

    model = build_model(fs, token_io=token_io)
    init_random_weights(model, torch.Generator().manual_seed(seed))
    return model


def sampling_copy(fs, model):
    """A bf16, token-layout, eval-mode model on the weights of ``model``."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import build_model

    twin = build_model(fs, token_io=True)
    twin.load_state_dict(model.state_dict())
    return twin.to(torch.bfloat16).eval()


def uniform_attention(qkv, heads, head_dim, tables=None, **_):
    """Control: an attention that ignores q and k, so every query takes the
    mean of v. A bound on the kernel route that passes this is no check."""
    v = qkv[..., 2 * heads * head_dim:]
    return v.mean(1, keepdim=True).expand_as(v)


@contextlib.contextmanager
def control_attention():
    """Every transformer block uses :func:`uniform_attention` inside."""
    from dfot_tpu_torch.models import uvit

    real = uvit.attention_from_packed_qkv
    uvit.attention_from_packed_qkv = uniform_attention
    try:
        yield
    finally:
        uvit.attention_from_packed_qkv = real


@contextlib.contextmanager
def control_zero_dq():
    """Control for the backward: attention's dq is zero (the dk, dv half is
    sound), so no gradient reaches q: the loss is untouched, every
    ``q_norm.weight`` gradient vanishes and the fused projections lose their
    q rows' share. A gradient bound that passes this is no check."""
    import torch
    from dfot_tpu_torch.ops import attention as A

    real = A.flash_bwd_dq
    A.flash_bwd_dq = lambda q, *args, **kwargs: torch.zeros_like(q)
    try:
        yield
    finally:
        A.flash_bwd_dq = real


def check_route(record: dict, key: str, what: str, tol: float, model, run) -> None:
    """``run()`` on the kernel route, the plain route and the control; the
    kernel route must be within ``tol`` (relative L2) of the plain route and
    the control must not be."""
    import torch

    out_k = run()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out_k).all()), f"{what}: non-finite output")
    model.use_plain_attention(True)
    try:
        out_p = run()
    finally:
        model.use_plain_attention(False)
    with control_attention():
        out_c = run()
    err, ctrl = rel_l2(out_k, out_p), rel_l2(out_c, out_p)
    record[key] = {"rel_l2": err, "control_rel_l2": ctrl, "tol": tol, "shape": list(out_k.shape)}
    log(f"{what}, kernel vs plain route: rel L2 {err:.3e} (tol {tol}); "
        f"control (attention ignoring q, k) {ctrl:.3e}")
    require(err <= tol, f"{what}: kernel route off by {err}")
    require(ctrl > tol, f"{what}: the bound {tol} does not reject the control ({ctrl})")


def small_window_check(record: dict) -> None:
    """3-step window of a narrow model (d = 64 and 128 heads) on the kernel
    route, the plain route and the control, same weights and random stream."""
    import dataclasses

    import torch
    from dfot_tpu_torch.algorithms.dfot_video import flagship

    fs = flagship()
    spec = dataclasses.replace(
        fs.spec, channels=(32, 32, 64, 128), emb_channels=64, num_updown_blocks=(1, 1, 1),
        num_mid_blocks=1, num_heads=1,
    )
    fs = fs._replace(spec=spec, resolution=64)
    dcfg = dataclasses.replace(fs.dcfg, sampling_timesteps=3)
    model = build_random_model(fs, seed=2).to(torch.bfloat16).eval()
    ro = make_rollout(fs, model, dcfg)
    check_route(record, "small_window", "small 3-step window", WINDOW_REL_TOL, model,
                lambda: run_window(ro, fs, seed=3))


def train_batch(fs, B: int, seed: int) -> dict:
    """Seeded synthetic training batch on the card: videos in [-1, 1],
    identity camera vectors, every frame available."""
    import torch

    T, R = fs.spec.max_temporal_length, fs.resolution
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.rand(B, T, R, R, fs.x_channels, generator=gen, device="cuda") * 2 - 1
    return {"xs": xs, "conditions": identity_poses(B, T, "cuda"),
            "masks": torch.ones(B, T, dtype=torch.bool, device="cuda")}


# first, middle and last transformer block, a conv block of each end, and
# the q/k norm scales whose gradients come through the table cotangents
GRAD_PROBES = (
    "down_blocks.0.0.in_layers.2.weight",
    "down_blocks.2.0.fused_attn_mlp_proj.weight",
    "down_blocks.2.0.q_norm.weight",
    "mid_blocks.10.fused_attn_mlp_proj.weight",
    "mid_blocks.10.q_norm.weight",
    "mid_blocks.10.k_norm.weight",
    "up_blocks.0.3.attn_out.weight",
    "up_blocks.0.3.q_norm.weight",
    "up_blocks.2.3.out_rest.1.weight",
)


def gradient_route_check(record: dict, fs, model) -> None:
    """One full-width forward and backward at B = 1 (dropout off, the mid
    level checkpointed) on the kernel route, the plain route and the
    zero-dq control: loss and the gradients of :data:`GRAD_PROBES`."""
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import make_train_apply
    from dfot_tpu_torch.diffusion.continuous import (
        continuous_training_fields, continuous_v_loss,
    )

    apply = make_train_apply(fs)
    batch = train_batch(fs, TRAIN_BATCH, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(8)
    t = torch.rand(batch["masks"].shape, generator=gen, device="cuda")
    noise = torch.randn(batch["xs"].shape, generator=gen, device="cuda")
    x_t, logsnr, alpha_t, sigma_t = continuous_training_fields(fs.dcfg, batch["xs"], t, noise)
    params = dict(model.named_parameters())

    def run():
        model.zero_grad(set_to_none=True)
        out = apply(model, x_t, fs.dcfg.precond_scale * logsnr, batch["conditions"], None)
        _, loss = continuous_v_loss(fs.dcfg, out, x_t, noise, logsnr, alpha_t, sigma_t)
        loss = loss.mean()
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: params[n].grad.detach().clone() for n in GRAD_PROBES}

    was_training = model.training
    model.eval()
    try:
        loss_k, grads_k = run()
        model.use_plain_attention(True)
        try:
            loss_p, grads_p = run()
        finally:
            model.use_plain_attention(False)
        with control_zero_dq():
            loss_c, grads_c = run()
    finally:
        model.train(was_training)
        model.zero_grad(set_to_none=True)

    require(math.isfinite(loss_k) and all(bool(torch.isfinite(g).all()) for g in grads_k.values()),
            "forward + backward: non-finite loss or gradient")
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    errs = {n: rel_l2(grads_k[n], grads_p[n]) for n in GRAD_PROBES}
    ctrl = {n: rel_l2(grads_c[n], grads_p[n]) for n in GRAD_PROBES}
    record["gradient_route"] = {
        "loss_kernel": loss_k, "loss_plain": loss_p, "loss_control": loss_c,
        "loss_rel_err": loss_err, "loss_tol": GRAD_LOSS_TOL, "grad_tol": GRAD_REL_TOL,
        "grad_rel_l2": errs, "control_grad_rel_l2": ctrl,
    }
    log(f"full-width forward + backward B={TRAIN_BATCH}, kernel vs plain route: loss "
        f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.3e}, tol {GRAD_LOSS_TOL}); gradients, "
        f"relative L2 (tol {GRAD_REL_TOL}), sound route / control with dq = 0:")
    for n in GRAD_PROBES:
        log(f"  {n:46s} {errs[n]:.3e} / {ctrl[n]:.3e}")
    require(loss_err <= GRAD_LOSS_TOL, f"forward + backward: loss off by {loss_err}")
    for n, e in errs.items():
        require(e <= GRAD_REL_TOL, f"forward + backward: gradient of {n} off by {e}")
    rejected = [n for n, e in ctrl.items() if e > GRAD_REL_TOL]
    require(any(n.endswith("q_norm.weight") for n in rejected) and
            any(n.endswith("fused_attn_mlp_proj.weight") for n in rejected),
            f"the gradient bound {GRAD_REL_TOL} does not reject the zero-dq control: {ctrl}")


def expected_train_launches(fs, steps: int) -> dict:
    """Launches of ``steps`` train steps: every transformer block runs the
    three forward kernels once, and once more in the backward where its
    level is checkpointed; every block runs the four backward kernels once."""
    s = fs.spec
    blocks = recomputed = 0
    for i, kind in enumerate(s.block_types):
        if kind != "TransformerBlock":
            continue
        n = s.num_mid_blocks if i == len(s.channels) - 1 else 2 * s.num_updown_blocks[i]
        blocks += n
        recomputed += n if s.use_checkpointing[i] else 0
    return {name: steps * (blocks + recomputed if name in FORWARD_KERNELS else blocks)
            for name, _, _ in KERNELS}


def run_train_path(record: dict, fs, model) -> dict:
    """The training path at full width: train state and train step of the
    recipe, a warm-up step, then ``TRAIN_STEPS`` steps between a reset and a
    read of the launch counts. The warm-up of the learning rate is cut to
    two steps so that the steps taken here move the weights by a visible
    amount (the recipe's 10000-step warm-up starts at rate 0)."""
    import torch
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.algorithms.dfot_video import make_train_state, make_train_step

    fs = fs._replace(train=fs.train._replace(num_warmup_steps=2))
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(fs, model)
    step = make_train_step(fs)
    batch = train_batch(fs, TRAIN_BATCH, seed=9)
    gen = torch.Generator(device="cuda").manual_seed(10)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if n in GRAD_PROBES}
    ema_before = {n: state.ema[n].clone() for n in before}

    state, warm = step(state, batch, gen)
    torch.cuda.synchronize()
    metrics, walls = [warm], []
    ops.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append(m)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    moved = {n: float((p.detach() - before[n]).abs().max())
             for n, p in model.named_parameters() if n in before}
    ema_moved = {n: float((state.ema[n] - ema_before[n]).abs().max()) for n in before}
    step_s = sum(walls) / len(walls)
    median_s = sorted(walls)[len(walls) // 2]
    record["train"] = {
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "step_wall_s": walls, "step_s_mean": step_s,
        "step_s_median": median_s, "steps_per_s": 1 / median_s, "loss": losses,
        "grad_norm": norms,
        "launches": launches,
        "peak_memory_bytes": peak, "param_max_change": moved, "ema_max_change": ema_moved,
        "lr_after": state.optimizer.lr, "num_warmup_steps": fs.train.num_warmup_steps,
    }
    log(f"flagship train step B={TRAIN_BATCH} (AdamW, clip {fs.train.grad_clip}, EMA, bf16 "
        f"compute over fp32 weights): median {median_s * 1e3:.1f} ms per step, "
        f"{1 / median_s:.3f} steps/s, over {TRAIN_STEPS} steps "
        f"({', '.join(f'{w * 1e3:.1f}' for w in walls)}; mean {step_s * 1e3:.1f}), peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"  loss {losses}  grad norm {norms}  launches {launches}")
    require(all(math.isfinite(v) for v in losses + norms), "train step: non-finite loss or norm")
    require(state.step == TRAIN_STEPS + 1, f"train state counts {state.step} steps")
    require(all(v > 0 for v in moved.values()), f"train steps left parameters unchanged: {moved}")
    require(all(v > 0 for v in ema_moved.values()),
            f"train steps left the EMA unchanged: {ema_moved}")
    expect = expected_train_launches(fs, TRAIN_STEPS)
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the training path")
        require(n == expect[name], f"kernel {name}: {n} launches in {TRAIN_STEPS} train steps, "
                                   f"expected {expect[name]}")
    return {"state": state, "step": step, "batch": batch, "gen": gen, "launches": launches}


def kernel_class(name: str) -> str:
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "elementwise and copies"


def profiled(record: dict, key: str, what: str, run, unprofiled_s=None) -> None:
    """``run()`` under torch.profiler: device time by kernel class and the
    share of the wall time the device sat idle. The profiler slows the host,
    so with ``unprofiled_s`` (the same work's wall time without it) the idle
    share is also given against that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side entries that are kernels or copies: torch.optim's profiler
    # annotation ("Optimizer.step#AdamW.step") also shows up on the device
    # side and would count the optimizer's kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    by_class, top = {}, []
    for e in kernels:
        ms = e.self_device_time_total / 1e3
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        top.append({"kernel": e.key[:160], "class": cls, "ms": ms, "calls": e.count})
    busy = sum(by_class.values()) / 1e3
    host = sorted(
        (e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda e: -e.self_cpu_time_total)[:15]
    record[key] = {
        "wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall if busy else None,
        "device_launches": sum(e.count for e in kernels),
        "top_host_ops": [{"op": e.key[:80], "self_cpu_ms": e.self_cpu_time_total / 1e3,
                          "calls": e.count} for e in host],
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels": sorted(top, key=lambda r: -r["ms"])[:30],
    }
    # the profiler's events refer to each other in cycles: free them here, or
    # the collector may do it inside a later timed step (without this the
    # first timed train step stalled for about a second)
    del prof, kernels, host
    gc.collect()
    if not busy:
        log(f"profiled {what}: the profiler saw no device time (not measured)")
        return
    log(f"profiled {what}: {wall:.3f} s wall, {busy:.3f} s device busy in "
        f"{record[key]['device_launches']} launches, idle share {1 - busy / wall:.4f}")
    if unprofiled_s is not None:
        record[key]["unprofiled_wall_s"] = unprofiled_s
        record[key]["idle_share_unprofiled"] = 1 - busy / unprofiled_s
        log(f"  against the unprofiled {unprofiled_s:.3f} s: idle share "
            f"{1 - busy / unprofiled_s:.4f}")
    for cls, ms in record[key]["by_class_ms"].items():
        log(f"  {cls:40s} {ms:10.2f} ms  {ms / 1e3 / busy:7.2%}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import dfot_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT}: {e}", file=sys.stderr)
        return 2
    import dataclasses

    from dfot_tpu_torch import ops
    from dfot_tpu_torch.ops import _cuda

    # stated numerics: fp32 matmuls and convolutions in full fp32 (the plain
    # attention's reference products); the models compute in bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"tf32": {"matmul": False, "cudnn": False}}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    record["nvidia_smi"] = smi
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t_start = time.perf_counter()
    _cuda.library()
    record["build"] = {"seconds_total": time.perf_counter() - t_start, **_cuda.build_info}
    log(f"kernel build: {record['build']['seconds_total']:.2f} s "
        f"(nvcc {_cuda.build_info['seconds']:.2f} s) -> {_cuda.build_info['path']}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "nvcc_build.log").write_text(_cuda.build_info["log"])

    try:
        log("kernels vs plain versions at the flagship shapes (bf16):")
        results = check_kernels(record)
        from dfot_tpu_torch.algorithms.dfot_video import flagship

        fs = flagship()
        t0 = time.perf_counter()
        train_model = build_random_model(fs, seed=0, token_io=False)
        model = sampling_copy(fs, train_model)
        log(f"flagship UViT3DPose: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
            f"parameters, seeded random weights, fp32 to train and a bf16 copy to sample "
            f"({time.perf_counter() - t0:.1f} s)")
        with torch.no_grad():
            x, nl, cond, cmask = flagship_inputs(
                fs, model, 2, torch.Generator(device="cuda").manual_seed(4))
            check_route(record, "forward", "full-width forward B=2 T=8 256px", FORWARD_REL_TOL,
                        model, lambda: model(x, nl, cond, cmask))
            del x, cond

        small_window_check(record)

        # the sampling path
        ro = make_rollout(fs, model, fs.dcfg)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        video = run_window(ro, fs, seed=5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        window_launches = ops.launch_counts()
        T = fs.spec.max_temporal_length
        expect = (1, T, fs.resolution, fs.resolution, fs.x_channels)
        record["window"] = {
            "wall_s": wall, "frames_per_s": (T - 1) / wall, "launches": window_launches,
            "denoiser_evals_b1": ro.stats["denoiser_evals_b1"], "shape": list(video.shape),
        }
        log(f"8-frame window, 50 DDIM steps, vanilla HG 4.0: {wall:.3f} s wall, "
            f"{(T - 1) / wall:.4f} generated frames/s; launches {window_launches}")
        require(tuple(video.shape) == expect, f"window shape {tuple(video.shape)} != {expect}")
        require(bool(torch.isfinite(video).all()), "window: non-finite output")
        for name in FORWARD_KERNELS:
            require(window_launches[name] > 0, f"kernel {name} was not launched by the window")
        del video

        short = dataclasses.replace(fs.dcfg, sampling_timesteps=PROFILED_WINDOW_STEPS)
        ro_short = make_rollout(fs, model, short)
        profiled(record, "profile", f"{PROFILED_WINDOW_STEPS}-step window",
                 lambda: run_window(ro_short, fs, seed=6))
        del ro, ro_short, model
        torch.cuda.empty_cache()

        # the training path
        gradient_route_check(record, fs, train_model)
        trained = run_train_path(record, fs, train_model)
        profiled(record, "train_profile", "train step",
                 lambda: trained["step"](trained["state"], trained["batch"], trained["gen"]),
                 unprofiled_s=record["train"]["step_s_median"])
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
        return 1
    record["seconds_total"] = time.perf_counter() - t_start
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"chip_smoke: all phases passed in {record['seconds_total']:.1f} s")

    launches = {name: {"window": window_launches[name], "train": trained["launches"][name]}
                for name, _, _ in KERNELS}
    log(smi)
    log(json.dumps({"kernels": kernel_summary(results, launches)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
