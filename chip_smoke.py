#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dfot_tpu_torch) on one NVIDIA Hopper GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. builds the port's CUDA kernels from ``dfot_tpu_torch/csrc`` with nvcc;
2. checks each kernel (B1 flash forward, B2 qkv_prep, B3 attn_out_collect)
   against its plain PyTorch version at the DFoT_RE10K flagship shapes, in
   bf16 on seeded inputs, and times both;
3. runs one full-width flagship UViT3DPose forward (B = 2, T = 8, 256 px,
   seeded random bf16 weights) on the kernel route and on the plain route;
4. samples a small 3-step window on both routes with the same random
   stream and compares them;
5. drives the main path: ``DFoTRollout.sample_sequence`` for the 8-frame
   quick-start window (1 context frame, identity poses, vanilla history
   guidance at scale 4, 50 DDIM steps), with every kernel's launch count
   reset just before and read just after;
6. samples the window once more under ``torch.profiler``: device time by
   kernel class and the device's idle share.

Steps 3 and 4 also run a control, an attention that ignores q and k, and
fail unless their bound rejects it. Any failed check exits non-zero. The
last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
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
)
# flagship attention sites: (level, tokens N, heads, head dim)
SITES = ((2, 8192, 9, 64), (3, 2048, 9, 128))
# bf16 kernel route vs plain route, relative L2: about 3x the sound route's
# reading (7.5e-3, 6.6e-3) and 6-10x under the control's (0.20, 0.12),
# both at the random-weight law of dfot_tpu_torch/utils/weights.py
FORWARD_REL_TOL = 2e-2
WINDOW_REL_TOL = 2e-2
# device kernels by class for the profiled window: (class, name substrings),
# first match wins; anything else is eager elementwise work and copies
KERNEL_CLASSES = (
    ("B1 flash_fwd", ("flash_fwd_kernel",)),
    ("B2 qkv_prep", ("qkv_prep_kernel",)),
    ("B3 attn_out_collect", ("attn_out_collect_kernel",)),
    ("cuDNN layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("cuDNN convolutions", ("fprop", "implicit_gemm", "convolve", "winograd")),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "cutlass")),
    ("GroupNorm (statistics, apply)", ("RowwiseMoments", "GroupNorm", "group_norm")),
    ("avg-pool, nearest upsample", ("avg_pool", "upsample")),
)


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_kernels(record: dict) -> dict:
    """Each kernel against its plain version at the flagship shapes."""
    import torch
    from dfot_tpu_torch.models.embeddings import make_rope_3d
    from dfot_tpu_torch.ops import attention as A, qkv_prep as Q

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    results = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "by_site": {}}
               for name, _, _ in KERNELS}

    def note(name, site, err, tol, ms, plain_ms):
        r = results[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["by_site"][site] = {"max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms}
        log(f"  {name:17s} {site}: max_abs_err {err:.3e} (tol {tol:.3e})  "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        require(err <= tol, f"{name} at {site}: error {err} above {tol}")

    B = 2
    for level, N, H, D in SITES:
        site = f"level{level} B={B} N={N} H={H} d={D}"
        C = H * D
        # B2: packed qkv sliced out of the fused qkv+mlp projection (strided
        # rows, as in the model), tables and norm scales as in the model
        fused = torch.randn(B, N, 7 * C, generator=gen, device="cuda").to(bf16)
        qkv = fused[..., : 3 * C]
        rope = make_rope_3d(D, (8, int(math.isqrt(N // 8)), int(math.isqrt(N // 8))))
        cos = torch.as_tensor(rope.cos, device="cuda")
        sin = torch.as_tensor(Q.signed_sin(rope.sin), device="cuda")
        scales = [(1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(bf16) for _ in range(2)]
        kw = dict(q_scale=scales[0], k_scale=scales[1], norm=True)
        got = Q.qkv_prep(qkv, H, D, cos, sin, **kw)
        torch.cuda.synchronize()
        want = Q.reference_qkv_prep(qkv, H, D, cos, sin, **kw)
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        tol = 2e-2 * max(1.0, max(float(w.float().abs().max()) for w in want))
        # times of the kernel and of its plain version alone, on tables
        # already folded (the fold is the same small torch ops on both routes)
        tabs = Q.fold_qk_tables(cos, sin, *scales, dtype=bf16)
        note("qkv_prep", site, err, tol,
             cuda_ms(lambda: Q._prep_cuda(qkv, tabs, H, D, D, True, 1e-6)),
             cuda_ms(lambda: Q._prep_plain(qkv, tabs, H, D, D, True, 1e-6)))

        # B1: peaked attention (score std ~3) so outputs are O(1)
        q, k, v = (torch.randn(B, H, N, D, generator=gen, device="cuda") for _ in range(3))
        q, k, v = (q * 1.7).to(bf16), (k * 1.7).to(bf16), v.to(bf16)
        o, lse = A.flash_attention(q, k, v, return_lse=True)
        torch.cuda.synchronize()
        o_ref, lse_ref = A.attention_reference(q, k, v, return_lse=True)
        err_o = float((o.float() - o_ref.float()).abs().max())
        err_l = float((lse - lse_ref).abs().max())
        tol_o = 1e-2 * max(1.0, float(o_ref.float().abs().max()))
        require(err_l <= 1e-3, f"flash_fwd lse at {site}: error {err_l} above 1e-3")
        log(f"  flash_fwd lse     {site}: max_abs_err {err_l:.3e} (tol 1.000e-03)")
        results["flash_fwd"]["by_site"].setdefault("lse_err", {})[site] = err_l
        note("flash_fwd", site, err_o, tol_o,
             cuda_ms(lambda: A.flash_attention(q, k, v)),
             cuda_ms(lambda: A.attention_reference(q, k, v), reps=3, warmup=1))
        del o_ref, lse_ref

        # B3: exact copy
        got = Q.attn_out_collect(o, D)
        torch.cuda.synchronize()
        err = float((got.float() - Q.reference_attn_out_collect(o, D).float()).abs().max())
        note("attn_out_collect", site, err, 0.0,
             cuda_ms(lambda: Q.attn_out_collect(o, D)),
             cuda_ms(lambda: Q.reference_attn_out_collect(o, D).contiguous()))
    record["kernel_checks"] = results
    return results


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


def build_random_model(fs, seed: int):
    import torch
    from dfot_tpu_torch.algorithms.dfot_video import build_model
    from dfot_tpu_torch.utils.weights import init_random_weights

    model = build_model(fs, token_io=True)
    init_random_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device="cuda", dtype=torch.bfloat16).eval()


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

    from dfot_tpu_torch.algorithms.dfot_video import flagship

    fs = flagship()
    spec = dataclasses.replace(
        fs.spec, channels=(32, 32, 64, 128), emb_channels=64, num_updown_blocks=(1, 1, 1),
        num_mid_blocks=1, num_heads=1,
    )
    fs = fs._replace(spec=spec, resolution=64)
    dcfg = dataclasses.replace(fs.dcfg, sampling_timesteps=3)
    model = build_random_model(fs, seed=2)
    ro = make_rollout(fs, model, dcfg)
    check_route(record, "small_window", "small 3-step window", WINDOW_REL_TOL, model,
                lambda: run_window(ro, fs, seed=3))


def kernel_class(name: str) -> str:
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "elementwise and copies"


def profile_window(record: dict, ro, fs) -> None:
    """One more window under torch.profiler: device time by kernel class
    and the share of the window's wall time the device sat idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_window(ro, fs, seed=6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_class, top = {}, []
    for e in kernels:
        ms = e.self_device_time_total / 1e3
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        top.append({"kernel": e.key[:160], "class": cls, "ms": ms, "calls": e.count})
    busy = sum(by_class.values()) / 1e3
    record["profile"] = {
        "wall_s": wall, "device_busy_s": busy, "idle_share": 1 - busy / wall if busy else None,
        "by_class_ms": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels": sorted(top, key=lambda r: -r["ms"])[:25],
    }
    if not busy:
        log("profiled window: the profiler saw no device time (not measured)")
        return
    log(f"profiled window: {wall:.3f} s wall, {busy:.3f} s device busy, "
        f"idle share {1 - busy / wall:.4f}")
    for cls, ms in record["profile"]["by_class_ms"].items():
        log(f"  {cls:28s} {ms:10.2f} ms  {ms / 1e3 / busy:7.2%}")


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
    from dfot_tpu_torch import ops
    from dfot_tpu_torch.ops import _cuda

    # stated numerics: fp32 matmuls and convolutions in full fp32 (the plain
    # attention's reference products); the model itself computes in bf16
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

    t0 = time.perf_counter()
    _cuda.library()
    record["build"] = {"seconds_total": time.perf_counter() - t0, **_cuda.build_info}
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
        model = build_random_model(fs, seed=0)
        log(f"flagship UViT3DPose: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
            f"parameters, seeded random bf16 weights ({time.perf_counter() - t0:.1f} s)")
        with torch.no_grad():
            x, nl, cond, cmask = flagship_inputs(
                fs, model, 2, torch.Generator(device="cuda").manual_seed(4))
            check_route(record, "forward", "full-width forward B=2 T=8 256px", FORWARD_REL_TOL,
                        model, lambda: model(x, nl, cond, cmask))
            del x, cond

        small_window_check(record)

        ro = make_rollout(fs, model, fs.dcfg)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        video = run_window(ro, fs, seed=5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        T = fs.spec.max_temporal_length
        expect = (1, T, fs.resolution, fs.resolution, fs.x_channels)
        record["window"] = {
            "wall_s": wall, "frames_per_s": (T - 1) / wall, "launches": launches,
            "denoiser_evals_b1": ro.stats["denoiser_evals_b1"], "shape": list(video.shape),
        }
        log(f"8-frame window, 50 DDIM steps, vanilla HG 4.0: {wall:.3f} s wall, "
            f"{(T - 1) / wall:.4f} generated frames/s; launches {launches}")
        require(tuple(video.shape) == expect, f"window shape {tuple(video.shape)} != {expect}")
        require(bool(torch.isfinite(video).all()), "window: non-finite output")
        for name, n in launches.items():
            require(n > 0, f"kernel {name} was not launched on the main path")

        profile_window(record, ro, fs)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
        return 1
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name, src, rep in KERNELS
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
