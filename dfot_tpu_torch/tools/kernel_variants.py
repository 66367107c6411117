"""Time the committed designs of kernels B9, B7 and the wide B4 and B5
against the ones they were chosen over, on one NVIDIA Hopper GPU.

Run from the root of a checkout: ``python3 -m dfot_tpu_torch.tools.kernel_variants``.
It builds ``variants_ln_modulate.cu``, ``variants_attn_out_scatter.cu`` and
``variants_flash_wide.cu`` (each includes its committed source under
``csrc/`` and adds the other design) into a library of its own, then at the
shapes of the paths:

- B9 (``ln_modulate`` backward, width-exact): two shuffle rounds, (sum x,
  sum x^2) then (sum gl, sum gl * yn) (committed), against one round of four
  sums with mean(gl * yn) = rstd * (mean(gl * x) - mu * mean(gl));
- B7 (``attn_out_scatter``): threads walking the block's output slots in
  token order (committed) against head order;
- the wide B4 and B5 (``flash_wide.cu``) at the two wide sites, W (the base
  U-ViT's level 3 at 2 heads of 512, the train step's B = 1) and X (K600
  @DiT/XL at 4 heads of 288 padded to 320, B = 8): the slice width the grid
  rule picks (committed: 256 lanes where that grid fits one wave and has
  more blocks, else 512) against the other one; and a block's two score
  products split one a consumer (committed: consumer 0 contracts S and
  consumer 1 dP over every atom, the tiles swapped) against both split by
  atoms, each consumer contracting S and dP over its share and the partial
  tiles exchanged and added; at W, B4 on 256-lane slices (committed) against
  one 512-lane slice with the keys split between the two blocks of a
  cluster, their fp32 partials added in a fixed order through distributed
  shared memory.

Each variant is checked against the plain version first (B7 bit for bit, B9
within the bounds of ``chip_smoke.py``, B4 and B5 within theirs: 2e-2 *
max(1, |ref|max) and 1e-2 relative L2), then the two are timed in turns
(committed, other, other, committed), warm and with a cold L2, with
``chip_smoke.py``'s timers. Both are launched the same way, through their C
entries on outputs allocated once, so that the wrapper's checks and its
fresh output each call weigh on neither. One JSON object goes to standard output and to
``chiprun_out/kernel_variants.json``, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
SOURCES = ("variants_ln_modulate.cu", "variants_attn_out_scatter.cu", "variants_flash_wide.cu")
# B9 at K600 @DiT/XL's, DiT/B's and the factorized DiT's shapes
LN_SITES = (("xl", (8, 1280, 1152)), ("dit_b", (8, 1024, 768)), ("factorized", (128, 16, 384)))
# B7 at (B, N, H, d, dp): the flagship's levels 2 and 3 (train step, B = 1),
# K600 @DiT/XL, the base widths' level 3 (B = 1) and a head of 160 padded to 256
SCATTER_SITES = (("F level 2", (1, 8192, 9, 64, 64)), ("F level 3", (1, 2048, 9, 128, 128)),
                 ("xl", (8, 1280, 16, 72, 128)), ("base level 3", (1, 2048, 4, 256, 256)),
                 ("padded", (1, 2048, 4, 160, 256)))
# the wide B4 and B5 at (B, H, N, d, padded d): W at the train step's batch, X
WIDE_SITES = (("W", (1, 2, 2048, 512, 512)), ("X", (8, 4, 1280, 288, 320)))


def build(out_dir: Path):
    """The variants' library and nvcc's -Xptxas -v report."""
    from dfot_tpu_torch.ops import _cuda

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libdfot_variants.so"
    proc = subprocess.run(
        [_cuda._nvcc(), "-gencode", _cuda._ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v", "-o", str(lib), *(str(HERE / s) for s in SOURCES)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    cdll = ctypes.CDLL(str(lib))
    cdll.variant_ln_modulate_bwd_one_round.argtypes = (P, P, P, P, P, L, I, F, I, I, L, P)
    cdll.variant_attn_out_scatter_head_major.argtypes = (P, P, I, I, I, I, I, I, I, P)
    cdll.variant_flash_bwd_wide_slices.argtypes = (I, P, P, P, P, P, P, P, P, I, I, I, I, F, I,
                                                   I, P)
    cdll.variant_flash_bwd_wide_atoms.argtypes = (I, P, P, P, P, P, P, P, P, I, I, I, I, F, P)
    cdll.variant_flash_bwd_dq_wide_key_split.argtypes = (P, P, P, P, P, P, P, I, I, I, I, F, P)
    for fn in (cdll.variant_ln_modulate_bwd_one_round, cdll.variant_attn_out_scatter_head_major,
               cdll.variant_flash_bwd_wide_slices, cdll.variant_flash_bwd_wide_atoms,
               cdll.variant_flash_bwd_dq_wide_key_split):
        fn.restype = ctypes.c_int
    return cdll, proc.stdout + proc.stderr


def in_turns(first, second) -> dict:
    """``first``, ``second``, ``second``, ``first``, each warm and cold."""
    import chip_smoke as S

    runs = {"committed": [], "other": []}
    for name, fn in (("committed", first), ("other", second), ("other", second),
                     ("committed", first)):
        runs[name].append({"ms": S.cuda_ms(fn), "cold_ms": S.cold_ms(fn)})
    return runs


def wide_slices(lib, gen, stream) -> dict:
    """The wide B4 and B5 at :data:`WIDE_SITES` as committed (the C
    entries), on the slice width the grid rule did not pick and with both
    score products split by atoms (the variants), each checked against the
    plain version, then timed in turns against the committed kernel."""
    import math

    import torch
    import torch.nn.functional as F

    import chip_smoke as S
    from dfot_tpu_torch.ops import _cuda
    from dfot_tpu_torch.ops import attention as A

    def heads(B, H, N, d, dp, scale=1.0):
        x = scale * torch.randn(B, H, N, d, generator=gen, device="cuda")
        return F.pad(x, (0, dp - d)).to(torch.bfloat16)

    out = {}
    for label, (B, H, N, d, dp) in WIDE_SITES:
        q, k = (heads(B, H, N, d, dp, 1.7) for _ in range(2))
        v, do = (heads(B, H, N, d, dp) for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        o, lse = A.attention_reference(q, k, v, False, scale, return_lse=True)
        delta = (do.float() * o.float()).sum(-1, keepdim=True)
        wants = {"dq": (A._dq_plain(q, k, v, do, lse, delta, False, scale),),
                 "dkv": A._dkv_plain(q, k, v, do, lse, delta, False, scale)}
        ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
               delta.data_ptr())
        for kernel, kind in (("dq", 1), ("dkv", 2)):
            plan = A.flash_plan(kernel, B * H, N, dp, d)
            other_atoms = 8 if plan["slice_atoms"] == 4 else 4
            n_out = len(wants[kernel])
            # two outputs each (dq's second unused)
            # the key split: B4 at W
            split_keys = kernel == "dq" and label == "W"
            names = ("committed", "other", "atoms") + (("key_split",) if split_keys else ())
            outs = {name: (torch.empty_like(q), torch.empty_like(q)) for name in names}
            ptrs = {name: [t.data_ptr() for t in ts] for name, ts in outs.items()}
            plan_args = (B * H, N, dp, plan["lanes"], plan["stages"], plan["smem_bytes"],
                         int(plan["resident"]), scale, 0)
            entry = (_cuda.library().dfot_flash_bwd_dq_wide if kind == 1
                     else _cuda.library().dfot_flash_bwd_dkv_wide)
            committed = lambda: _cuda.check(  # noqa: E731
                entry(*ins, *ptrs["committed"][:n_out], *plan_args, stream()),
                f"{kernel} committed")
            other = lambda: _cuda.check(lib.variant_flash_bwd_wide_slices(  # noqa: E731
                kind, *ins, *ptrs["other"], B * H, N, dp, plan["lanes"], scale, 0, other_atoms,
                stream()), f"{kernel} other")
            atoms = lambda: _cuda.check(lib.variant_flash_bwd_wide_atoms(  # noqa: E731
                kind, *ins, *ptrs["atoms"], B * H, N, dp, plan["lanes"], scale, stream()),
                f"{kernel} atoms")
            key_split = None
            if split_keys:
                key_split = lambda: _cuda.check(  # noqa: E731
                    lib.variant_flash_bwd_dq_wide_key_split(
                        *ins, ptrs["key_split"][0], B * H, N, dp, plan["lanes"], scale, stream()),
                    "dq key split")
            for fn in (committed, other, atoms, key_split):
                if fn is not None:
                    fn()
            rows = {}
            for name, got in outs.items():
                rows[name] = S.readings(list(zip(("out0", "out1"), got, wants[kernel])), 2e-2)
                S.require(all(e <= t and l2 <= 1e-2 for _, e, t, l2 in rows[name]),
                          f"wide {kernel} {name} at {label}: outside the bounds {rows[name]}")
            key = f"{kernel} {label}"
            out[key] = {"slice_lanes": {"committed": 64 * plan["slice_atoms"],
                                        "other": 64 * other_atoms},
                        "readings": rows, **in_turns(committed, other),
                        "split_by_atoms": in_turns(committed, atoms)}
            if key_split is not None:
                out[key]["key_split"] = in_turns(committed, key_split)
            print(f"wide {key}: {out[key]}", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    from dfot_tpu_torch.ops import _cuda, ln_modulate as Ln, qkv_prep as Q

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib, ptxas = build(ROOT / "build" / "dfot_tpu_torch" / "variants")
    record = {"nvidia_smi": smi, "build_s": time.perf_counter() - t0, "b9": {}, "b7": {},
              "wide_slices": {}}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_variants_nvcc.log").write_text(ptxas)
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = lambda: _cuda.stream_handle(torch.device("cuda"))  # noqa: E731
    bf16 = torch.bfloat16

    for label, shape in LN_SITES:
        x = (2 * torch.randn(shape, generator=gen, device="cuda") + 0.5).to(bf16)
        scale = (0.3 * torch.randn(shape, generator=gen, device="cuda")).to(bf16)
        g = torch.randn(shape, generator=gen, device="cuda").to(bf16)
        tokens, C = x.numel() // shape[-1], shape[-1]
        plan = Ln.ln_modulate_bwd_plan(tokens, C, bf16)
        outs = {name: (torch.empty_like(x), torch.empty_like(x)) for name in ("committed", "other")}

        def operands(name):
            dx, ds = outs[name]
            return (x.data_ptr(), scale.data_ptr(), g.data_ptr(), dx.data_ptr(), ds.data_ptr(),
                    tokens, C, 1e-6)

        plan_args = (plan["lanes"], plan["block_tokens"], plan["grid"])
        committed = lambda: _cuda.check(_cuda.library().dfot_ln_modulate_bwd(  # noqa: E731
            *operands("committed"), 0, *plan_args, stream()), "two rounds")
        other = lambda: _cuda.check(lib.variant_ln_modulate_bwd_one_round(  # noqa: E731
            *operands("other"), *plan_args, stream()), "one round")
        committed()
        other()
        want = Ln.reference_ln_modulate_bwd(x, scale, g)
        rows = {}
        for name, (gdx, gds) in outs.items():
            rows[name] = S.readings((("dx", gdx, want[0]), ("dscale", gds, want[1])), 2e-2)
            S.require(all(e <= t and l2 <= S.KERNEL_REL_L2_TOL for _, e, t, l2 in rows[name]),
                      f"B9 {name} at {label}: outside the bounds {rows[name]}")
        record["b9"][label] = {"readings": rows, **in_turns(committed, other)}
        print(f"B9 {label}: {record['b9'][label]}", flush=True)

    for label, (B, N, H, d, dp) in SCATTER_SITES:
        g = torch.randn(B, N, H * d, generator=gen, device="cuda").to(bf16)
        plan = Q.scatter_plan(B, H, N, d, dp)
        outs = {name: torch.empty(B, H, N, dp, device="cuda", dtype=bf16)
                for name in ("committed", "other")}

        def launcher(entry, name):
            args = (g.data_ptr(), outs[name].data_ptr(), B, H, N, d, dp, plan["tile"],
                    plan["grid"][0])
            return lambda: _cuda.check(entry(*args, stream()), name)

        committed = launcher(_cuda.library().dfot_attn_out_scatter, "committed")
        other = launcher(lib.variant_attn_out_scatter_head_major, "other")
        committed()
        other()
        want = Q.reference_attn_out_scatter(g, H, d, dp)
        S.require(all(torch.equal(out, want) for out in outs.values()),
                  f"B7 at {label}: not an exact copy")
        record["b7"][label] = in_turns(committed, other)
        print(f"B7 {label}: {record['b7'][label]}", flush=True)

    record["wide_slices"] = wide_slices(lib, gen, stream)
    (ROOT / "chiprun_out" / "kernel_variants.json").write_text(json.dumps(record, indent=1))
    print(smi)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
