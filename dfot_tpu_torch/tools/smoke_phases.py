"""Run chosen phases of ``chip_smoke.py`` alone on the card.

    python3 -m dfot_tpu_torch.tools.smoke_phases [kernels] [17] [23] [24] [22] [21] [25] [26] [27]
        [--against FILE]

from the root of a checkout: builds the kernels, then runs the kernel
checks (``kernels``), phase 17 (``17``), phase 23 (``23``), phase 24
(``24``), phase 22 (``22``), phase 21 (``21``), phase 25 (``25``: ring
attention, the sequence-parallel window, a one-rank NCCL ``run(argv)``) and
phase 26 (``26``: tensor parallelism over gloo on the one card, the serving
export, the UCF-101 recipe, attention capture) and phase 27 (``27``: heads
wider than 256 lanes, the wide family's kernel checks, its ring entries and
the two wide-head paths) in that order, with the
smoke's settings (TF32 off, expandable allocator segments), and writes what
they record to ``chiprun_out/smoke_phases.json``. Phases 23 and 24 alone
track two clips of a seeded drifting image in place of the rollout's. A quicker loop than
the whole smoke while a phase is being written; the whole smoke is the
check of record.

With ``--against FILE`` (the ``smoke_phases.json`` of an earlier run, such
as a parent tree's in the same call) it also prints this run's kernel times
against that run's, site by site, warm and cold, with their ratios: the wide
B4 and B5 (and the wide ring's dq and dkv chains) first, then a line a kernel
for the others (the least and the largest ratio over its sites), and
records them under ``against`` in its own JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def drifting_clips():
    """Two 16-frame clips (1, 16, 256, 256, 3) of a seeded random image
    moving 2 px a frame."""
    import torch

    base = torch.rand(1, 1, 256, 256, 3, generator=torch.Generator().manual_seed(240))
    video = torch.cat([torch.roll(base, 2 * t, dims=3) for t in range(32)], dim=1)
    return video[:, :16], video[:, 16:]


def versus(record: dict, against: Path) -> dict:
    """This run's kernel times against the run that wrote ``against``, for
    every kernel and site both timed (warm ``ms`` and ``cold_ms``), and the
    wide ring's chains; printed as the module docstring says."""
    theirs = json.loads(against.read_text())["record"]
    pairs = {}
    for group in ("kernel_checks", "wide_kernel_checks"):
        for name, mine in record.get(group, {}).items():
            other = theirs.get(group, {}).get(name, {}).get("by_site", {})
            for site, r in mine.get("by_site", {}).items():
                o = other.get(site)
                if o and r.get("ms") and o.get("ms"):
                    pairs[f"{name} {site}"] = (name, r, o)
    ring, ring_theirs = record.get("wide", {}).get("ring"), theirs.get("wide", {}).get("ring")
    if ring and ring_theirs:
        for chain in ("dq", "dkv"):
            pairs[f"wide ring {chain} chain {ring['site']}"] = (
                f"ring_{chain}_wide",
                {"ms": ring[f"{chain}_ms"], "cold_ms": ring[f"{chain}_cold_ms"]},
                {"ms": ring_theirs[f"{chain}_ms"], "cold_ms": ring_theirs[f"{chain}_cold_ms"]})
    out, by_kernel = {}, {}
    for key, (name, r, o) in pairs.items():
        row = {"ms": r["ms"], "against_ms": o["ms"], "ratio": r["ms"] / o["ms"],
               "cold_ms": r.get("cold_ms"), "against_cold_ms": o.get("cold_ms")}
        if row["cold_ms"] and row["against_cold_ms"]:
            row["cold_ratio"] = row["cold_ms"] / row["against_cold_ms"]
        out[key] = row
        if name in ("flash_bwd_dq_wide", "flash_bwd_dkv_wide", "ring_dq_wide", "ring_dkv_wide"):
            print(f"against: {key}: {row['ms']:.4f} ms against {row['against_ms']:.4f} "
                  f"({row['ratio']:.3f} x); cold {row.get('cold_ms')} against "
                  f"{row.get('against_cold_ms')} ({row.get('cold_ratio', float('nan')):.3f} x)",
                  flush=True)
        else:
            by_kernel.setdefault(name, []).append(row["ratio"])
    for name, ratios in by_kernel.items():
        print(f"against: {name}: {len(ratios)} sites, ratios {min(ratios):.3f}-{max(ratios):.3f}",
              flush=True)
    return out


def main(argv) -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as CS
    from dfot_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    _cuda.library()
    against = Path(argv[argv.index("--against") + 1]) if "--against" in argv else None
    record, launches, results = {"nvidia_smi": smi}, {}, {}
    try:
        for phase, run in (("kernels", lambda: results.update(CS.check_kernels(record))),
                           ("17", lambda: launches.update(cli=CS.run_cli_validation(record, smi))),
                           ("23", lambda: launches.update(CS.run_metric_paths(
                               record, drifting_clips(), "a seeded drifting image"))),
                           ("24", lambda: launches.update(CS.run_a15c_paths(
                               record, drifting_clips(), "a seeded drifting image"))),
                           ("22", lambda: launches.update(CS.run_slice16_paths(record))),
                           ("21", lambda: launches.update(CS.run_slice15_paths(record, smi))),
                           ("25", lambda: launches.update(CS.run_ring_paths(record, {}))),
                           ("26", lambda: launches.update(CS.run_slice20_paths(record))),
                           ("27", lambda: launches.update(CS.run_wide_paths(record, results)))):
            if phase in argv:
                t0 = time.perf_counter()
                run()
                print(f"{phase}: {time.perf_counter() - t0:.1f} s", flush=True)
        if against is not None:
            record["against"] = {"file": str(against), "pairs": versus(record, against)}
    finally:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "smoke_phases.json").write_text(
            json.dumps({"record": record, "launches": launches}, indent=1, default=str))
        CS.write_timeline()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
