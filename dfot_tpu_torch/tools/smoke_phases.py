"""Run chosen phases of ``chip_smoke.py`` alone on the card.

    python3 -m dfot_tpu_torch.tools.smoke_phases [kernels] [17] [23] [24] [22] [21] [25] [26]

from the root of a checkout: builds the kernels, then runs the kernel
checks (``kernels``), phase 17 (``17``), phase 23 (``23``), phase 24
(``24``), phase 22 (``22``), phase 21 (``21``), phase 25 (``25``: ring
attention, the sequence-parallel window, a one-rank NCCL ``run(argv)``) and
phase 26 (``26``: tensor parallelism over gloo on the one card, the serving
export, the UCF-101 recipe, attention capture) in that order, with the
smoke's settings (TF32 off, expandable allocator segments), and writes what
they record to ``chiprun_out/smoke_phases.json``. Phases 23 and 24 alone
track two clips of a seeded drifting image in place of the rollout's. A quicker loop than
the whole smoke while a phase is being written; the whole smoke is the
check of record.
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
    record, launches = {"nvidia_smi": smi}, {}
    try:
        for phase, run in (("kernels", lambda: CS.check_kernels(record)),
                           ("17", lambda: launches.update(cli=CS.run_cli_validation(record, smi))),
                           ("23", lambda: launches.update(CS.run_metric_paths(
                               record, drifting_clips(), "a seeded drifting image"))),
                           ("24", lambda: launches.update(CS.run_a15c_paths(
                               record, drifting_clips(), "a seeded drifting image"))),
                           ("22", lambda: launches.update(CS.run_slice16_paths(record))),
                           ("21", lambda: launches.update(CS.run_slice15_paths(record, smi))),
                           ("25", lambda: launches.update(CS.run_ring_paths(record, {}))),
                           ("26", lambda: launches.update(CS.run_slice20_paths(record)))):
            if phase in argv:
                t0 = time.perf_counter()
                run()
                print(f"{phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "smoke_phases.json").write_text(
            json.dumps({"record": record, "launches": launches}, indent=1, default=str))
        CS.write_timeline()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
