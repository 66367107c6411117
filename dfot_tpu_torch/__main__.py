"""Command-line entry point of the port: ``python -m dfot_tpu_torch``.

The JAX package's ``main.py`` surface::

    python -m dfot_tpu_torch +name=re10k dataset=realestate10k_mini \
        algorithm=dfot_video_pose experiment=video_generation @diffusion/continuous \
        experiment.tasks=[validation] load=pretrained:DFoT_RE10K.ckpt \
        ++algorithm.tasks.prediction.history_guidance.name=vanilla \
        ++algorithm.tasks.prediction.history_guidance.guidance_scale=4.0

composes the repository's ``configurations/`` (``+name=`` is required), makes
the run directory ``output_dir/<experiment>/<task>/<dataset>/<algorithm>/<stamp>``,
resolves ``load=<run id or name>`` through the run registry
(``output_dir/registry.jsonl``) to that run's newest checkpoint, registers
this run there, prints its id and runs each task of ``experiment.tasks``
(``training``, ``validation``, ``test``) on the card. Not ported, and so
raising ``NotImplementedError`` with their ROADMAP.md queue item: cluster
dispatch (``cluster=``) and multi-process launches (A16). The XLA
compilation cache of ``main.py`` has no counterpart here.
"""

from __future__ import annotations

import os
import sys
import time
from datetime import datetime

__all__ = ["run"]


def _multiprocess_launch() -> bool:
    """True when the environment says this is one of several processes."""
    for var in ("WORLD_SIZE", "SLURM_NTASKS"):
        try:
            if int(os.environ.get(var, "1")) > 1:
                return True
        except ValueError:
            pass
    return bool(os.environ.get("COORDINATOR_ADDRESS") or os.environ.get("JAX_COORDINATOR_ADDRESS"))


def run(argv, device=None):
    """Compose the config from ``argv`` and run its tasks on ``device``
    (None: the card). Returns the experiment, closed."""
    from .config import load_config
    from .experiments import build_experiment
    from .training.checkpoint import register_run, resolve_run_checkpoint

    if _multiprocess_launch():
        raise NotImplementedError(
            "multi-process launches are not ported yet (ROADMAP.md queue A16)")
    t0 = time.perf_counter()
    cfg = load_config(argv)
    compose_s = time.perf_counter() - t0
    if "name" not in cfg:
        raise ValueError("must specify a name for the run with command line argument '+name=[name]'")
    if cfg.get("cluster") is not None:
        raise NotImplementedError(
            "cluster dispatch is not ported yet (ROADMAP.md queue A16)")

    choices = cfg.get("_choices", {})
    stamp = datetime.now().strftime("%Y-%m-%d/%H-%M-%S")
    output_dir = os.path.join(
        str(cfg.output_dir),
        str(choices.get("experiment", "exp")),
        str(cfg.experiment.tasks[0]),
        str(choices.get("dataset", "data")),
        str(choices.get("algorithm", "algo")),
        stamp,
    )
    # load= is resolved before this run is registered: registered first,
    # this checkpoint-less run would be the newest match for its own name
    load = cfg.get("load") or cfg.get("resume")
    if load and not os.path.exists(str(load)) and not str(load).startswith("pretrained:"):
        resolved = resolve_run_checkpoint(str(load), str(cfg.output_dir))
        if resolved is None:
            raise FileNotFoundError(
                f"load={load}: no such file or directory, and no run of that id or name with a "
                f"checkpoint in {os.path.join(str(cfg.output_dir), 'registry.jsonl')}")
        print(f"resolved load={load} -> {resolved}")
        load = resolved
    run_id = register_run(str(cfg.output_dir), str(cfg.name), output_dir)
    print(f"run id: {run_id} (load={run_id} resumes this run's checkpoints)")

    experiment = build_experiment(cfg, output_dir, load, device)
    experiment.timings["compose_s"] = compose_s
    try:
        for task in cfg.experiment.tasks:
            experiment.exec_task(task)
    finally:
        experiment.close()
    return experiment


if __name__ == "__main__":
    run(sys.argv[1:])
