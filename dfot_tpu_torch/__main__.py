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
(``training``, ``validation``, ``test``) on the card.

Several processes: ``torchrun --nproc_per_node=N -m dfot_tpu_torch ...``
(or a SLURM job of several tasks) makes the process group before anything
touches the card (``parallel.multihost.initialize``; NCCL, each process on
its ``LOCAL_RANK``'s card), rank 0's clock stamps the one run directory,
and rank 0 registers the run; a one-process ``torchrun`` launch makes a
one-rank group. The group is taken down when the run ends. Cluster dispatch
(``cluster=``) is not ported and raises ``NotImplementedError`` naming
ROADMAP.md A16b. The XLA compilation cache of ``main.py`` has no
counterpart here.
"""

from __future__ import annotations

import os
import sys
import time
from datetime import datetime

__all__ = ["run"]


def run(argv, device=None):
    """Compose the config from ``argv`` and run its tasks on ``device``
    (None: the card; ``"cpu"``: a multi-process launch then runs under gloo).
    Returns the experiment, closed."""
    import torch.distributed as dist

    from .parallel import multihost

    made_group = not dist.is_initialized()
    multihost.initialize(device=device)
    made_group = made_group and dist.is_initialized()
    try:
        if dist.is_initialized():
            multihost.rank_zero_print(f"process group: backend {dist.get_backend()}, "
                                      f"world size {dist.get_world_size()}")
        return _run(argv, device)
    finally:
        if made_group:
            dist.destroy_process_group()


def _run(argv, device):
    from .config import load_config
    from .experiments import build_experiment
    from .parallel import multihost
    from .training.checkpoint import register_run, resolve_run_checkpoint

    t0 = time.perf_counter()
    cfg = load_config(argv)
    compose_s = time.perf_counter() - t0
    if "name" not in cfg:
        raise ValueError("must specify a name for the run with command line argument '+name=[name]'")
    if cfg.get("cluster") is not None:
        raise NotImplementedError(
            "cluster dispatch is not ported yet (ROADMAP.md queue A16b)")

    choices = cfg.get("_choices", {})
    # one run directory for every process: rank 0's clock, to the second
    now = datetime.now()
    if multihost.world_size() > 1:
        now = datetime.fromtimestamp(multihost.broadcast_from_zero(now.timestamp()))
    stamp = now.strftime("%Y-%m-%d/%H-%M-%S")
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
        multihost.rank_zero_print(f"resolved load={load} -> {resolved}")
        load = resolved
    if multihost.is_rank_zero():
        run_id = register_run(str(cfg.output_dir), str(cfg.name), output_dir)
        print(f"run id: {run_id} (load={run_id} resumes this run's checkpoints)")
    multihost.barrier("registry")  # rank 0 has registered the run

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
