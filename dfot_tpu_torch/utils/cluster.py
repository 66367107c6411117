"""Cluster job submission (SLURM).

Port of ``dfot_tpu/utils/cluster.py`` (reference utils/cluster_utils.py:
20-48): renders the cluster config's ``launch_template`` with the run
parameters, writes it under ``{output_dir}/slurm_logs/<name>_<stamp>/``,
submits it with ``submit_command`` (``sbatch`` by default), and points
``slurm_logs/latest`` at the newest log directory. ``python -m
dfot_tpu_torch cluster=<name> ...`` on a login node submits the same
command line as ``python -m dfot_tpu_torch ...`` (``__main__.py``).
"""

from __future__ import annotations

import os
import subprocess
from datetime import datetime
from typing import Dict, Optional

__all__ = ["submit_cluster_job", "is_compute_node"]


def is_compute_node() -> bool:
    """True when already running inside a SLURM allocation."""
    return bool(os.environ.get("SLURM_JOB_ID"))


def submit_cluster_job(
    cluster_cfg,
    name: str,
    command: str,
    output_dir: str = "outputs",
    extra_params: Optional[Dict[str, str]] = None,
) -> str:
    """Render + sbatch the launch template. Returns the script path."""
    params = dict(cluster_cfg.get("params", {}) or {})
    params.update(extra_params or {})
    params.setdefault("name", name)
    params.setdefault("command", command)

    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_dir = os.path.join(output_dir, "slurm_logs", f"{name}_{stamp}")
    os.makedirs(log_dir, exist_ok=True)
    params.setdefault("log_dir", log_dir)

    template = cluster_cfg.launch_template
    script = template.format(**params)
    script_path = os.path.join(log_dir, "launch.sh")
    with open(script_path, "w") as f:
        f.write(script)

    latest = os.path.join(output_dir, "slurm_logs", "latest")
    try:
        if os.path.islink(latest):
            os.unlink(latest)
        os.symlink(os.path.abspath(log_dir), latest)
    except OSError:
        pass

    submitter = cluster_cfg.get("submit_command", "sbatch")
    subprocess.run([submitter, script_path], check=True)
    return script_path
