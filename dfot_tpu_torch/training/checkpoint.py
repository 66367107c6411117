"""Checkpoint save and resume: step directories, top-k pruning, the run registry.

Port of ``dfot_tpu/training/checkpoint.py`` (:40-172) without orbax:
``{ckpt_dir}/checkpoint_<step>/`` holds one ``torch.save`` file,
``state.pt``, of :meth:`TrainState.state_dict` (``params``: the model's
state dict under the upstream names, ``ema_params``, ``opt_state`` and
``step``), which loads with ``weights_only=True``. A directory is written
under a temporary name and renamed when complete, so the step pattern only
ever matches complete checkpoints: pruning to the newest ``save_top_k``
never touches one in flight, and a crash mid-write leaves the newest
finished checkpoint intact.

The train state is updated in place by every step, so a save copies it to
the host before it returns; with ``block=False`` only the write to disk
runs in a background thread (at most one at a time, as the JAX package's
async checkpointer). Each save returns its record: the path, the bytes and
the seconds of the host copy and of the write (filled in when it ends).

The run registry is the JAX package's ``registry.jsonl`` (one
``{"run_id", "name", "output_dir"}`` object a line), so either package
resolves ``load=<run id or name>`` to runs the other registered.

Under several processes every process calls :func:`save_checkpoint` (an
FSDP2 model's sharded tensors are gathered whole, a collective) and the
process of rank 0 alone writes and prunes.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ..parallel.mesh import full_tensors
from ..parallel.multihost import is_rank_zero

__all__ = [
    "CHECKPOINT_FILE", "save_checkpoint", "wait_for_checkpoints", "prune_checkpoints",
    "latest_checkpoint", "restore_checkpoint", "register_run", "resolve_run_checkpoint",
]

CHECKPOINT_FILE = "state.pt"
_STEP_RE = re.compile(r"checkpoint_(\d+)$")
_in_flight: Optional[threading.Thread] = None
_failure: List[BaseException] = []


def _steps(ckpt_dir: str) -> List[int]:
    return sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                  if (m := _STEP_RE.search(name)))


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` complete checkpoint directories."""
    for old in _steps(ckpt_dir)[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"checkpoint_{old}"), ignore_errors=True)


def _to_host(obj):
    """A copy of ``obj`` with every tensor on the host (a new tensor even
    where it already was there: the train state changes in place)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return 0


def _write(payload: Dict[str, Any], path: str, record: Dict[str, Any]) -> None:
    """Write ``payload`` to ``path``/state.pt through a temporary directory."""
    t0 = time.perf_counter()
    tmp = f"{path}.partial"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, CHECKPOINT_FILE))
    shutil.rmtree(path, ignore_errors=True)  # a save of the same step replaces it
    os.replace(tmp, path)
    record["write_s"] = time.perf_counter() - t0


def save_checkpoint(ckpt_dir: str, step: int, state, save_top_k: int = 3,
                    block: bool = True) -> Dict[str, Any]:
    """Save ``state.state_dict()`` under ``checkpoint_<step>/``; returns
    ``{"step", "path", "bytes", "block", "snapshot_s", "write_s"}``
    (``write_s`` None until the write ends). The host copy is made before
    this returns. ``block=False`` writes
    in a background thread after the previous save's write has ended and
    the directories have been pruned (the disk briefly holds ``save_top_k
    + 1``); ``block=True`` writes, then prunes."""
    global _in_flight
    path = os.path.abspath(os.path.join(ckpt_dir, f"checkpoint_{step}"))
    wait_for_checkpoints()  # at most one save in flight
    t0 = time.perf_counter()
    payload = _to_host(full_tensors(state.state_dict()))
    record = {"step": int(step), "path": path, "bytes": _nbytes(payload), "block": block,
              "snapshot_s": time.perf_counter() - t0, "write_s": None}
    if not is_rank_zero():
        return record
    os.makedirs(ckpt_dir, exist_ok=True)
    if block:
        _write(payload, path, record)
        if save_top_k and save_top_k > 0:
            prune_checkpoints(ckpt_dir, save_top_k)
        return record
    if save_top_k and save_top_k > 0:
        prune_checkpoints(ckpt_dir, save_top_k)

    def work():
        try:
            _write(payload, path, record)
        except BaseException as e:  # raised by the next wait
            _failure.append(e)

    _in_flight = threading.Thread(target=work, name=f"checkpoint_{step}", daemon=True)
    _in_flight.start()
    return record


def wait_for_checkpoints() -> None:
    """Block until the save in flight, if any, is on disk; raise its error."""
    global _in_flight
    if _in_flight is not None:
        _in_flight.join()
        _in_flight = None
    if _failure:
        raise RuntimeError("a background checkpoint write failed") from _failure.pop()


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The complete checkpoint directory of the highest step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    if not steps:
        return None
    return os.path.abspath(os.path.join(ckpt_dir, f"checkpoint_{steps[-1]}"))


def restore_checkpoint(path: str) -> Dict[str, Any]:
    """The saved state dict of a ``checkpoint_<step>`` directory, its
    tensors on the host, mapping the file (its pages are read as the
    tensors are used)."""
    file = os.path.join(os.path.abspath(path), CHECKPOINT_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"{path} is not a checkpoint directory: no {CHECKPOINT_FILE}")
    return torch.load(file, map_location="cpu", weights_only=True, mmap=True)


def register_run(output_root: str, name: str, output_dir: str) -> str:
    """Append this run to ``{output_root}/registry.jsonl``; returns its id."""
    run_id = hashlib.sha1(f"{name}|{output_dir}|{time.time_ns()}".encode()).hexdigest()[:8]
    os.makedirs(output_root, exist_ok=True)
    with open(os.path.join(output_root, "registry.jsonl"), "a") as f:
        f.write(json.dumps({"run_id": run_id, "name": name,
                            "output_dir": os.path.abspath(output_dir)}) + "\n")
    return run_id


def resolve_run_checkpoint(load: str, output_root: str) -> Optional[str]:
    """``load=<run id or name>`` -> that run's latest checkpoint directory
    (the last registered match wins); None when no run matches."""
    reg = os.path.join(output_root, "registry.jsonl")
    if not os.path.exists(reg):
        return None
    match = None
    with open(reg) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if load in (rec.get("run_id"), rec.get("name")):
                match = rec
    if match is None:
        return None
    return latest_checkpoint(os.path.join(match["output_dir"], "checkpoints"))
