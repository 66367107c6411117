"""Process-group utilities.

Port of ``dfot_tpu/parallel/multihost.py``: the launch is read from the
environment only (nothing here touches CUDA before the group exists), and
``torch.distributed`` takes the place of ``jax.distributed``:

- a ``torchrun`` launch sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and
  ``MASTER_ADDR``/``MASTER_PORT`` (the group's rendezvous);
- a SLURM job of several tasks sets ``SLURM_NTASKS``, ``SLURM_PROCID`` and
  ``SLURM_LOCALID``, with the rendezvous in ``MASTER_ADDR``/``MASTER_PORT``
  or ``COORDINATOR_ADDRESS`` (``host:port``);
- ``COORDINATOR_ADDRESS`` with ``WORLD_SIZE`` and ``RANK`` names the
  rendezvous explicitly.

:func:`initialize` makes the group (NCCL on the card, pinning
``LOCAL_RANK``'s card; gloo for the CPU). It is a no-op in a process that
no launcher started, and idempotent. A launch whose environment is
incomplete raises: nothing drops to one process when the environment says
there are several, and a NCCL group that fails to form raises too.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "initialize",
    "detect_multiprocess_env",
    "launch_env",
    "is_rank_zero",
    "rank_zero_print",
    "barrier",
    "gather_for_metrics",
    "broadcast_from_zero",
    "world_size",
    "rank",
]


class Launch(NamedTuple):
    world: int
    rank: int
    local_rank: int
    init_method: str  # the rendezvous, "tcp://host:port"


def _int_env(name: str) -> Optional[int]:
    value = os.environ.get(name)
    if value is None or value == "":
        return None
    try:
        return int(value)
    except ValueError:
        raise ValueError(f"{name}={value!r} is not an integer") from None


def detect_multiprocess_env() -> bool:
    """True when the environment says this is one of several processes,
    read without touching CUDA or any process group."""
    if os.environ.get("COORDINATOR_ADDRESS"):
        return True
    return any((_int_env(v) or 1) > 1 for v in ("WORLD_SIZE", "SLURM_NTASKS"))


def launch_env() -> Optional[Launch]:
    """The launch the environment describes, or None for a process no
    launcher started. A ``torchrun`` launch of one process is a launch (a
    one-rank group); a SLURM job of one task is not."""
    torchrun = _int_env("WORLD_SIZE") is not None
    slurm = (_int_env("SLURM_NTASKS") or 1) > 1
    if not (torchrun or slurm or os.environ.get("COORDINATOR_ADDRESS")):
        return None
    if torchrun or not slurm:
        names = ("WORLD_SIZE", "RANK", "LOCAL_RANK")
    else:
        names = ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID")
    world, rank, local = (_int_env(n) for n in names)
    if world is None or rank is None:
        raise ValueError(
            f"a multi-process launch needs {names[0]} and {names[1]}; the environment has "
            f"{names[0]}={os.environ.get(names[0])!r} {names[1]}={os.environ.get(names[1])!r}")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    address = os.environ.get("COORDINATOR_ADDRESS")
    if not address:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not host or not port:
            raise ValueError(
                "a multi-process launch needs its rendezvous: MASTER_ADDR and MASTER_PORT, "
                "or COORDINATOR_ADDRESS=host:port")
        address = f"{host}:{port}"
    return Launch(world, rank, rank if local is None else local, f"tcp://{address}")


def initialize(device=None) -> None:
    """Make the process group of the launch the environment describes
    (:func:`launch_env`), before anything touches the card; a no-op in a
    process that no launcher started. ``device``: None or a CUDA device
    means NCCL, with ``LOCAL_RANK``'s card made the current device; ``"cpu"``
    means gloo. Idempotent: a second call finds the group and returns."""
    if dist.is_initialized():
        return
    env = launch_env()
    if env is None:
        return
    on_card = device is None or torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(env.local_rank)
    dist.init_process_group("nccl" if on_card else "gloo", init_method=env.init_method,
                            world_size=env.world, rank=env.rank)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_rank_zero() -> bool:
    return rank() == 0


def rank_zero_print(*args, **kwargs) -> None:
    if is_rank_zero():
        print(*args, **kwargs)


def barrier(name: str = "barrier") -> None:
    """Every process waits here for the others (``name`` is for the
    reader: torch's barrier takes none)."""
    if dist.is_initialized():
        dist.barrier()


def _comm_device() -> torch.device:
    return torch.device("cuda") if dist.get_backend() == "nccl" else torch.device("cpu")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def gather_for_metrics(tree: Any) -> Any:
    """Every process's arrays concatenated on the leading axis in rank
    order, on every process (a leaf's shape must be the same on every rank).
    numpy leaves come back as numpy, tensors as tensors on their device."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return _tree_map(lambda x: x if torch.is_tensor(x) else np.asarray(x), tree)

    def gather(x):
        is_tensor = torch.is_tensor(x)
        t = x if is_tensor else torch.from_numpy(np.ascontiguousarray(x))
        home = t.device
        t = t.to(_comm_device()).contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t)
        out = torch.cat([p.reshape((-1,) + tuple(t.shape[1:])) for p in parts], dim=0)
        return out.to(home) if is_tensor else out.cpu().numpy()

    return _tree_map(gather, tree)


def broadcast_from_zero(tree: Any) -> Any:
    """Process 0's value of any picklable ``tree``, on every process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree
    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]
