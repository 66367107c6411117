"""The process mesh: data parallelism, FSDP, and the ring's tensor axis.

Port of ``dfot_tpu/parallel/mesh.py``. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the world's processes,
one per card, with the axes (``data``, ``fsdp``[, ``tensor``]):

- ``data``: the batch is split over it (:func:`shard_batch`, the loaders'
  ``process_shard``); the gradients are averaged over it.
- ``fsdp``: :func:`shard_model` wraps the model in FSDP2 (``fully_shard``
  over the (data, fsdp) mesh) with the JAX rule of :func:`param_sharding_rule`
  (:61-75): a parameter of at least 2**16 elements is sharded along its
  largest axis that the fsdp size divides, a smaller one (or one with no
  such axis) stays a replicated plain tensor, whose gradient is averaged
  explicitly. Processes of one data coordinate see the same rows.
- ``tensor``: Megatron tensor parallelism (``parallel/tensor.py``, the
  JAX package's layout of :78-165 computed for real): the column- and
  row-parallel projections hold plain local shards and sum over the axis's
  group, applied before :func:`shard_model`, which shards the local shards
  over (data, fsdp). Under ``sequence_parallel`` the axis is instead the
  group of ring attention, along which the weights stay replicated.

The mesh needs a process group (``multihost.initialize``); a process no
launcher started runs without a mesh.
"""

from __future__ import annotations

import contextlib
import math
import sys
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "AXES",
    "make_mesh",
    "mesh_shape",
    "axis_group",
    "shard_batch",
    "param_sharding_rule",
    "shard_model",
    "average_gradients",
    "unsharded",
    "full_tensors",
    "as_layout_of",
    "is_dtensor",
]

AXES = ("data", "fsdp", "tensor")
FSDP_MIN_SIZE = 2 ** 16  # parameters below this many elements stay replicated


def mesh_shape(batch_size: int, world: int, tensor: int = 1) -> Tuple[int, ...]:
    """The experiments' mesh (``dfot_tpu/experiments/video_generation.py:
    165-176``): ``tensor`` processes a ring, the data axis the largest
    divisor of the batch among the rest, the spare processes on fsdp."""
    if world % tensor:
        raise ValueError(f"mesh.tensor={tensor} does not divide {world} processes")
    avail = world // tensor
    data = math.gcd(batch_size, avail)
    return (data, avail // data) + ((tensor,) if tensor > 1 else ())


def make_mesh(shape: Optional[Tuple[int, ...]] = None):
    """A (data, fsdp[, tensor]) ``DeviceMesh`` over the world's processes
    (shape None: all on data), on the card under NCCL, else the CPU."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call multihost.initialize() first")
    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"mesh shape must be (data, fsdp[, tensor]): {shape}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != {world} processes")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, shape, mesh_dim_names=AXES[:len(shape)])


def axis_group(mesh, name: str):
    """(process group, size, this process's index) of one axis; (None, 1, 0)
    without a mesh or where the mesh lacks the axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None, 1, 0
    sub = mesh[name]
    return sub.get_group(), sub.size(), sub.get_local_rank()


def shard_batch(batch, mesh):
    """This process's rows of a global batch (a tree of arrays or tensors
    with the batch on the leading axis): the data axis's strided share,
    rows ``index, index + size, ...``, the rows the loaders' ``process_shard``
    gives it."""
    _, size, index = axis_group(mesh, "data")
    if size == 1:
        return batch

    def rows(x):
        if x.shape[0] % size:
            raise ValueError(f"a batch of {x.shape[0]} does not divide over {size} data ranks")
        return x[index::size]

    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    return rows(batch)


def param_sharding_rule(shape: Tuple[int, ...], fsdp_size: int,
                        min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The axis a parameter is sharded along, or None (replicated): the
    largest axis the fsdp size divides, for tensors of at least
    ``min_size`` elements (``dfot_tpu/parallel/mesh.py:61-75``)."""
    if fsdp_size <= 1 or int(np.prod(shape)) < min_size:
        return None
    for axis in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[axis] % fsdp_size == 0:
            return axis
    return None


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Wrap ``model`` in FSDP2 over the (data, fsdp) axes by
    :func:`param_sharding_rule`; returns it (wrapped in place). A no-op where
    the fsdp axis is 1."""
    _, fsdp, _ = axis_group(mesh, "fsdp")
    if fsdp == 1:
        return model
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    axes = {p: param_sharding_rule(tuple(p.shape), fsdp, FSDP_MIN_SIZE)
            for p in model.parameters()}
    if all(a is None for a in axes.values()):  # every parameter stays replicated
        return model
    fully_shard(model, mesh=mesh["data", "fsdp"],
                ignored_params={p for p, a in axes.items() if a is None},
                shard_placement_fn=lambda p: Shard(axes[p]))
    from .tensor import tag_shards

    tag_shards(model)  # FSDP2's parameters replace the tensor-parallel shards
    return model


@contextlib.contextmanager
def unsharded(model: torch.nn.Module):
    """An FSDP2 model's parameters gathered whole for the duration (sampling
    reads some weights outside the model's forward: the pose FiLM terms, once
    a window), sharded again after; any other model as it is."""
    from torch.distributed.fsdp import FSDPModule

    if not isinstance(model, FSDPModule):
        yield
        return
    model.set_reshard_after_forward(False)
    model.unshard()
    try:
        yield
    finally:
        model.set_reshard_after_forward(True)
        model.reshard()


def average_gradients(model: torch.nn.Module, mesh) -> None:
    """Average the plain-tensor gradients over the data and fsdp axes (FSDP2
    averages those of the parameters it shards)."""
    groups = [g for g, size, _ in (axis_group(mesh, "data"), axis_group(mesh, "fsdp"))
              if size > 1]
    if not groups:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None and not is_dtensor(p.grad)]
    for group in groups:
        size = dist.get_world_size(group)
        for g in grads:
            dist.all_reduce(g, group=group)
            g.div_(size)


def is_dtensor(t) -> bool:
    """A DTensor (FSDP2's sharded parameters, their gradients and moments);
    none exists while ``torch.distributed.tensor`` is not imported, which
    this does not import."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(t, module.DTensor)


def full_tensors(tree):
    """``tree`` with every DTensor replaced by its whole tensor (a
    collective: every process of its mesh calls it)."""
    if is_dtensor(tree):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: full_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tensors(v) for v in tree)
    return tree


def as_layout_of(value: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """A whole saved tensor in the layout of ``live``: sharded as ``live``
    where it is a DTensor, else as it is."""
    if is_dtensor(live) and not is_dtensor(value):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(value.to(live.device, live.dtype), live.device_mesh,
                                 live.placements)
    return value
