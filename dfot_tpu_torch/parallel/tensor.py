"""Megatron tensor parallelism over the mesh's ``tensor`` axis.

Port of the Megatron layout of ``dfot_tpu/parallel/mesh.py:78-165``. In the
JAX package the rule only places the projections' kernels on the devices and
``jit``'s partitioner inserts the collectives; here each process holds plain
local shards and runs the collectives itself:

- **Column-parallel** layers (the qkv projections, the U-ViT's fused
  attention + MLP input projection, the axial attention's ``proj``, an MLP's
  ``fc1``) keep whole heads: rank r holds the q, k and v columns of heads
  ``r·H/t … (r+1)·H/t`` (not contiguous columns of the packed output) and,
  for the fused projection, the r-th 4C/t slice of the MLP hidden. Their
  input is the replicated residual stream; the backward sums its gradient
  over the group (:class:`_CopyToGroup`). q/k norms and RoPE are per head, so
  the attention's custom ops (B2, B1, B3 and their backwards) run unchanged
  on H/t heads.
- **Row-parallel** layers (``attn_out``, ``mlp_out``, the axial ``out``, the
  DiTs' ``proj`` and ``fc2``) take the rank's slice of their input and sum
  their outputs over the group with one all-reduce (:class:`_ReduceFromGroup`,
  in the activations' dtype); the bias is added once, after the reduce.
- The per-head q/k norm scales inside such a block are replicated but see
  only the rank's heads: a hook sums their gradients over the group.
- A block whose head count (or MLP hidden) the tensor size does not divide
  stays replicated, as does every layer outside such a pair: the
  embeddings, the final layers, every conv, UNet3D and FAR-DiT whole. The
  replicated layers see the same input on every tensor rank, so their
  gradients are whole and equal there and are not reduced.

A tensor-parallel module keeps its parameter names; :func:`gather_whole`
gathers a shard to the whole tensor (checkpoints hold whole tensors) and
:func:`local_part` cuts a whole tensor to this rank's shard. Under
``mesh.sequence_parallel`` the tensor axis is the ring's and the weights
stay replicated (``experiments/video_generation.py``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import is_dtensor

__all__ = [
    "Shard",
    "tensor_parallel_plan",
    "tensor_parallel_roles",
    "apply_tensor_parallel",
    "remove_tensor_parallel",
    "tensor_parallel_size",
    "gather_whole",
    "local_part",
    "all_gather_last",
    "tag_shards",
]


class Shard(NamedTuple):
    role: str             # "column" (output rows kept) or "row" (input columns kept)
    index: torch.Tensor   # the kept indices of the sharded axis, by rank: (size, n)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the
    input of a column-parallel layer is replicated)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """The ranks' slices concatenated on the last axis forward; the rank's
    slice of the (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        ctx.width, ctx.rank = x.shape[-1], rank
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.rank * w:(ctx.rank + 1) * w], None


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, out of place (a remat policy may keep ``x``),
    in ``x``'s dtype: bf16 under autocast, as Megatron reduces, half the
    bytes of fp32 through gloo's host copies."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def all_gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The tensor ranks' last-axis slices joined (None: ``x`` itself)."""
    return x if group is None else _GatherLast.apply(x, group)


class ColumnParallelLinear(nn.Linear):
    """``nn.Linear`` holding rows of the whole layer's weight (its output
    features ``Shard.index``); ``tp_group`` is the tensor group."""

    tp_group = None

    def forward(self, x):
        return F.linear(_CopyToGroup.apply(x, self.tp_group), self.weight, self.bias)


class RowParallelLinear(nn.Linear):
    """``nn.Linear`` holding columns of the whole layer's weight (its input
    features ``Shard.index``); the outputs are summed over ``tp_group`` and
    the whole bias added once."""

    tp_group = None

    def forward(self, x):
        y = _ReduceFromGroup.apply(F.linear(x, self.weight), self.tp_group)
        return y if self.bias is None else y + self.bias.to(y.dtype)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _split(n: int, size: int) -> torch.Tensor:
    """Contiguous slices: (size, n / size) indices."""
    return torch.arange(n).reshape(size, n // size)


def _heads(C: int, size: int, parts: int) -> torch.Tensor:
    """The columns of ``parts`` packed blocks of C (q, k, v) that hold each
    rank's heads: (size, parts * C / size)."""
    per = _split(C, size)
    return torch.cat([per + i * C for i in range(parts)], dim=1)


def _head_norms(m: nn.Module, pre: str):
    """The per-head q/k norm parameters of an attention module: replicated,
    each rank's gradient a sum over its own heads."""
    return [pre + n for n, _ in m.named_parameters() if n.split(".")[0] in ("q_norm", "k_norm")]


def _layers(model: nn.Module, size: int):
    """(layer path, role, kept indices by rank, heads module, head count) of
    every layer the port shards at tensor ``size``, a block at a time; a
    block whose heads or hidden ``size`` does not divide is left out."""
    from ..models.dit import Attention, Mlp
    from ..models.dit1d import DiT1DAttention
    from ..models.uvit import AxialAttention, TransformerBlock

    out = []
    for name, m in model.named_modules():
        pre = name + "." if name else ""
        if isinstance(m, TransformerBlock):
            C, H = m.attn_out.in_features, m.heads
            if H % size:
                continue
            fused = torch.cat([_heads(C, size, 3), _split(4 * C, size) + 3 * C], dim=1)
            out += [(pre + "fused_attn_mlp_proj", "column", fused, m, "heads"),
                    (pre + "attn_out", "row", _split(C, size), None, None),
                    (pre + "mlp_out.2", "row", _split(4 * C, size), m.mlp_out[1], "columns")]
            out += [(n, "partial", None, None, None) for n in _head_norms(m, pre)
                    if not n.startswith(pre + "another_attn.")]
        elif isinstance(m, AxialAttention):
            C, H = m.out.in_features, m.heads
            if H % size:
                continue
            out += [(pre + "proj", "column", _heads(C, size, 3), m, "heads"),
                    (pre + "out", "row", _split(C, size), m, "gather")]
            out += [(n, "partial", None, None, None) for n in _head_norms(m, pre)]
        elif isinstance(m, (Attention, DiT1DAttention)):
            C, H = m.proj.in_features, m.num_heads
            if H % size:
                continue
            out += [(pre + "qkv", "column", _heads(C, size, 3), m, "num_heads"),
                    (pre + "proj", "row", _split(C, size), None, None)]
            out += [(n, "partial", None, None, None) for n in _head_norms(m, pre)]
        elif isinstance(m, Mlp):
            hidden = m.fc1.out_features
            if hidden % size:
                continue
            out += [(pre + "fc1", "column", _split(hidden, size), None, None),
                    (pre + "fc2", "row", _split(hidden, size), None, None)]
    return out


def tensor_parallel_plan(model: nn.Module, size: int) -> Dict[str, Shard]:
    """{parameter name: its :class:`Shard`} of every parameter the port
    shards at tensor ``size`` (a row-parallel layer's bias stays whole)."""
    return _plan_of(model, _layers(model, size) if size > 1 else [])


def _plan_of(model: nn.Module, layers) -> Dict[str, Shard]:
    plan: Dict[str, Shard] = {}
    for path, role, index, _, _ in layers:
        if role == "partial":
            continue
        plan[path + ".weight"] = Shard(role, index)
        if role == "column" and _module(model, path).bias is not None:
            plan[path + ".bias"] = Shard(role, index)
    return plan


def tensor_parallel_roles(model: nn.Module, size: int) -> Dict[str, Optional[str]]:
    """{parameter name: "column", "row" or None}: the port's Megatron
    classification at tensor ``size``."""
    plan = tensor_parallel_plan(model, size)
    return {n: (plan[n].role if n in plan else None) for n, _ in model.named_parameters()}


def _module(model: nn.Module, path: str) -> nn.Module:
    return model.get_submodule(path)


def _axis(shard: Shard) -> int:
    """The weight's sharded axis ((out, in) layout); a bias has one."""
    return 0 if shard.role == "column" else -1


def tensor_parallel_size(model: nn.Module) -> int:
    """The tensor size ``model`` is sharded at (1: not)."""
    state = getattr(model, "_tensor_parallel", None)
    return 1 if state is None else state["size"]


@torch.no_grad()
def apply_tensor_parallel(model: nn.Module, group) -> Dict[str, Shard]:
    """Shard ``model`` in place over ``group`` (the mesh's tensor axis):
    each column/row-parallel layer keeps this rank's shard of its weights
    and runs its collective; the heads counts become local. Returns the
    plan (empty where nothing divides or the group is of one)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if tensor_parallel_size(model) != 1:
        raise ValueError("the model is tensor-parallel already")
    layers = _layers(model, size) if size > 1 else []
    plan = _plan_of(model, layers)
    params = dict(model.named_parameters())
    hooks = []
    for path, role, index, owner, attr in layers:
        if role == "partial":
            hooks.append(params[path].register_hook(
                lambda g, group=group: _all_reduce(g, group)))
            continue
        lin = _module(model, path)
        keep = index[rank]
        axis = 0 if role == "column" else 1
        lin.weight = nn.Parameter(lin.weight.index_select(axis, keep.to(lin.weight.device)))
        if role == "column":
            if lin.bias is not None:
                lin.bias = nn.Parameter(lin.bias.index_select(0, keep.to(lin.bias.device)))
            lin.out_features = len(keep)
            lin.__class__ = ColumnParallelLinear
        else:
            lin.in_features = len(keep)
            lin.__class__ = RowParallelLinear
        lin.tp_group = group
        if attr in ("heads", "num_heads"):
            setattr(owner, attr, getattr(owner, attr) // size)
        elif attr == "columns":  # the dropout before a row-parallel layer
            owner.columns = (keep, index.numel())
        elif attr == "gather":  # the axial block adds its whole attention output
            owner.tp_group = group
    model._tensor_parallel = {"size": size, "rank": rank, "group": group, "plan": plan,
                              "layers": layers, "hooks": hooks}
    tag_shards(model)
    return plan


def tag_shards(model: nn.Module) -> None:
    """Tag each sharded parameter object with its ``tp_group`` (the
    gradient norm sums over the group what the tag marks); again after
    FSDP2 replaces the parameters."""
    state = getattr(model, "_tensor_parallel", None)
    if state is None:
        return
    for name, p in model.named_parameters():
        if name in state["plan"]:
            p.tp_group = state["group"]


@torch.no_grad()
def remove_tensor_parallel(model: nn.Module) -> None:
    """Undo :func:`apply_tensor_parallel`: every shard gathered whole, the
    layers and heads counts as they were (a collective over the group)."""
    state = getattr(model, "_tensor_parallel", None)
    if state is None:
        return
    size = state["size"]
    params = dict(model.named_parameters())
    for hook in state["hooks"]:
        hook.remove()
    for path, role, index, owner, attr in state["layers"]:
        if role == "partial":
            continue
        lin = _module(model, path)
        for kind in ("weight", "bias"):
            name = f"{path}.{kind}"
            if name in state["plan"]:
                setattr(lin, kind, nn.Parameter(gather_whole(model, name, params[name])))
        if role == "column":
            lin.out_features = lin.weight.shape[0]
        else:
            lin.in_features = lin.weight.shape[1]
        lin.__class__ = nn.Linear
        del lin.tp_group
        if attr in ("heads", "num_heads"):
            setattr(owner, attr, getattr(owner, attr) * size)
        elif attr == "columns":
            owner.columns = None
        elif attr == "gather":
            owner.tp_group = None
    del model._tensor_parallel


def gather_whole(model: nn.Module, name: str, value: torch.Tensor) -> torch.Tensor:
    """The whole tensor of parameter ``name`` (or of a tensor in its layout:
    a moment, an EMA shadow) from this rank's shard; ``value`` as it is for
    a parameter the model does not shard. A collective over the group."""
    state = getattr(model, "_tensor_parallel", None)
    if state is None or name not in state["plan"]:
        return value
    shard = state["plan"][name]
    if is_dtensor(value):  # a shard that FSDP2 shards further
        value = value.full_tensor()
    axis = _axis(shard) % value.dim()
    value = value.contiguous()
    parts = [torch.empty_like(value) for _ in range(state["size"])]
    dist.all_gather(parts, value, group=state["group"])
    joined = torch.cat(parts, dim=axis)
    whole = torch.empty_like(joined)
    whole.index_copy_(axis, shard.index.reshape(-1).to(joined.device), joined)
    return whole


def local_part(model: nn.Module, name: str, value: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a whole tensor of parameter ``name`` (a tensor
    already of the shard's shape, or of a parameter not sharded, as it is)."""
    state = getattr(model, "_tensor_parallel", None)
    if state is None or name not in state["plan"] or not torch.is_tensor(value):
        return value
    shard = state["plan"][name]
    axis = _axis(shard) % value.dim()
    keep = shard.index[state["rank"]]
    if value.shape[axis] == len(keep):
        return value
    return value.index_select(axis, keep.to(value.device))
