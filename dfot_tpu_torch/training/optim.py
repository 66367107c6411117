"""Optimizer and LR schedule factory on ``torch.optim.AdamW``.

Port of ``dfot_tpu/training/optim.py``, held step for step to the optax
chain it builds: ``clip_by_global_norm`` then ``adamw`` (decoupled weight
decay on every parameter, biases and norm scales too; eps outside the
root), a schedule that is read at the optimizer-step count starting from 0
(so a warm-up's first step has learning rate 0), all inside ``MultiSteps``
when gradients are accumulated (the mean of k micro-step gradients, one
update every k).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import torch

from ..parallel.mesh import is_dtensor

__all__ = ["Optimizer", "make_lr_schedule", "make_optimizer", "global_norm", "foreach"]


def make_lr_schedule(
    name: str,
    base_lr: float,
    num_warmup_steps: int = 0,
    num_training_steps: Optional[int] = None,
) -> Callable[[int], float]:
    """step -> learning rate, for ``constant``, ``constant_with_warmup``,
    ``linear`` and ``cosine``: a linear warm-up from 0 over
    ``num_warmup_steps``, then the named schedule counted from its end."""
    if name not in ("constant", "constant_with_warmup", "linear", "cosine"):
        raise ValueError(f"unknown lr schedule {name}")
    if name in ("linear", "cosine") and num_training_steps is None:
        raise ValueError(f"lr schedule {name} needs num_training_steps")
    warm = max(num_warmup_steps, 1)
    decay = max((num_training_steps or 0) - num_warmup_steps, 1)

    def schedule(step: int) -> float:
        if name == "constant":
            return base_lr
        if step < num_warmup_steps:
            return base_lr * min(step, warm) / warm
        frac = min(max(step - num_warmup_steps, 0), decay) / decay
        if name == "linear":
            return base_lr * (1.0 - frac)
        if name == "cosine":
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))
        return base_lr

    return schedule


def foreach(op, tensors: List[torch.Tensor], *others, **kwargs):
    """``op`` (a ``torch._foreach_*`` function) over ``tensors`` and the
    lists in ``others`` position by position, one call for the plain tensors
    and one for the DTensors (FSDP2's sharded parameters; the foreach ops
    take one kind at a time); its results, if any, in the input order. A
    0-d tensor argument is a plain Python number for the DTensors."""
    if not any(is_dtensor(t) for t in tensors):
        return op(tensors, *others, **kwargs)
    out = [None] * len(tensors)
    for sharded in (False, True):
        idx = [i for i, t in enumerate(tensors) if is_dtensor(t) == sharded]
        if not idx:
            continue
        args = [[lst[i] for i in idx] if isinstance(lst, (list, tuple)) else
                (lst.item() if sharded and torch.is_tensor(lst) else lst) for lst in others]
        got = op([tensors[i] for i in idx], *args, **kwargs)
        for i, r in zip(idx, got or ()):
            out[i] = r
    return out


def global_norm(tensors: Iterable[torch.Tensor], params=None) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, in fp32 (a DTensor's
    norm is that of its whole tensor). ``params``, the parameters the
    tensors belong to, in order: the squares of a tensor-parallel shard's
    (a parameter ``parallel/tensor.py`` tagged with ``tp_group``) are summed over
    its group, so the norm is the whole model's."""
    tensors = list(tensors)
    norms = foreach(torch._foreach_norm, [t.float() for t in tensors])
    norms = [n.full_tensor() if is_dtensor(n) else n for n in norms]
    groups = [getattr(p, "tp_group", None) for p in params] if params is not None else []
    group = next((g for g in groups if g is not None), None)
    if group is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    squares = torch.stack(norms) ** 2
    sharded = torch.tensor([g is not None for g in groups], device=squares.device)
    part = squares[sharded].sum()
    torch.distributed.all_reduce(part, group=group)
    return torch.sqrt(squares[~sharded].sum() + part)


class Optimizer:
    """AdamW with global-norm clipping, a step-indexed learning rate and
    gradient accumulation; reads the parameters' ``.grad``.

    ``adamw`` is the ``torch.optim.AdamW`` (base learning rate 1, so the
    scheduler's factor is the learning rate itself) and ``scheduler`` its
    ``LambdaLR``. :meth:`state_dict` holds both, the micro-step count and
    the accumulated gradient sum, keyed by parameter name.
    """

    def __init__(self, params, schedule: Callable[[int], float], weight_decay: float,
                 betas, grad_clip: float, accumulate_steps: int):
        self.params = [p for p in params if p.requires_grad]
        self.adamw = torch.optim.AdamW(
            self.params, lr=1.0, betas=tuple(betas), eps=1e-8, weight_decay=weight_decay
        )
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.adamw, schedule)
        self.grad_clip = grad_clip
        self.accumulate_steps = max(int(accumulate_steps), 1)
        self.micro_step = 0
        self._sum = None  # running sum of micro-step gradients

    @property
    def lr(self) -> float:
        """The learning rate the next update will use."""
        return self.adamw.param_groups[0]["lr"]

    def state_dict(self, names: List[str]) -> Dict:
        """The optimizer's state with ``names[i]`` naming ``params[i]``: Adam's
        moments and step count, the hyperparameters, the scheduler's
        position, ``micro_step`` and the gradient sum of a cycle in progress."""
        if len(names) != len(self.params):
            raise ValueError(f"{len(names)} names for {len(self.params)} parameters")
        adamw = self.adamw.state_dict()
        groups = [{k: v for k, v in g.items() if k != "params"} for g in adamw["param_groups"]]
        return {
            "moments": {names[i]: s for i, s in adamw["state"].items()},
            "param_groups": groups,
            "scheduler": self.scheduler.state_dict(),
            "micro_step": self.micro_step,
            "sum": None if self._sum is None else dict(zip(names, self._sum)),
        }

    def load_state_dict(self, state: Dict, names: List[str]) -> None:
        """Restore what :meth:`state_dict` gave, onto the parameters'
        devices; the parameters are matched by name."""
        index = {name: i for i, name in enumerate(names)}
        if len(index) != len(self.params) or set(state["moments"]) - set(index):
            raise ValueError("the saved moments name other parameters than this optimizer's")
        groups = [dict(g, params=list(range(len(self.params)))) for g in state["param_groups"]]
        self.adamw.load_state_dict({
            "state": {index[n]: s for n, s in state["moments"].items()},
            "param_groups": groups,
        })
        self.scheduler.load_state_dict(state["scheduler"])
        self.micro_step = int(state["micro_step"])
        saved = state["sum"]
        self._sum = None if saved is None else [
            saved[n].to(p.device, p.dtype, copy=True) for n, p in zip(names, self.params)]

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> bool:
        """Take the gradients of one micro-step; returns whether the
        parameters were updated (every ``accumulate_steps`` calls)."""
        grads = [
            p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params
        ]
        k = self.accumulate_steps
        self.micro_step += 1
        if k > 1:
            if self._sum is None:
                self._sum = [g.clone() for g in grads]
            else:
                foreach(torch._foreach_add_, self._sum, grads)
            if self.micro_step % k:
                return False
            grads = foreach(torch._foreach_div, self._sum, float(k))
            self._sum = None
        if self.grad_clip and self.grad_clip > 0:
            # optax's rule: scale by clip / max(norm, clip), no epsilon
            norm = global_norm(grads, self.params)
            scale = self.grad_clip / torch.clamp(norm, min=self.grad_clip)
            grads = foreach(torch._foreach_mul, grads, scale)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        self.scheduler.step()
        return True


def make_optimizer(
    params,
    lr: float,
    weight_decay: float = 1e-3,
    betas=(0.9, 0.99),
    grad_clip: float = 1.0,
    lr_schedule_name: str = "constant_with_warmup",
    num_warmup_steps: int = 5000,
    num_training_steps: Optional[int] = None,
    accumulate_steps: int = 1,
) -> Optimizer:
    """The training optimizer over ``params`` (an iterable of parameters)."""
    schedule = make_lr_schedule(lr_schedule_name, lr, num_warmup_steps, num_training_steps)
    return Optimizer(params, schedule, weight_decay, betas, grad_clip, accumulate_steps)
