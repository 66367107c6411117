"""Train state: model, optimizer and EMA shadow as one object.

Port of ``dfot_tpu/training/state.py``. The JAX state is an immutable
pytree that each step replaces; here the model and the optimizer are
updated in place and the state object is handed back. The fp32 parameters
of the model are the master weights; the EMA shadow holds one fp32 tensor
per parameter, by name. :meth:`TrainState.state_dict` is what a checkpoint
holds (``training/checkpoint.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional

import torch
from torch import nn

from ..parallel.mesh import as_layout_of, is_dtensor
from .optim import Optimizer, foreach

__all__ = ["TrainState", "create_train_state", "ema_update", "gated_ema_update",
           "load_module_state"]


@dataclasses.dataclass
class TrainState:
    step: int  # micro-steps taken
    model: nn.Module
    optimizer: Optimizer
    ema: Optional[Dict[str, torch.Tensor]] = None

    @property
    def scheduler(self):
        return self.optimizer.scheduler

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's state dict with the EMA shadow in place of the
        parameters (buffers as they are): what sampling loads."""
        if self.ema is None:
            raise ValueError("this train state keeps no EMA")
        return {**self.model.state_dict(), **self.ema}

    def _param_names(self) -> List[str]:
        """The model's name of each parameter the optimizer updates, in order."""
        name_of = {id(p): n for n, p in self.model.named_parameters()}
        return [name_of[id(p)] for p in self.optimizer.params]

    def state_dict(self) -> Dict:
        """``{"params": the model's state dict (parameters and buffers, under
        its names), "ema_params", "opt_state", "step"}``; the tensors are the
        live ones (copy them before the next step changes them)."""
        return {
            "params": self.model.state_dict(),
            "ema_params": None if self.ema is None else dict(self.ema),
            "opt_state": self.optimizer.state_dict(self._param_names()),
            "step": self.step,
        }

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Restore :meth:`state_dict`'s content in place: the parameters keep
        their identity (the optimizer's references stay valid), every value
        comes back with the bits it was saved with. Whole saved tensors go
        into an FSDP2 model's sharded parameters, moments and EMA in their
        layout."""
        load_module_state(self.model, state["params"])
        if (self.ema is None) != (state.get("ema_params") is None):
            raise ValueError("the saved state and this one disagree on keeping an EMA")
        if self.ema is not None:
            saved = state["ema_params"]
            if set(saved) != set(self.ema):
                raise ValueError("the saved EMA names other parameters than this state's")
            for name, shadow in self.ema.items():
                shadow.copy_(as_layout_of(saved[name], shadow))
        names = self._param_names()
        opt = dict(state["opt_state"])
        params = dict(zip(names, self.optimizer.params))
        opt["moments"] = {
            n: {k: (as_layout_of(v, params[n]) if k != "step" else v) for k, v in m.items()}
            for n, m in opt["moments"].items()}
        if opt.get("sum") is not None:
            opt["sum"] = {n: as_layout_of(v, params[n]) for n, v in opt["sum"].items()}
        self.optimizer.load_state_dict(opt, names)
        self.step = int(state["step"])

    @contextlib.contextmanager
    def ema_weights(self) -> Iterator[None]:
        """The EMA shadow in place of the model's parameters for the
        duration (the tensors are swapped, nothing is copied; the parameter
        objects, which the optimizer holds, stay the same). FSDP2 keeps its
        sharded parameters' storage itself: those are copied in and back."""
        if self.ema is None:
            raise ValueError("this train state keeps no EMA")
        params = dict(self.model.named_parameters())
        live, copied = {}, {}
        try:
            for name, shadow in self.ema.items():
                p = params[name]
                if is_dtensor(p):
                    copied[name] = p.detach().clone()
                    with torch.no_grad():
                        p.copy_(shadow)
                else:
                    live[name] = p.data
                    p.data = shadow
            yield
        finally:
            for name, data in live.items():
                params[name].data = data
            with torch.no_grad():
                for name, data in copied.items():
                    params[name].copy_(data)


def create_train_state(model: nn.Module, optimizer: Optimizer, use_ema: bool = True) -> TrainState:
    ema = None
    if use_ema:
        ema = {
            name: p.detach().clone()
            for name, p in model.named_parameters() if p.requires_grad
        }
    return TrainState(step=0, model=model, optimizer=optimizer, ema=ema)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> Dict[str, torch.Tensor]:
    """shadow <- decay * shadow + (1 - decay) * params, in place."""
    shadow = [ema[name] for name in ema]
    new = [params[name].detach().to(ema[name].dtype) for name in ema]
    foreach(torch._foreach_mul_, shadow, decay)
    foreach(torch._foreach_add_, shadow, new, alpha=1.0 - decay)
    return ema


@torch.no_grad()
def load_module_state(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """``module.load_state_dict(state, strict=True)``, whole saved tensors
    put into the layout of an FSDP2 module's sharded parameters."""
    live = module.state_dict()
    module.load_state_dict(
        {k: as_layout_of(v, live[k]) if k in live else v for k, v in state.items()}, strict=True)


def gated_ema_update(ema, params, decay: float, step: int, accumulate_steps: int = 1):
    """EMA update applied once per OPTIMIZER step under gradient
    accumulation: ``step`` is the micro-step count after this step, and the
    parameters change only on micro-steps k, 2k, ..., so the shadow stays as
    it is in between."""
    if accumulate_steps > 1 and step % accumulate_steps:
        return ema
    return ema_update(ema, params, decay)
