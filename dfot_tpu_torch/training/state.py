"""Train state: model, optimizer and EMA shadow as one object.

Port of ``dfot_tpu/training/state.py``. The JAX state is an immutable
pytree that each step replaces; here the model and the optimizer are
updated in place and the state object is handed back. The fp32 parameters
of the model are the master weights; the EMA shadow holds one fp32 tensor
per parameter, by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from .optim import Optimizer

__all__ = ["TrainState", "create_train_state", "ema_update", "gated_ema_update"]


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
    torch._foreach_mul_(shadow, decay)
    torch._foreach_add_(shadow, new, alpha=1.0 - decay)
    return ema


def gated_ema_update(ema, params, decay: float, step: int, accumulate_steps: int = 1):
    """EMA update applied once per OPTIMIZER step under gradient
    accumulation: ``step`` is the micro-step count after this step, and the
    parameters change only on micro-steps k, 2k, ..., so the shadow stays as
    it is in between."""
    if accumulate_steps > 1 and step % accumulate_steps:
        return ema
    return ema_update(ema, params, decay)
