"""Train state: the step count, the model (which holds the parameters), the
optimizer (which holds its moments) and the EMA weights of the supervised
phases (reference train/base.py:263-274)."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from maestro_tpu_torch.train.optim import ScheduledAdamW


@dataclass
class TrainState:
    """Everything a training step mutates; the step updates it in place.
    ``step`` counts calls of the step (micro-steps under accumulation)."""

    step: int
    model: nn.Module
    tx: ScheduledAdamW
    ema: dict[str, torch.Tensor] | None = None

    @classmethod
    def create(cls, model: nn.Module, tx: ScheduledAdamW, use_ema: bool = False) -> "TrainState":
        return cls(step=0, model=model, tx=tx, ema=ema_params(model) if use_ema else None)


def ema_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """fp32 copies (not aliases) of every parameter, by name."""
    return {name: p.detach().clone() for name, p in model.named_parameters()}


@torch.no_grad()
def ema_update(state: TrainState, momentum: float) -> TrainState:
    """Per-epoch EMA update ``ema = momentum * ema + (1 - momentum) * params``
    (reference train/base.py:267-274), in place, one fused launch per group of
    tensors; a state without EMA weights is returned as it is."""
    if state.ema is None:
        return state
    params = dict(state.model.named_parameters())
    names = list(state.ema)
    torch._foreach_lerp_([state.ema[n] for n in names], [params[n].detach() for n in names],
                         1.0 - momentum)
    return state


def ema_momentum(max_epochs: int) -> float:
    return 1.0 - 1.0 / (max_epochs * 0.2)
