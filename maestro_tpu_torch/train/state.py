"""Train state: the step count, the model (which holds the parameters), the
optimizer (which holds its moments) and the EMA weights of the supervised
phases (reference train/base.py:263-274).

Under FSDP or tensor parallelism a rank holds pieces of the parameters; the
EMA weights are copies of this rank's pieces and update in place, and
``parallel`` (a ``parallel.mesh.Parallel``) joins the pieces for a
checkpoint."""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any

import torch
from torch import nn

from maestro_tpu_torch.parallel.mesh import local, resharded
from maestro_tpu_torch.train.optim import ScheduledAdamW


@dataclass
class TrainState:
    """Everything a training step mutates; the step updates it in place.
    ``step`` counts calls of the step (micro-steps under accumulation)."""

    step: int
    model: nn.Module
    tx: ScheduledAdamW
    ema: dict[str, torch.Tensor] | None = None
    parallel: Any = None

    @classmethod
    def create(cls, model: nn.Module, tx: ScheduledAdamW, use_ema: bool = False,
               parallel=None) -> "TrainState":
        return cls(step=0, model=model, tx=tx, ema=ema_params(model) if use_ema else None,
                   parallel=parallel)


def ema_params(model: nn.Module) -> dict[str, torch.Tensor]:
    """fp32 copies (not aliases) of every parameter (this rank's piece), by name."""
    return {name: local(p).detach().clone()
            for name, p in resharded(model).named_parameters()}


@contextmanager
def swapped_params(model: nn.Module, params: dict[str, torch.Tensor]):
    """``params`` (this rank's pieces, by name) copied into the model's
    parameters for the block, the trained values copied back after it."""
    named = dict(resharded(model).named_parameters())
    names = list(params)
    live = [local(named[n]).detach() for n in names]
    kept = [t.clone() for t in live]
    torch._foreach_copy_(live, [params[n] for n in names])
    try:
        yield
    finally:
        resharded(model)  # drop a gathered copy of the swapped-in values
        torch._foreach_copy_(live, kept)


@torch.no_grad()
def ema_update(state: TrainState, momentum: float) -> TrainState:
    """Per-epoch EMA update ``ema = momentum * ema + (1 - momentum) * params``
    (reference train/base.py:267-274), in place, one fused launch per group of
    tensors; a state without EMA weights is returned as it is."""
    if state.ema is None:
        return state
    params = dict(resharded(state.model).named_parameters())
    names = list(state.ema)
    torch._foreach_lerp_([state.ema[n] for n in names],
                         [local(params[n]).detach() for n in names], 1.0 - momentum)
    return state


def ema_momentum(max_epochs: int) -> float:
    return 1.0 - 1.0 / (max_epochs * 0.2)
