"""Train state: the step count, the model (which holds the parameters) and the
optimizer (which holds its moments).  EMA weights arrive with the supervised
phases."""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from maestro_tpu_torch.train.optim import ScheduledAdamW


@dataclass
class TrainState:
    """Everything a training step mutates; the step updates it in place."""

    step: int
    model: nn.Module
    tx: ScheduledAdamW

    @classmethod
    def create(cls, model: nn.Module, tx: ScheduledAdamW) -> "TrainState":
        return cls(step=0, model=model, tx=tx)
