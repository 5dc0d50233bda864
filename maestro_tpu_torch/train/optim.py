"""Optimizer construction: AdamW + OneCycle with phase-dependent freezing.

Reference semantics (maestro/train/model.py:120-158), as the JAX package's
``train/optim.py`` has them: sqrt batch-size LR scaling
``lr = base_lr * (global_batch / 3)**0.5``, AdamW(b1, b2, wd), a cosine
one-cycle schedule (pct_start=0.2, div_factor=1000, final_div_factor =
final_factor / 1000) stepped per optimizer step.

Phase-dependent trainability: parameters of a frozen role are left out of the
optimizer, so they get no update, no moments and no weight decay (the JAX
package's ``optax.set_to_zero`` branch of ``multi_transform``):
  - pretrain: heads frozen (they take no part in the reconstruction);
  - probe: only heads train;
  - finetune: encoder + heads train; the decoder side stays frozen.
The AdamW update of optimizer step n uses the learning rate ``schedule(n)``,
n counted from 0, as optax evaluates the schedule before it counts the step.
Gradient accumulation (``MultiSteps``), layer-wise LR decay and the
skip-non-finite guard are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from maestro_tpu_torch.conf.core import OptConfig

Schedule = Callable[[int], float]

_DECODER_PREFIXES = ("decoders.", "enc_to_dec.", "pixelify.", "mask_tokens.")


def lr_for(opt: OptConfig, num_devices: int) -> float:
    """Sqrt batch-size scaling (the /3 keeps parity with reference runs)."""
    global_batch = opt.batch_size * opt.accumulate_grad_batches * num_devices
    return opt.base_lr * (global_batch / 3.0) ** 0.5


def onecycle(opt: OptConfig, total_steps: int, num_devices: int) -> Schedule:
    peak = lr_for(opt, num_devices)
    # finetune configs carry final_factor (not ported yet); others use 1e7
    final_factor = getattr(opt, "final_factor", 1e7)
    return onecycle_schedule(
        total_steps=max(total_steps, 1),
        peak_value=peak,
        pct_start=0.2,
        div_factor=1000.0,
        final_div_factor=final_factor / 1000.0,
    )


def onecycle_schedule(
    total_steps: int,
    peak_value: float,
    pct_start: float = 0.2,
    div_factor: float = 1000.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """Cosine one-cycle (torch OneCycleLR semantics) in closed form, with both
    phases clamped to >= 1 step so tiny step counts never divide by zero."""
    init_value = peak_value / div_factor
    final_value = init_value / final_div_factor
    up = max(round(pct_start * total_steps), 1)
    down = max(total_steps - up, 1)

    def schedule(count: int) -> float:
        count = min(count, total_steps)
        if count <= up:
            up_pct = min(max(count / up, 0.0), 1.0)
            return peak_value + (init_value - peak_value) * 0.5 * (1.0 + math.cos(math.pi * up_pct))
        down_pct = min(max((count - up) / down, 0.0), 1.0)
        return final_value + (peak_value - final_value) * 0.5 * (1.0 + math.cos(math.pi * down_pct))

    return schedule


def param_role(name: str) -> str:
    """'head', 'decoder' (reconstruction-only parameters) or 'backbone'."""
    if name.startswith("heads."):
        return "head"
    if name.startswith(_DECODER_PREFIXES):
        return "decoder"
    return "backbone"


def param_labels(model: nn.Module) -> dict[str, str]:
    """Each parameter's role, by name."""
    return {name: param_role(name) for name, _ in model.named_parameters()}


def trainable_roles(phase: str) -> tuple[str, ...]:
    match phase:
        case "pretrain":
            return ("backbone", "decoder")
        case "probe":
            return ("head",)
        case "finetune":
            return ("backbone", "head")
    msg = f"Invalid phase {phase!r}."
    raise ValueError(msg)


@dataclass
class ScheduledAdamW:
    """``torch.optim.AdamW`` over the trainable parameters, with the learning
    rate of each update taken from ``schedule``."""

    adamw: torch.optim.AdamW
    schedule: Schedule

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def update(self, step: int) -> float:
        """Apply optimizer step ``step`` (from 0) with lr ``schedule(step)``."""
        lr = self.schedule(step)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        return lr


def make_optimizer(
    opt: OptConfig,
    phase: str,
    total_steps: int,
    model: nn.Module,
    num_devices: int = 1,
) -> ScheduledAdamW:
    """AdamW + closed-form OneCycle over the parameters ``phase`` trains."""
    roles = trainable_roles(phase)
    params = [p for name, p in model.named_parameters() if param_role(name) in roles]
    schedule = onecycle(opt, total_steps, num_devices)
    adamw = torch.optim.AdamW(
        params, lr=schedule(0), betas=(opt.b1, opt.b2), eps=1e-8, weight_decay=opt.wd,
    )
    return ScheduledAdamW(adamw, schedule)
