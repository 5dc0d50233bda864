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

Gradient accumulation has ``optax.MultiSteps`` semantics (the JAX package
wraps its optimizer in it when ``accumulate_grad_batches > 1``): the mean
gradient of k micro-steps, one update on every k-th, and the schedule counts
updates, not micro-steps.  Layer-wise LR decay (``lw_decay``, the JAX
package's ``scale_by_lw_decay``) is a per-parameter-group multiplier of the
learning rate, so it scales the whole AdamW update, decoupled weight decay
included, as ``optax.chain(adamw, scale)`` does.  The skip-non-finite guard
(``optax.apply_if_finite``) is not ported yet: asking for it raises.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch import nn

from maestro_tpu_torch.conf.core import OptConfig, OptFinetuneConfig

Schedule = Callable[[int], float]

_DECODER_PREFIXES = ("decoders.", "enc_to_dec.", "pixelify.", "mask_tokens.")


def lr_for(opt: OptConfig, num_devices: int) -> float:
    """Sqrt batch-size scaling (the /3 keeps parity with reference runs)."""
    global_batch = opt.batch_size * opt.accumulate_grad_batches * num_devices
    return opt.base_lr * (global_batch / 3.0) ** 0.5


def onecycle(opt: OptConfig, total_steps: int, num_devices: int) -> Schedule:
    peak = lr_for(opt, num_devices)
    final_factor = opt.final_factor if isinstance(opt, OptFinetuneConfig) else 1e7
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


_BLOCK_RE = re.compile(r"block(\d+)")
_EMBED_PREFIXES = ("patch_embed", "patch_proj", "embedders")
LW_DECAY_DEPTH = 12  # the JAX package's scale_by_lw_decay default


def lw_decay_multiplier(name: str, rate: float) -> float:
    """Layer-wise LR decay multiplier of one parameter (the JAX package's
    ``scale_by_lw_decay``, reference baselines/dinov2.py:312-373): block i of
    any ``Transformer`` (stream encoders and trunk alike: the name's first
    ``block<i>`` component decides) gets ``rate ** (LW_DECAY_DEPTH - i)``,
    patch embeds ``rate ** (LW_DECAY_DEPTH + 1)``, everything else 1."""
    parts = name.split(".")
    for part in parts:
        match = _BLOCK_RE.fullmatch(part)
        if match:
            return rate ** (LW_DECAY_DEPTH - int(match.group(1)))
    if any(part.startswith(_EMBED_PREFIXES) for part in parts):
        return rate ** (LW_DECAY_DEPTH + 1)
    return 1.0


@dataclass
class ScheduledAdamW:
    """``torch.optim.AdamW`` over the trainable parameters, with the learning
    rate of each update taken from ``schedule`` (times the parameter group's
    ``lr_mult``) and ``optax.MultiSteps`` gradient accumulation over
    ``every_k`` micro-steps."""

    adamw: torch.optim.AdamW
    schedule: Schedule
    every_k: int = 1
    n_updates: int = 0  # updates applied: the schedule's count
    mini_step: int = 0  # micro-steps accumulated towards the next update
    _acc: list[torch.Tensor] | None = field(default=None, repr=False)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> bool:
        """One micro-step on the gradients the parameters hold.  On every
        ``every_k``-th, an AdamW update with the mean gradient of the
        micro-steps (a running mean, as optax's) and lr
        ``schedule(n_updates)``; returns whether it updated."""
        if self.every_k > 1:
            params = [p for group in self.adamw.param_groups for p in group["params"]]
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            if self.mini_step == 0:
                self._acc = [g.detach().clone() for g in grads]
            else:
                n = self.mini_step
                for acc, g in zip(self._acc, grads):
                    acc.add_((g - acc) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.every_k:
                return False
            for p, acc in zip(params, self._acc):
                p.grad = acc
            self._acc, self.mini_step = None, 0
        lr = self.schedule(self.n_updates)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.adamw.step()
        self.n_updates += 1
        return True


def make_optimizer(
    opt: OptConfig,
    phase: str,
    total_steps: int,
    model: nn.Module,
    num_devices: int = 1,
    skip_nonfinite: bool = False,
) -> ScheduledAdamW:
    """AdamW + closed-form OneCycle over the parameters ``phase`` trains, with
    the layer-wise LR decay of ``OptFinetuneConfig.lw_decay`` where the config
    has one.  ``total_steps`` counts updates."""
    if skip_nonfinite:
        msg = ("skip_nonfinite (the JAX package's optax.apply_if_finite) is not "
               "ported yet; train with trainer.skip_nonfinite=False")
        raise ValueError(msg)
    if opt.accumulate_grad_batches < 1:
        msg = f"accumulate_grad_batches must be >= 1, got {opt.accumulate_grad_batches}"
        raise ValueError(msg)
    rate = getattr(opt, "lw_decay", None)
    roles = trainable_roles(phase)
    groups: dict[float, list[nn.Parameter]] = {}
    for name, p in model.named_parameters():
        if param_role(name) in roles:
            mult = 1.0 if rate is None else lw_decay_multiplier(name, rate)
            groups.setdefault(mult, []).append(p)
    schedule = onecycle(opt, total_steps, num_devices)
    adamw = torch.optim.AdamW(
        [{"params": ps, "lr_mult": mult} for mult, ps in groups.items()],
        lr=schedule(0), betas=(opt.b1, opt.b2), eps=1e-8, weight_decay=opt.wd,
    )
    return ScheduledAdamW(adamw, schedule, every_k=opt.accumulate_grad_batches)
