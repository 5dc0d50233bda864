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
included, as ``optax.chain(adamw, scale)`` does.  ``skip_nonfinite`` wraps
all of it in ``optax.apply_if_finite(tx, max_consecutive_errors=100)``, as
the JAX package does (``ScheduledAdamW``).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch import nn

from maestro_tpu_torch.conf.core import OptConfig, OptFinetuneConfig
from maestro_tpu_torch.parallel.mesh import local

_DECODER_PREFIXES = ("decoders.", "enc_to_dec.", "pixelify.", "mask_tokens.")


def lr_for(opt: OptConfig, num_devices: int) -> float:
    """Sqrt batch-size scaling (the /3 keeps parity with reference runs)."""
    global_batch = opt.batch_size * opt.accumulate_grad_batches * num_devices
    return opt.base_lr * (global_batch / 3.0) ** 0.5


def onecycle(opt: OptConfig, total_steps: int, num_devices: int) -> OneCycleSchedule:
    peak = lr_for(opt, num_devices)
    final_factor = opt.final_factor if isinstance(opt, OptFinetuneConfig) else 1e7
    return onecycle_schedule(
        total_steps=max(total_steps, 1),
        peak_value=peak,
        pct_start=0.2,
        div_factor=1000.0,
        final_div_factor=final_factor / 1000.0,
    )


@dataclass(frozen=True)
class OneCycleSchedule:
    """Cosine one-cycle (torch OneCycleLR semantics) in closed form, with both
    phases clamped to >= 1 step so tiny step counts never divide by zero.
    ``schedule(count)`` takes a Python int; ``schedule.at(count)`` a device
    tensor, for the non-finite guard whose count lives on the device."""

    total_steps: int
    peak_value: float
    init_value: float
    final_value: float
    up: int
    down: int

    def __call__(self, count: int) -> float:
        count = min(count, self.total_steps)
        if count <= self.up:
            up_pct = min(max(count / self.up, 0.0), 1.0)
            return self.peak_value + (self.init_value - self.peak_value) * 0.5 * (
                1.0 + math.cos(math.pi * up_pct))
        down_pct = min(max((count - self.up) / self.down, 0.0), 1.0)
        return self.final_value + (self.peak_value - self.final_value) * 0.5 * (
            1.0 + math.cos(math.pi * down_pct))

    def at(self, count: torch.Tensor) -> torch.Tensor:
        """The same value for a device count, as a float32 0-d tensor (both
        branches taken in float64, one selected; no host sync)."""
        c = count.to(torch.float64).clamp(max=self.total_steps)
        up_pct = (c / self.up).clamp(0.0, 1.0)
        rise = self.peak_value + (self.init_value - self.peak_value) * 0.5 * (
            1.0 + torch.cos(math.pi * up_pct))
        down_pct = ((c - self.up) / self.down).clamp(0.0, 1.0)
        fall = self.final_value + (self.peak_value - self.final_value) * 0.5 * (
            1.0 + torch.cos(math.pi * down_pct))
        return torch.where(c <= self.up, rise, fall).to(torch.float32)


def onecycle_schedule(
    total_steps: int,
    peak_value: float,
    pct_start: float = 0.2,
    div_factor: float = 1000.0,
    final_div_factor: float = 1e4,
) -> OneCycleSchedule:
    init_value = peak_value / div_factor
    up = max(round(pct_start * total_steps), 1)
    return OneCycleSchedule(total_steps, peak_value, init_value, init_value / final_div_factor,
                            up, max(total_steps - up, 1))


_WRAPPER_PREFIX = "module."  # what DDP puts before every parameter name


def unwrapped_name(name: str) -> str:
    """A parameter's name in the model itself, whatever wraps it (a DDP
    wrapper's ``module.`` prefix dropped)."""
    return name.removeprefix(_WRAPPER_PREFIX)


def param_role(name: str) -> str:
    """'head', 'decoder' (reconstruction-only parameters) or 'backbone'."""
    name = unwrapped_name(name)
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
    parts = unwrapped_name(name).split(".")
    for part in parts:
        match = _BLOCK_RE.fullmatch(part)
        if match:
            return rate ** (LW_DECAY_DEPTH - int(match.group(1)))
    if any(part.startswith(_EMBED_PREFIXES) for part in parts):
        return rate ** (LW_DECAY_DEPTH + 1)
    return 1.0


@dataclass
class NonFiniteGuard:
    """``optax.apply_if_finite``'s state, on the device: consecutive and total
    micro-steps whose gradients held an inf or NaN, and whether the last one
    was finite.  ``updates`` is the schedule's count (updates applied) and
    ``mini_step`` the accumulation's, both on the device, because whether a
    step is applied is known only there."""

    notfinite_count: torch.Tensor  # int32
    last_finite: torch.Tensor  # bool
    total_notfinite: torch.Tensor  # int32
    updates: torch.Tensor  # int32
    mini_step: torch.Tensor  # int32
    bias_step: torch.Tensor  # float32, AdamW's bias-correction count

    @classmethod
    def create(cls, device) -> "NonFiniteGuard":
        i32 = {"dtype": torch.int32, "device": device}
        return cls(torch.zeros((), **i32), torch.ones((), dtype=torch.bool, device=device),
                   torch.zeros((), **i32), torch.zeros((), **i32), torch.zeros((), **i32),
                   torch.zeros((), dtype=torch.float32, device=device))


@dataclass
class ScheduledAdamW:
    """``torch.optim.AdamW`` over the trainable parameters, with the learning
    rate of each update taken from ``schedule`` (times the parameter group's
    ``lr_mult``) and ``optax.MultiSteps`` gradient accumulation over
    ``every_k`` micro-steps.

    With ``skip_nonfinite``, ``optax.apply_if_finite(..., max_consecutive_errors)``
    wraps all of that: a micro-step whose gradients hold an inf or NaN
    changes nothing (parameters, moments, the schedule's count, the
    accumulator), unless it is past ``max_consecutive_errors`` consecutive
    such steps, when it is applied as it is.  The flag never reaches the
    host: the guard's state (``guard``) lives on the device and the update,
    written out in ``torch._foreach_*`` operations, takes its coefficients
    from the flag.  The moments are then kept in ``adamw.state[p]`` under
    torch's names (``exp_avg``, ``exp_avg_sq``)."""

    adamw: torch.optim.AdamW
    schedule: OneCycleSchedule
    every_k: int = 1
    n_updates: int = 0  # updates applied: the schedule's count (guard off)
    mini_step: int = 0  # micro-steps accumulated towards the next update (guard off)
    skip_nonfinite: bool = False
    max_consecutive_errors: int = 100  # optax.apply_if_finite's, as the JAX package sets it
    guard: NonFiniteGuard | None = None
    _acc: list[torch.Tensor] | None = field(default=None, repr=False)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def _params(self) -> list[torch.Tensor]:
        return [p for group in self.adamw.param_groups for p in group["params"]]

    def step(self) -> bool | torch.Tensor:
        """One micro-step on the gradients the parameters hold.  On every
        ``every_k``-th, an AdamW update with the mean gradient of the
        micro-steps (a running mean, as optax's) and lr
        ``schedule(n_updates)``; returns whether it updated (with
        ``skip_nonfinite``, as a device bool)."""
        if self.skip_nonfinite:
            return self._guarded_step()
        if self.every_k > 1:
            params = self._params()
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

    @torch.no_grad()
    def _guarded_step(self) -> torch.Tensor:
        # this rank's pieces of the parameters and gradients (FSDP's local
        # shards); the update is elementwise, so it runs on them as they are
        all_params = self._params()
        params = [local(p) for p in all_params]
        device = params[0].device
        if self.guard is None:
            self.guard = NonFiniteGuard.create(device)
        guard = self.guard
        grads = [torch.zeros_like(p) if q.grad is None else local(q.grad).detach()
                 for p, q in zip(params, all_params)]
        found = torch.zeros(1, dtype=torch.float32, device=device)
        # one multi-tensor pass sets `found` where any element is inf or NaN
        # (the scale of 1 leaves the gradients as they are)
        torch._amp_foreach_non_finite_check_and_unscale_(
            grads, found, torch.ones((), dtype=torch.float32, device=device))
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            # a rank sees only its pieces of the gradients: every rank skips
            # or applies the same step (queued on the device, no host sync)
            dist.all_reduce(found, op=dist.ReduceOp.MAX)
        finite = found[0] == 0
        guard.notfinite_count = torch.where(finite, 0, guard.notfinite_count + 1)
        guard.total_notfinite = torch.where(finite, guard.total_notfinite,
                                            guard.total_notfinite + 1)
        guard.last_finite = finite
        apply = finite | (guard.notfinite_count > self.max_consecutive_errors)
        # a dropped step's gradients become 0 before they meet any state (a
        # NaN times 0 is still NaN)
        grads = [torch.where(apply, g, 0.0) for g in grads]
        if self.every_k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in params]
            weight = apply.float() / (guard.mini_step + 1).float()
            delta = torch._foreach_sub(grads, self._acc)
            torch._foreach_mul_(delta, weight)
            torch._foreach_add_(self._acc, delta)
            mini = guard.mini_step + apply.int()
            update = mini == self.every_k
            guard.mini_step = torch.where(update, 0, mini)
            grads = [torch.where(update, a, 0.0) for a in self._acc]
            self._acc = [torch.where(update, 0.0, a) for a in self._acc]
        else:
            update = apply
        self._adamw_update(params, grads, update)
        return update

    def _adamw_update(self, params, grads, update: torch.Tensor) -> None:
        """AdamW (as optax's: b1 m + (1 - b1) g, the bias corrections of the
        applied count, decoupled weight decay) where ``update`` holds; where
        it does not, every coefficient leaves its tensor as it was."""
        guard, opt = self.guard, self.adamw
        u = update.float()
        lr = self.schedule.at(guard.updates)
        guard.updates = guard.updates + update.int()
        guard.bias_step = guard.bias_step + u
        t = guard.bias_step.clamp(min=1.0)  # a dropped first step divides by nothing
        i = 0
        for group in opt.param_groups:
            keys = group["params"]
            ps = params[i : i + len(keys)]
            gs = grads[i : i + len(keys)]
            i += len(keys)
            b1, b2 = group["betas"]
            states = [opt.state[p] for p in keys]
            for st, p in zip(states, ps):
                if "exp_avg" not in st:
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            m = [st["exp_avg"] for st in states]
            v = [st["exp_avg_sq"] for st in states]
            lr_g = lr * group["lr_mult"] * u
            torch._foreach_mul_(ps, 1.0 - lr_g * group["weight_decay"])
            torch._foreach_mul_(m, 1.0 - (1.0 - b1) * u)
            torch._foreach_add_(m, torch._foreach_mul(gs, (1.0 - b1) * u))
            torch._foreach_mul_(v, 1.0 - (1.0 - b2) * u)
            sq = torch._foreach_mul(gs, gs)
            torch._foreach_mul_(sq, (1.0 - b2) * u)
            torch._foreach_add_(v, sq)
            denom = torch._foreach_sqrt(v)
            torch._foreach_div_(denom, torch.sqrt(1.0 - b2**t))
            torch._foreach_add_(denom, group["eps"])
            step = torch._foreach_div(m, denom)
            torch._foreach_mul_(step, -lr_g / (1.0 - b1**t))
            torch._foreach_add_(ps, step)


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
    return ScheduledAdamW(adamw, schedule, every_k=opt.accumulate_grad_batches,
                          skip_nonfinite=skip_nonfinite)
