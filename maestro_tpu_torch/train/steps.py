"""Train and eval steps of the three phases.

One call of a train step runs the whole hot path eagerly: move the batch to
the device, resize, embed, (mask,) encode, (decode,) loss, backward, AdamW
update.  The masks of pretrain step n are drawn from a generator seeded from
(seed, n), as the JAX package folds the step count into its mask key
(``fold_in(rng, state.step)``): a restarted run draws the same masks for the
same steps.  The generator lives on the host: the masks are a few kilobytes,
and drawing them there keeps the structural mask's redraw test from waiting
on the device.

The supervised (probe / finetune) steps take the prediction losses and update
the metric states on the device; finetune evaluation runs the EMA weights
through ``torch.func.functional_call``, leaving the trained weights alone.
No step reads a value back to the host: losses come back as device scalars.

Under data parallelism (``parallel``: a ``parallel.mesh.Parallel``) a step
takes this rank's rows of the global batch, calls ``parallel.module`` (the
phase's DDP wrapper, or the FSDP / tensor-parallel model), and gives the
gradients of the global batch, as the JAX package's jit over sharded arrays
does: the pretrain masks are drawn for the global batch and the rank keeps
its rows, each loss divides by the global batch's count and is scaled by the
data-parallel size, which the gradient average divides back out.  The loss
it returns is the global batch's.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from maestro_tpu_torch.models.mae import MaestroMAE, resolve_device
from maestro_tpu_torch.ops.fused_loss import fused_reconstruction_loss
from maestro_tpu_torch.serve import batch_to_device
from maestro_tpu_torch.specs.fusion import FusionPlan
from maestro_tpu_torch.train import metrics as M
from maestro_tpu_torch.train.losses import prediction_losses, reconstruction_loss
from maestro_tpu_torch.train.optim import ScheduledAdamW
from maestro_tpu_torch.train.state import TrainState, swapped_params


def _check_state(state: TrainState, model, tx) -> None:
    if state.model is not model or state.tx is not tx:
        msg = "the train state holds another model or optimizer than this step"
        raise ValueError(msg)


def mask_generator(seed: int, step: int) -> torch.Generator:
    """The (CPU) generator the masks of optimizer step ``step`` are drawn from."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, dtype=np.uint64)
    return torch.Generator().manual_seed(int(state[0] >> np.uint64(1)))


def pretrain_loss_fn(model: MaestroMAE, plan: FusionPlan, loss_type: str,
                     fused_loss: bool = True, parallel=None, forward=None) -> Callable:
    """``loss_fn(batch, generator) -> loss`` for MAE pretraining.

    ``fused_loss=True`` reconstructs in token space (no pixel grid ever
    materialized) through the fused patch-group-norm loss; the plain path
    keeps the reference's pixel-space formulation.  With ``parallel`` the
    batch is this rank's rows and the loss its part of the global batch's;
    ``forward`` is the module called (default ``parallel.module``).
    """
    if forward is None:
        forward = model if parallel is None else parallel.module
    reduce = None if parallel is None else parallel.count_reduce

    def loss_fn(batch: dict, generator: torch.Generator) -> torch.Tensor:
        kw = {"generator": generator}
        if parallel is not None:
            kw["mask_rows"] = parallel.rows(next(iter(batch.values())).shape[0])
        if fused_loss:
            rec, masks, targets = forward(batch, "pretrain", False, **kw)
            return fused_reconstruction_loss(plan, targets, rec, masks, loss_type,
                                             count_reduce=reduce)
        pixels, masks, targets = forward(batch, "pretrain", **kw)
        return reconstruction_loss(plan, targets, pixels, masks, loss_type, reduce)

    return loss_fn


def _backward(loss: torch.Tensor, parallel) -> torch.Tensor:
    """``loss.backward()`` (scaled by the data-parallel size); returns the
    global batch's loss, detached."""
    if parallel is None:
        loss.backward()
        return loss.detach()
    (loss * parallel.loss_scale).backward()
    return parallel.global_loss(loss)


def make_pretrain_step(
    model: MaestroMAE,
    plan: FusionPlan,
    tx: ScheduledAdamW,
    loss_type: str = "l1_norm",
    fused_loss: bool = True,
    parallel=None,
) -> Callable:
    """``step(state, batch, seed) -> (state, {"loss_rec": loss})``.

    ``batch`` holds numpy arrays or tensors; ``state`` (a ``TrainState`` of
    ``model`` and ``tx``) is updated in place and returned.  The loss comes
    back as a device scalar: reading it is the caller's one host sync.
    """
    device = resolve_device(model.device)
    loss_fn = pretrain_loss_fn(model, plan, loss_type, fused_loss, parallel)

    def step(state: TrainState, batch: dict, seed: int):
        _check_state(state, model, tx)
        model.train()
        loss = loss_fn(batch_to_device(model, batch, device), mask_generator(seed, state.step))
        tx.zero_grad()
        loss = _backward(loss, parallel)
        tx.step()
        state.step += 1
        return state, {"loss_rec": loss}

    return step


def make_pretrain_eval_step(model: MaestroMAE, plan: FusionPlan,
                            loss_type: str = "l1_norm", parallel=None) -> Callable:
    """``step(state, batch, seed, index=0) -> {"loss_rec": loss}``: the
    pretrain validation loss, no update.  Masks are drawn from
    ``mask_generator(seed, index)`` (the JAX runtime folds the batch index
    into its validation key); the loss is the pixel-space
    ``reconstruction_loss``, as the JAX package's eval step takes it."""
    device = resolve_device(model.device)
    # an eval step calls the model itself, never a DDP wrapper
    loss_fn = pretrain_loss_fn(model, plan, loss_type, False, parallel, forward=model)

    @torch.no_grad()
    def step(state: TrainState, batch: dict, seed: int, index: int = 0):
        if state.model is not model:
            msg = "the train state holds another model than this step"
            raise ValueError(msg)
        model.eval()
        loss = loss_fn(batch_to_device(model, batch, device), mask_generator(seed, index))
        return {"loss_rec": loss if parallel is None else parallel.global_loss(loss)}

    return step


def _check_phase(phase: str) -> None:
    if phase not in ("probe", "finetune"):
        msg = f"supervised phase must be probe|finetune, got {phase!r}"
        raise ValueError(msg)


def _update_metrics(head_specs, metric_states: dict, aux: dict) -> dict:
    with torch.no_grad():
        for hs in head_specs:
            M.metric_update(hs.type_target, metric_states[hs.name], aux[hs.name])
    return metric_states


def make_supervised_step(model: MaestroMAE, phase: str, tx: ScheduledAdamW,
                         parallel=None) -> Callable:
    """``step(state, batch, metric_states) -> (state, metric_states,
    {"loss_pred": loss})`` for the probe or finetune phase.

    ``batch`` holds numpy arrays or tensors, targets included.  The probe
    phase runs the trunk without autograd (its parameters are frozen);
    ``tx`` trains the phase's roles.  ``state`` and the metric states are
    updated in place and returned."""
    _check_phase(phase)
    device = resolve_device(model.device)
    head_specs = model.head_specs
    forward = model if parallel is None else parallel.module
    reduce = None if parallel is None else parallel.count_reduce

    def step(state: TrainState, batch: dict, metric_states: dict):
        _check_state(state, model, tx)
        model.train()
        batch = batch_to_device(model, batch, device, targets=True)
        loss, aux = prediction_losses(head_specs, batch, forward(batch, phase), reduce)
        tx.zero_grad()
        loss = _backward(loss, parallel)
        tx.step()
        state.step += 1
        return state, _update_metrics(head_specs, metric_states, aux), {"loss_pred": loss}

    return step


def _eval_params(state: TrainState, use_ema: bool) -> dict[str, torch.Tensor] | None:
    return state.ema if use_ema and state.ema is not None else None


def _call(model, params, args, kwargs=None):
    """``model(*args, **kwargs)`` with ``params`` (EMA weights by name, this
    rank's pieces) standing in for the trained ones for this call only.
    FSDP gathers the parameters it holds, so there the pieces are swapped in
    and back; elsewhere ``functional_call`` leaves the parameters alone."""
    kwargs = kwargs or {}
    if params is None:
        return model(*args, **kwargs)
    if not hasattr(next(iter(model.parameters())), "to_local"):
        return functional_call(model, params, args, kwargs)
    with swapped_params(model, params):
        return model(*args, **kwargs)


def make_supervised_eval_step(model: MaestroMAE, phase: str, use_ema: bool = False,
                              parallel=None) -> Callable:
    """``step(state, batch, metric_states) -> (metric_states, {"loss_pred"})``;
    with ``use_ema`` (finetune val/test) the EMA weights, when the state has
    them, stand in for the trained ones for this call only.  With
    ``parallel`` the loss is the global batch's and the metric states keep
    this rank's counts (the caller sums them before ``compute_metrics``)."""
    _check_phase(phase)
    device = resolve_device(model.device)
    head_specs = model.head_specs
    reduce = None if parallel is None else parallel.count_reduce

    @torch.no_grad()
    def step(state: TrainState, batch: dict, metric_states: dict):
        model.eval()
        batch = batch_to_device(model, batch, device, targets=True)
        logits = _call(model, _eval_params(state, use_ema), (batch, phase))
        loss, aux = prediction_losses(head_specs, batch, logits, reduce)
        return (_update_metrics(head_specs, metric_states, aux),
                {"loss_pred": loss if parallel is None else parallel.global_loss(loss)})

    return step


def make_feature_step(model: MaestroMAE) -> Callable:
    """``fn(batch) -> encoded``: the frozen-trunk forward
    (``encode_for_heads``) whose output the head-eval step consumes."""
    device = resolve_device(model.device)

    @torch.no_grad()
    def features(batch: dict) -> dict[str, torch.Tensor]:
        model.eval()
        return model.encode_for_heads(batch_to_device(model, batch, device))

    return features


def make_head_eval_step(model: MaestroMAE, phase: str, use_ema: bool = False) -> Callable:
    """``step(state, encoded, labels, metric_states) -> (metric_states,
    {"loss_pred"})``: the eval step over precomputed trunk features (heads,
    losses, metrics); ``labels`` holds each head's targets by name."""
    _check_phase(phase)
    device = resolve_device(model.device)
    head_specs = model.head_specs

    @torch.no_grad()
    def step(state: TrainState, encoded: dict, labels: dict, metric_states: dict):
        model.eval()
        labels = {hs.name: torch.as_tensor(labels[hs.name]).to(device) for hs in head_specs}
        logits = _call(model, _eval_params(state, use_ema), (encoded, phase),
                       {"from_features": True})
        loss, aux = prediction_losses(head_specs, labels, logits)
        return _update_metrics(head_specs, metric_states, aux), {"loss_pred": loss}

    return step


def init_metric_states(head_specs, device="cuda") -> dict[str, Any]:
    device = resolve_device(device)
    return {hs.name: M.metric_init(hs.type_target, hs.num_classes, device) for hs in head_specs}


def compute_metrics(head_specs, metric_states) -> dict[str, dict[str, float]]:
    return {hs.name: M.metric_compute(hs.type_target, metric_states[hs.name])
            for hs in head_specs}
