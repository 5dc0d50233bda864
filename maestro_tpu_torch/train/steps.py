"""The pretrain train step.

One call runs the whole hot path eagerly: move the batch to the device,
resize, embed, mask, encode, decode, loss, backward, AdamW update.  The masks
of step n are drawn from a generator seeded from (seed, n), as the JAX package
folds the step count into its mask key (``fold_in(rng, state.step)``): a
restarted run draws the same masks for the same steps.  The generator lives
on the host: the masks are a few kilobytes, and drawing them there keeps the
structural mask's redraw test from waiting on the device.  Supervised steps
arrive with slice 3.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from maestro_tpu_torch.models.mae import MaestroMAE, resolve_device
from maestro_tpu_torch.ops.fused_loss import fused_reconstruction_loss
from maestro_tpu_torch.serve import batch_to_device
from maestro_tpu_torch.specs.fusion import FusionPlan
from maestro_tpu_torch.train.losses import reconstruction_loss
from maestro_tpu_torch.train.optim import ScheduledAdamW
from maestro_tpu_torch.train.state import TrainState


def mask_generator(seed: int, step: int) -> torch.Generator:
    """The (CPU) generator the masks of optimizer step ``step`` are drawn from."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, dtype=np.uint64)
    return torch.Generator().manual_seed(int(state[0] >> np.uint64(1)))


def pretrain_loss_fn(model: MaestroMAE, plan: FusionPlan, loss_type: str,
                     fused_loss: bool = True) -> Callable:
    """``loss_fn(batch, generator) -> loss`` for MAE pretraining.

    ``fused_loss=True`` reconstructs in token space (no pixel grid ever
    materialized) through the fused patch-group-norm loss; the plain path
    keeps the reference's pixel-space formulation.
    """

    def loss_fn(batch: dict, generator: torch.Generator) -> torch.Tensor:
        if fused_loss:
            rec, masks, targets = model(batch, "pretrain", False, generator=generator)
            return fused_reconstruction_loss(plan, targets, rec, masks, loss_type)
        pixels, masks, targets = model(batch, "pretrain", generator=generator)
        return reconstruction_loss(plan, targets, pixels, masks, loss_type)

    return loss_fn


def make_pretrain_step(
    model: MaestroMAE,
    plan: FusionPlan,
    tx: ScheduledAdamW,
    loss_type: str = "l1_norm",
    fused_loss: bool = True,
) -> Callable:
    """``step(state, batch, seed) -> (state, {"loss_rec": loss})``.

    ``batch`` holds numpy arrays or tensors; ``state`` (a ``TrainState`` of
    ``model`` and ``tx``) is updated in place and returned.  The loss comes
    back as a device scalar: reading it is the caller's one host sync.
    """
    device = resolve_device(model.device)
    loss_fn = pretrain_loss_fn(model, plan, loss_type, fused_loss)

    def step(state: TrainState, batch: dict, seed: int):
        if state.model is not model or state.tx is not tx:
            msg = "the train state holds another model or optimizer than this step"
            raise ValueError(msg)
        model.train()
        loss = loss_fn(batch_to_device(model, batch, device), mask_generator(seed, state.step))
        tx.zero_grad()
        loss.backward()
        tx.update(state.step)
        state.step += 1
        return state, {"loss_rec": loss.detach()}

    return step
