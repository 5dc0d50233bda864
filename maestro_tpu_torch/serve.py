"""Inference / serving surface (beyond the reference).

* ``make_predict_fn``  — logits function for a supervised phase.
* ``make_embed_fn``    — per-modality pooled embeddings (the SSL
  representation, for retrieval / downstream fitting without the heads).

Both returned functions take a batch of numpy arrays or tensors (as the data
pipeline emits them), move it to the model's device, and run under
``torch.inference_mode()``.  The model holds its weights (carried over from a
JAX checkpoint with ``port.from_jax.load_jax_params``); ``serving_params``
picks the EMA weights of a restored checkpoint payload when present, matching
the reference's finetune-eval semantics (base.py:263-274).  Ahead-of-time
export artifacts are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from maestro_tpu_torch.models.mae import resolve_device


def batch_to_device(model, batch: dict, device: torch.device,
                    targets: bool = False) -> dict[str, torch.Tensor]:
    """What the model reads of ``batch`` (each modality and its dates, the
    reference date) and, with ``targets``, each head's labels, as tensors on
    ``device``.  Unused modalities a loader may put in the batch are not
    copied to the device."""
    keys = ["ref_date"]
    for name in model.plan.mods:
        keys += [name, f"{name}_dates"]
    if targets:
        keys += [hs.name for hs in model.head_specs]
    out = {}
    for key in keys:
        value = batch[key]
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        out[key] = value.to(device, non_blocking=True)
    return out


def _check_model_device(model) -> torch.device:
    if not hasattr(model, "encode_streams"):
        msg = (
            f"serving needs a MaestroMAE model (got {type(model).__name__})"
        )
        raise TypeError(msg)
    return resolve_device(model.device)


def make_predict_fn(model, phase: str = "finetune") -> Callable:
    """``fn(batch) -> {head_name: logits}`` (eval mode, no autograd)."""
    if phase not in ("probe", "finetune"):
        msg = f"predict phase must be probe|finetune, got {phase!r}"
        raise ValueError(msg)
    device = _check_model_device(model)
    model.eval()

    @torch.inference_mode()
    def predict(batch):
        return model(batch_to_device(model, batch, device), phase)

    return predict


def make_embed_fn(model) -> Callable:
    """``fn(batch) -> {modality|'joint': [B, E]}`` embeddings.

    Token features are mean-pooled per modality after the shared trunk —
    the representation the probe head consumes.
    """
    device = _check_model_device(model)
    model.eval()

    @torch.inference_mode()
    def embed(batch):
        encoded = model.encode_for_heads(batch_to_device(model, batch, device))
        x = model.plan.ungroup(encoded)
        pooled = {
            # mean over tokens accumulated in fp32, result in the compute dtype
            name: v.reshape(v.shape[0], -1, v.shape[-1])
            .mean(dim=1, dtype=torch.float32).to(v.dtype)
            for name, v in x.items()
        }
        pooled["joint"] = torch.cat(
            [pooled[name] for name in model.plan.mods], dim=-1,
        )
        return pooled

    return embed


def serving_params(restored: dict[str, Any]) -> dict[str, Any]:
    """Pick eval weights from a restored checkpoint payload (EMA if saved);
    the result feeds ``port.from_jax.load_jax_params``."""
    params = restored.get("ema_params") or restored.get("params")
    if params is None:
        msg = "checkpoint payload has neither 'ema_params' nor 'params'"
        raise ValueError(msg)
    if "params" not in params:  # accept bare inner dicts
        params = {"params": params}
    return params
