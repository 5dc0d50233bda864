"""Inference / serving surface (beyond the reference).

* ``make_predict_fn``  — logits function for a supervised phase, for the MAE
  and the baseline adapters alike.
* ``make_embed_fn``    — per-modality pooled embeddings (the SSL
  representation, for retrieval / downstream fitting without the heads); MAE
  models only.
* ``export_predict`` / ``save_exported`` / ``load_exported`` — ahead-of-time
  ``torch.export`` artifacts with a **symbolic batch dimension**, loadable
  without the Python model code.

The returned functions take a batch of numpy arrays or tensors (as the data
pipeline emits them), move it to the model's device, and run under
``torch.inference_mode()``.  The model holds its weights (carried over from a
JAX checkpoint with ``port.from_jax.load_jax_params``); ``serving_params``
picks the EMA weights of a restored checkpoint payload when present, matching
the reference's finetune-eval semantics (base.py:263-274).

In an artifact the parameters are inputs, keyed by the port's parameter
names (the artifact holds no weights); buffers the configuration fixes
(resize matrices, position tables) are constants in it.  The attention and
date-pool forwards are the registered ops ``torch.ops.maestro.*``
(``ops/attention.py``, ``ops/attn_pool.py``): the artifact calls them by
name, so ``load_exported`` imports their registrations first, and on the
card they launch the kernels.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

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
    return _on_device(batch, keys, device)


def _on_device(tensors, keys, device: torch.device) -> dict[str, torch.Tensor]:
    out = {}
    for key in keys:
        value = tensors[key]
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        out[key] = value.to(device, non_blocking=True)
    return out


def _model_device(model) -> torch.device:
    """The device ``model``'s parameters lie on (``cuda`` must really be
    there)."""
    return resolve_device(next(model.parameters()).device)


def _serving_fn(model, body: Callable) -> Callable:
    """``fn(batch)``: ``body`` of the batch moved to the model's device, in
    eval mode without autograd."""
    device = _model_device(model)
    model.eval()

    @torch.inference_mode()
    def fn(batch):
        return body(batch_to_device(model, batch, device))

    return fn


def _predict_body(model, phase: str) -> Callable:
    if phase not in ("probe", "finetune"):
        msg = f"predict phase must be probe|finetune, got {phase!r}"
        raise ValueError(msg)
    return lambda batch: model(batch, phase)


def _embed_body(model) -> Callable:
    if not hasattr(model, "encode_streams"):
        msg = (
            f"embeddings need a MaestroMAE model (got {type(model).__name__}:"
            " baseline adapters have no encode_streams trunk)"
        )
        raise TypeError(msg)
    return lambda batch: _embed(model, batch)


def make_predict_fn(model, phase: str = "finetune") -> Callable:
    """``fn(batch) -> {head_name: logits}`` (eval mode, no autograd); any
    model of the port, MAE or baseline adapter."""
    return _serving_fn(model, _predict_body(model, phase))


def _embed(model, batch):
    encoded = model.encode_for_heads(batch)
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


def make_embed_fn(model) -> Callable:
    """``fn(batch) -> {modality|'joint': [B, E]}`` embeddings.

    Token features are mean-pooled per modality after the shared trunk —
    the representation the probe head consumes.  MAE models only: baseline
    adapters keep their upstream backbone API and expose no shared trunk.
    """
    return _serving_fn(model, _embed_body(model))


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


# ---------------------------------------------------------------------------
# torch.export artifacts
# ---------------------------------------------------------------------------
class _Body(nn.Module):
    """``body(batch)`` as a module's forward, the model its one submodule
    (so that ``torch.func.functional_call`` can put other parameters in)."""

    def __init__(self, model, body: Callable) -> None:
        super().__init__()
        self.model, self.body = model, body

    def forward(self, batch):
        return self.body(batch)


class _ParamsIn(nn.Module):
    """The exported root: ``forward(params, batch)`` runs the body with the
    model's parameters replaced by ``params``.  The model is held outside
    the module tree, so the program keeps none of its parameters."""

    def __init__(self, model, body: Callable) -> None:
        super().__init__()
        self._held = (_Body(model, body),)

    def forward(self, params: dict[str, torch.Tensor], batch: dict[str, torch.Tensor]):
        held = self._held[0]
        return torch.func.functional_call(
            held, {f"model.{name}": t for name, t in params.items()}, (batch,))


def export_predict(
    model,
    sample_batch: dict[str, Any],
    phase: str = "finetune",
    *,
    fn: Callable | None = None,
    symbolic_batch: bool = True,
    device=None,
) -> torch.export.ExportedProgram:
    """``torch.export`` the predict function of ``phase`` (or ``"embed"``:
    ``make_embed_fn``'s function; or ``fn(batch)``, any function of the
    batch's device tensors that runs ``model``) as a program of ``(params,
    batch)``: every parameter of ``model`` by name, and the batch's model
    inputs.  A model from ``quant.quantize_params`` exports its int8 path.

    ``symbolic_batch=True`` gives every batch input one symbolic leading
    dimension (``torch.export.Dim``), so one artifact serves every batch
    size; the sample batch then needs at least 2 rows.  ``device`` is where
    the trace runs, the model's device (the default)."""
    model_device = _model_device(model)
    if device is not None and torch.device(device).type != model_device.type:
        msg = f"export traces on the model's device {model_device}, got {device}"
        raise ValueError(msg)
    if fn is None:
        fn = _embed_body(model) if phase == "embed" else _predict_body(model, phase)
    model.eval()
    batch = batch_to_device(model, sample_batch, model_device)
    params = {name: p.detach() for name, p in model.named_parameters()}
    dynamic = None
    if symbolic_batch:
        rows = {t.shape[0] for t in batch.values()}
        if len(rows) != 1 or min(rows) < 2:
            msg = f"a symbolic batch needs one batch size of at least 2 in the sample, got {rows}"
            raise ValueError(msg)
        dim = torch.export.Dim("batch", min=1)
        dynamic = ({name: None for name in params}, {key: {0: dim} for key in batch})
    with torch.no_grad():
        ep = torch.export.export(_ParamsIn(model, fn), (params, batch),
                                 dynamic_shapes=dynamic)
    # the example inputs hold every parameter, and torch.export.save would
    # write them into the artifact
    ep.example_inputs = None
    # torch.export guards every .to(dtype) with an aten._assert_tensor_metadata
    # node, hundreds in the MAE's program: host work that made a request
    # through the artifact slower than eager.  The dtypes they assert follow
    # from the inputs', which load_exported checks on entry.
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    ep.graph_module.recompile()
    return ep


def save_exported(path: str | Path, ep: torch.export.ExportedProgram) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(ep, path)
    return path


def exported_inputs(ep: torch.export.ExportedProgram) -> tuple[list[str], list[str]]:
    """The parameter names and batch keys an artifact takes."""
    spec = ep.call_spec.in_spec
    (params, batch), _ = torch.utils._pytree.tree_unflatten(
        list(range(spec.num_leaves)), spec)
    return list(params), list(batch)


def load_exported(path_or_bytes: str | Path | bytes, device=None) -> Callable:
    """Load an artifact into ``fn(params, batch) -> outputs`` on ``device``
    (``cuda`` unless ``"cpu"`` is asked for; the program is moved there).
    ``params`` maps parameter names to tensors (extra names are ignored);
    ``batch`` is numpy arrays or tensors, extra keys ignored.  Runs without
    autograd."""
    from torch.export.passes import move_to_device_pass

    # the artifact calls the ops by name: their registrations come first
    from maestro_tpu_torch.ops import attention, attn_pool  # noqa: F401

    device = resolve_device("cuda" if device is None else device)
    src = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, (bytes, bytearray))
           else path_or_bytes)
    ep = torch.export.load(src)
    ep = move_to_device_pass(ep, device)
    names, keys = exported_inputs(ep)
    placeholders = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    dtypes = [placeholders[name].meta["val"].dtype for name in ep.graph_signature.user_inputs]
    module = ep.module()

    def fn(params, batch):
        missing = [n for n in names if n not in params] + [k for k in keys if k not in batch]
        if missing:
            msg = f"the artifact's inputs are missing: {missing[:5]}"
            raise KeyError(msg)
        with torch.inference_mode():
            p, b = _on_device(params, names, device), _on_device(batch, keys, device)
            inputs = {**p, **b}
            wrong = [f"{k}: {t.dtype}, not {want}"
                     for (k, t), want in zip(inputs.items(), dtypes) if t.dtype != want]
            if wrong:
                msg = f"the artifact's inputs have other dtypes than it was traced with: {wrong[:5]}"
                raise TypeError(msg)
            return module(p, b)

    fn.program = ep
    return fn
