"""Port reference (torch / vit-pytorch) MAESTRO checkpoints to the port's MAE.

The port's copy of the JAX package's ``port/torch_port.py``.  The released
checkpoints (HuggingFace ``IGNF/MAESTRO_*``, reference README.md:37-39) are
pytorch-lightning .ckpt files whose ``state_dict`` uses the reference module
layout (ssl/mae.py + layers/embed.py + layers/head.py, with vit-pytorch
Transformer naming: ``layers.{i}.0`` = attention, ``layers.{i}.1`` = MLP,
MLP Sequential indices 0/1/4 = LN/fc1/fc2).  ``port_mae_state_dict`` maps
those tensors onto the MAE's flax-named tree, leaf for leaf as the JAX
package does:

  torch Conv2d(k=p, s=p) [E, C, p, p]  ->  Dense kernel [C*p*p, E]
  torch Linear [out, in]               ->  Dense kernel [in, out]
  GroupNorm(1) weight/bias             ->  norm{g}_scale / norm{g}_bias
  Pixelify 1x1 conv [C*p^2, E, 1, 1]   ->  Dense kernel [E, C*p^2]

``merge_into_template`` lays such a tree onto a module strict=False through
``port/from_jax.match_jax_params`` (the one place where a flax name becomes a
parameter): unmatched leaves are reported, not fatal, as the reference's
run_experiment.py:66-74 warm starts have it.  ``reference_state_dict`` is the
inverse of ``port_mae_state_dict``: a module's parameters under the
reference's keys, which makes a release-layout checkpoint from seeded weights.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch
from torch import nn

from maestro_tpu_torch.port.from_jax import flax_names, jax_tree, match_jax_params

log = logging.getLogger("maestro_tpu_torch.port")


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """Load a torch .ckpt/.pth into numpy (lightning 'state_dict' unwrapped).

    A lightning .ckpt pickles its hyperparameters and loop state beside the
    tensors, so it is read with ``weights_only=False``: load only files you
    trust (the port's own checkpoints are read with ``weights_only=True``)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in state.items()}


def _conv_to_dense(w: np.ndarray) -> np.ndarray:
    """[E, C, p, p] -> [C*p*p, E] (feature order (C, ph, pw))."""
    e = w.shape[0]
    return w.reshape(e, -1).T


def _pixelify_kernel(w: np.ndarray, patch: int, channels: int) -> np.ndarray:
    """Pixelify 1x1 conv [C*p*p, E, 1, 1] -> Dense kernel [E, C*p*p].

    The reference pixel-shuffles with output features in (ph, pw, C) order
    ("(p1 p2 c) h w", embed.py:154-160); maestro_tpu token space uses
    (C, ph, pw) everywhere, so the output features are permuted here.
    """
    dense = w[:, :, 0, 0].T  # [E, out] in (ph, pw, C) order
    e = dense.shape[0]
    out = dense.reshape(e, patch, patch, channels)
    return out.transpose(0, 3, 1, 2).reshape(e, -1)


def _pixelify_bias(b: np.ndarray, patch: int, channels: int) -> np.ndarray:
    """(ph, pw, C)-ordered bias -> (C, ph, pw)."""
    return b.reshape(patch, patch, channels).transpose(2, 0, 1).reshape(-1)


def _linear(w: np.ndarray) -> np.ndarray:
    return w.T


def map_transformer(src: dict, prefix: str, depth: int) -> dict[str, Any]:
    """vit-pytorch Transformer -> models/vit.py Transformer params."""
    out: dict[str, Any] = {}
    for i in range(depth):
        attn, mlp = f"{prefix}layers.{i}.0.", f"{prefix}layers.{i}.1."
        out[f"block{i}"] = {
            "attn": {
                "norm": {"scale": src[f"{attn}norm.weight"],
                         "bias": src[f"{attn}norm.bias"]},
                "qkv": {"kernel": _linear(src[f"{attn}to_qkv.weight"])},
                "out": {"kernel": _linear(src[f"{attn}to_out.0.weight"]),
                        "bias": src[f"{attn}to_out.0.bias"]},
            },
            "mlp": {
                "norm": {"scale": src[f"{mlp}net.0.weight"],
                         "bias": src[f"{mlp}net.0.bias"]},
                "fc1": {"kernel": _linear(src[f"{mlp}net.1.weight"]),
                        "bias": src[f"{mlp}net.1.bias"]},
                "fc2": {"kernel": _linear(src[f"{mlp}net.4.weight"]),
                        "bias": src[f"{mlp}net.4.bias"]},
            },
        }
    out["norm"] = {"scale": src[f"{prefix}norm.weight"],
                   "bias": src[f"{prefix}norm.bias"]}
    return out


def map_attentive_reduce(src: dict, prefix: str) -> dict[str, Any]:
    return {
        "norm": {"scale": src[f"{prefix}norm.weight"],
                 "bias": src[f"{prefix}norm.bias"]},
        "norm_fc": {"scale": src[f"{prefix}norm_fc.weight"],
                    "bias": src[f"{prefix}norm_fc.bias"]},
        "to_kv": {"kernel": _linear(src[f"{prefix}to_kv.weight"])},
        "query": src[f"{prefix}query"],
    }


def port_mae_state_dict(
    src: dict[str, np.ndarray],
    plan,
    head_specs=(),
    torch_prefix: str = "model.",
) -> dict[str, Any]:
    """Reference MAE state dict -> {'params': ...} tree for MaestroMAE."""
    src = {k.removeprefix(torch_prefix): v for k, v in src.items()
           if k.startswith(torch_prefix)}
    params: dict[str, Any] = {}

    embeds_done = set()
    for name, spec in plan.mod_specs.items():
        embed = spec.name_embed
        if embed in embeds_done:
            continue
        embeds_done.add(embed)
        pe: dict[str, Any] = {}
        pr: dict[str, Any] = {}
        for g in range(spec.len_bands):
            conv = f"patch_embed.{embed}.patchify_bands.{g}."
            pe[f"proj{g}"] = {
                "kernel": _conv_to_dense(src[f"{conv}conv.weight"]),
                "bias": src[f"{conv}conv.bias"],
            }
            pe[f"norm{g}_scale"] = src[f"{conv}norm.weight"]
            pe[f"norm{g}_bias"] = src[f"{conv}norm.bias"]
            rec = f"embed_to_rec.{embed}.pixelify_bands.{g}."
            chans = spec.band_groups[g]
            pr[f"proj{g}"] = {
                "kernel": _pixelify_kernel(
                    src[f"{rec}conv.weight"], spec.patch_size, chans,
                ),
                "bias": _pixelify_bias(
                    src[f"{rec}conv.bias"], spec.patch_size, chans,
                ),
            }
        params[f"patch_embed_{embed}"] = pe
        params[f"pixelify_{embed}"] = pr

    for name in plan.mods:
        key = f"mask_token.{name}"
        if key in src:
            params[f"mask_token_{name}"] = src[key]

    for enc in plan.encoder_names:
        if f"encoder.{enc}.norm.weight" in src:
            depth = _count_blocks(src, f"encoder.{enc}.layers.")
            params[f"encoders_{enc}"] = map_transformer(
                src, f"encoder.{enc}.", depth,
            )
        if f"enc_to_dec.{enc}.weight" in src:
            params[f"enc_to_dec_{enc}"] = {
                "kernel": _linear(src[f"enc_to_dec.{enc}.weight"]),
                "bias": src[f"enc_to_dec.{enc}.bias"],
            }
        if f"decoder.{enc}.norm.weight" in src:
            depth = _count_blocks(src, f"decoder.{enc}.layers.")
            params[f"decoders_{enc}"] = map_transformer(
                src, f"decoder.{enc}.", depth,
            )
    if "encoder_inter.norm.weight" in src:
        depth = _count_blocks(src, "encoder_inter.layers.")
        params["encoder_inter"] = map_transformer(src, "encoder_inter.", depth)

    for hs in head_specs:
        prefix = f"heads.{hs.name}."
        if f"{prefix}linear.weight" in src:  # classification head
            head = {
                "linear": {"kernel": _linear(src[f"{prefix}linear.weight"]),
                           "bias": src[f"{prefix}linear.bias"]},
            }
            if f"{prefix}reduce.query" in src:
                head["reduce"] = map_attentive_reduce(src, f"{prefix}reduce.")
            params[f"heads_{hs.name}"] = head
        elif f"{prefix}conv.weight" in src:  # pixelify (segmentation) head
            head = {
                "proj": {
                    "kernel": _pixelify_kernel(
                        src[f"{prefix}conv.weight"], hs.pixel_patch,
                        hs.num_classes,
                    ),
                    "bias": _pixelify_bias(
                        src[f"{prefix}conv.bias"], hs.pixel_patch,
                        hs.num_classes,
                    ),
                },
            }
            if f"{prefix}reduce.query" in src:
                head["reduce"] = map_attentive_reduce(src, f"{prefix}reduce.")
            params[f"heads_{hs.name}"] = head

    return {"params": params}


def _count_blocks(src: dict, prefix: str) -> int:
    idxs = set()
    for k in src:
        if k.startswith(prefix):
            idxs.add(int(k[len(prefix):].split(".")[0]))
    return max(idxs) + 1 if idxs else 0


def merge_into_template(
    ported: dict[str, Any], template: nn.Module,
) -> tuple[dict[str, torch.Tensor], list[str], list[str]]:
    """Lay a ported flax-named tree onto ``template`` (strict=False).

    Returns ``(params, used, missing)``: the ported values of the parameters
    whose flax path and shape match, by parameter name, as fp32 tensors on the
    CPU; the flax paths of those leaves; the flax paths of the parameters that
    keep their fresh values.  A ported leaf that fits no parameter is left out.
    The values are copied into ``template`` unless it is a ``meta`` module
    (a template of shapes only, as the port CLIs build it)."""
    values = match_jax_params(template, ported)[0]
    out = {name: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
           for name, v in values.items()}
    used, missing = [], []
    for path, (name, _) in flax_names(template).items():
        (used if name in out else missing).append("/".join(path))
    with torch.no_grad():
        for name, p in template.named_parameters():
            if name in out and not p.is_meta:
                p.copy_(out[name])
    if missing:
        log.info("port: %d leaves matched, %d kept fresh init", len(used), len(missing))
    return out, used, missing


def reference_state_dict(model: nn.Module, heads: bool = True,
                         torch_prefix: str = "model.") -> dict[str, np.ndarray]:
    """The inverse of ``port_mae_state_dict``: ``model``'s parameters (a
    ``MaestroMAE``) under the reference's lightning keys, float32 numpy.
    ``heads=False`` leaves the downstream heads out, as a pretraining release
    would carry none the dataset's heads could use."""
    plan = model.plan
    p = jax_tree(model)["params"]
    src: dict[str, np.ndarray] = {}

    def spec_of(embed):
        return next(s for s in plan.mod_specs.values() if s.name_embed == embed)

    def put_transformer(prefix, tree):
        depth = len([k for k in tree if k.startswith("block")])
        for i in range(depth):
            blk = tree[f"block{i}"]
            a, m = f"{prefix}layers.{i}.0.", f"{prefix}layers.{i}.1."
            src[f"{a}norm.weight"] = blk["attn"]["norm"]["scale"]
            src[f"{a}norm.bias"] = blk["attn"]["norm"]["bias"]
            src[f"{a}to_qkv.weight"] = blk["attn"]["qkv"]["kernel"].T
            src[f"{a}to_out.0.weight"] = blk["attn"]["out"]["kernel"].T
            src[f"{a}to_out.0.bias"] = blk["attn"]["out"]["bias"]
            src[f"{m}net.0.weight"] = blk["mlp"]["norm"]["scale"]
            src[f"{m}net.0.bias"] = blk["mlp"]["norm"]["bias"]
            src[f"{m}net.1.weight"] = blk["mlp"]["fc1"]["kernel"].T
            src[f"{m}net.1.bias"] = blk["mlp"]["fc1"]["bias"]
            src[f"{m}net.4.weight"] = blk["mlp"]["fc2"]["kernel"].T
            src[f"{m}net.4.bias"] = blk["mlp"]["fc2"]["bias"]
        src[f"{prefix}norm.weight"] = tree["norm"]["scale"]
        src[f"{prefix}norm.bias"] = tree["norm"]["bias"]

    def put_reduce(prefix, r):
        src[f"{prefix}norm.weight"] = r["norm"]["scale"]
        src[f"{prefix}norm.bias"] = r["norm"]["bias"]
        src[f"{prefix}norm_fc.weight"] = r["norm_fc"]["scale"]
        src[f"{prefix}norm_fc.bias"] = r["norm_fc"]["bias"]
        src[f"{prefix}to_kv.weight"] = r["to_kv"]["kernel"].T
        src[f"{prefix}query"] = r["query"]

    head_specs = {hs.name: hs for hs in model.head_specs}
    for key, tree in p.items():
        if key.startswith("patch_embed_"):
            embed = key.removeprefix("patch_embed_")
            spec = spec_of(embed)
            for g, c in enumerate(spec.band_groups):
                conv = f"patch_embed.{embed}.patchify_bands.{g}."
                pp = spec.patch_size
                src[f"{conv}conv.weight"] = tree[f"proj{g}"]["kernel"].T.reshape(-1, c, pp, pp)
                src[f"{conv}conv.bias"] = tree[f"proj{g}"]["bias"]
                src[f"{conv}norm.weight"] = tree[f"norm{g}_scale"]
                src[f"{conv}norm.bias"] = tree[f"norm{g}_bias"]
        elif key.startswith("pixelify_"):
            embed = key.removeprefix("pixelify_")
            spec = spec_of(embed)
            for g, c in enumerate(spec.band_groups):
                rec = f"embed_to_rec.{embed}.pixelify_bands.{g}."
                w, b = _unpixelify(tree[f"proj{g}"], spec.patch_size, c)
                src[f"{rec}conv.weight"], src[f"{rec}conv.bias"] = w, b
        elif key.startswith("mask_token_"):
            src[f"mask_token.{key.removeprefix('mask_token_')}"] = tree
        elif key.startswith("encoders_"):
            put_transformer(f"encoder.{key.removeprefix('encoders_')}.", tree)
        elif key.startswith("decoders_"):
            put_transformer(f"decoder.{key.removeprefix('decoders_')}.", tree)
        elif key == "encoder_inter":
            put_transformer("encoder_inter.", tree)
        elif key.startswith("enc_to_dec_"):
            name = key.removeprefix("enc_to_dec_")
            src[f"enc_to_dec.{name}.weight"] = tree["kernel"].T
            src[f"enc_to_dec.{name}.bias"] = tree["bias"]
        elif key.startswith("heads_") and heads:
            name = key.removeprefix("heads_")
            pre = f"heads.{name}."
            if "linear" in tree:
                src[f"{pre}linear.weight"] = tree["linear"]["kernel"].T
                src[f"{pre}linear.bias"] = tree["linear"]["bias"]
            if "proj" in tree:  # the segmentation head's pixelify conv
                hs = head_specs[name]
                w, b = _unpixelify(tree["proj"], hs.pixel_patch, hs.num_classes)
                src[f"{pre}conv.weight"], src[f"{pre}conv.bias"] = w, b
            if "reduce" in tree:
                put_reduce(f"{pre}reduce.", tree["reduce"])
    return {f"{torch_prefix}{k}": np.ascontiguousarray(v, dtype=np.float32)
            for k, v in src.items()}


def _unpixelify(dense: dict, patch: int, channels: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense kernel [E, C*p*p] and bias in (C, ph, pw) order -> the reference's
    1x1 conv [C*p*p, E, 1, 1] and bias in pixel-shuffle (ph, pw, C) order."""
    kern = dense["kernel"]
    e = kern.shape[0]
    k = kern.reshape(e, channels, patch, patch).transpose(0, 2, 3, 1)
    bias = dense["bias"].reshape(channels, patch, patch).transpose(1, 2, 0).reshape(-1)
    return k.reshape(e, -1).T[:, :, None, None], bias
