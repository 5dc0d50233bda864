"""Weight bridge: a flax parameter tree (numpy leaves) -> the port's modules.

``load_jax_params(module, tree)`` takes the JAX package's parameter tree as
nested dicts of numpy arrays (with or without the outer ``"params"`` key) and
fills ``module``'s parameters in place:

* Dense ``kernel [in, out]`` -> ``nn.Linear.weight [out, in]`` (transposed);
* LayerNorm ``scale`` / ``bias`` -> ``weight`` / ``bias``;
* ``PatchEmbed`` ``norm{g}_scale`` / ``norm{g}_bias`` and ``query`` keep
  their names;
* MaestroMAE's dict-valued attributes (``encoders_<stream>``,
  ``patch_embed_<mod>``, ``heads_<target>`` ...) -> ``encoders.<stream>`` ...;
  ``mask_token_<mod>`` -> ``mask_tokens.<mod>``.

It is strict both ways: a flax leaf that maps to no parameter, a shape that
disagrees, or a parameter left unfilled raises and lists the names.  A flax
``init`` in one phase creates only that phase's parameters, so a caller may
list parameter-name prefixes that are allowed to stay unfilled.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch
from torch import nn

# MaestroMAE attributes that hold a dict of submodules: flax names them
# "<attribute>_<key>", nn.ModuleDict "<attribute>.<key>".
_DICT_ATTRS = (
    "patch_embed", "pixelify", "encoders", "enc_to_dec", "decoders", "heads",
)
_LEAF_RENAMES = {"kernel": "weight", "scale": "weight"}


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _target_name(path: tuple[str, ...]) -> tuple[str, bool]:
    """(state-dict name, transpose?) of one flax leaf path."""
    head, *rest = path
    if head.startswith("mask_token_"):
        parts = ["mask_tokens", head[len("mask_token_"):]]
    else:
        parts = [head]
        for attr in _DICT_ATTRS:
            if head.startswith(attr + "_"):
                parts = [attr, head[len(attr) + 1:]]
                break
    parts += rest
    leaf = parts[-1]
    parts[-1] = _LEAF_RENAMES.get(leaf, leaf)
    return ".".join(parts), leaf == "kernel"


def load_jax_params(
    module: nn.Module,
    tree: Mapping[str, Any],
    missing_ok: Iterable[str] = (),
) -> None:
    """Fill ``module``'s parameters from a flax tree of numpy arrays."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    params = dict(module.named_parameters())
    unknown, mismatched, filled = [], [], set()
    with torch.no_grad():
        for path, value in _flatten(tree):
            name, transpose = _target_name(path)
            param = params.get(name)
            if param is None:
                unknown.append("/".join(path))
                continue
            if transpose:
                value = value.T
            if tuple(value.shape) != tuple(param.shape):
                mismatched.append(
                    f"{'/'.join(path)} {tuple(value.shape)} -> {name} {tuple(param.shape)}",
                )
                continue
            param.copy_(torch.from_numpy(np.ascontiguousarray(value)).to(param.dtype))
            filled.add(name)
    allowed = tuple(missing_ok)
    unfilled = [
        name for name in params
        if name not in filled and not name.startswith(allowed)
    ]
    if unknown or mismatched or unfilled:
        msg = (
            "load_jax_params: the trees do not match.\n"
            f"  flax leaves with no parameter: {unknown}\n"
            f"  shape mismatches: {mismatched}\n"
            f"  parameters left unfilled: {unfilled}"
        )
        raise KeyError(msg)
