"""Weight bridge: a flax parameter tree (numpy leaves) -> the port's modules.

``load_jax_params(module, tree)`` takes the JAX package's parameter tree as
nested dicts of numpy arrays (with or without the outer ``"params"`` key) and
fills ``module``'s parameters in place.  Each parameter's flax path follows
from the module tree (``flax_path``):

* a submodule or parameter is one path component under its attribute name;
* the members of an ``nn.ModuleDict`` / ``nn.ModuleList`` / ``nn.ParameterDict``
  join their container's name with ``"_"``, as flax names the members of a
  dict or list attribute (``encoders_<stream>``, ``heads_<target>``,
  ``blocks_shared_0``, DINOv2's ``cls_<mod>``); MaestroMAE's ``mask_tokens``
  are flax's ``mask_token_<mod>``;
* a ``nn.Linear`` weight is the Dense ``kernel`` (transposed), a
  ``nn.LayerNorm`` weight its ``scale``; every other leaf keeps its name
  (``bias``, ``query``, ``PatchEmbed``'s ``norm{g}_scale``, LayerScale's
  ``ls1``, DOFA's ``weight_tokens`` ...).

It is strict both ways: a flax leaf that maps to no parameter, a shape that
disagrees, or a parameter left unfilled raises and lists the names.  A flax
``init`` in one phase creates only that phase's parameters, so a caller may
list parameter-name prefixes that are allowed to stay unfilled.
``match_jax_params`` is the pairing both use, and the strict=False merge of a
ported release (``port/torch_port.merge_into_template``) uses it too;
``jax_tree`` goes the other way.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch
from torch import nn

_CONTAINERS = (nn.ModuleDict, nn.ModuleList, nn.ParameterDict, nn.ParameterList)
# attribute names flax spells otherwise (an int8 layer's scale: quant.py)
_FLAX_ATTRS = {"mask_tokens": "mask_token", "weight_scale": "kernel_scale"}


def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _unwrapped(module: nn.Module) -> nn.Module:
    """The model inside a DDP wrapper (whose names carry a ``module.``
    prefix); any other module as it is."""
    from torch.nn.parallel import DistributedDataParallel

    while isinstance(module, DistributedDataParallel):
        module = module.module
    return module


def flax_path(module: nn.Module, name: str) -> tuple[tuple[str, ...], bool]:
    """(flax path, transpose?) of the parameter ``name`` of ``module`` (a DDP
    wrapper reads as the model inside it)."""
    if module is not _unwrapped(module):
        module, name = _unwrapped(module), name.removeprefix("module.")
    path: list[str] = []
    owner: nn.Module = module
    parts = name.split(".")
    for i, part in enumerate(parts):
        if isinstance(owner, _CONTAINERS) and path:
            path[-1] = f"{path[-1]}_{part}"
        else:
            path.append(_FLAX_ATTRS.get(part, part))
        if i < len(parts) - 1:
            owner = owner._modules[part]
    transpose = False
    if parts[-1] == "weight" and not isinstance(owner, _CONTAINERS):
        transpose = isinstance(owner, nn.Linear)
        path[-1] = "kernel" if transpose else "scale"
    return tuple(path), transpose


def flax_names(module: nn.Module) -> dict[tuple[str, ...], tuple[str, bool]]:
    """Flax path -> (parameter name, transpose?) of every parameter of ``module``."""
    module = _unwrapped(module)
    out = {}
    for name, _ in module.named_parameters():
        path, transpose = flax_path(module, name)
        out[path] = (name, transpose)
    return out


def match_jax_params(
    module: nn.Module, tree: Mapping[str, Any],
) -> tuple[dict[str, np.ndarray], list[str], list[str], list[str]]:
    """Pair the leaves of a flax tree with ``module``'s parameters by flax path.

    Returns ``(values, unknown, mismatched, unfilled)``: the value of every
    parameter whose leaf exists with the parameter's shape (a Dense kernel
    already transposed), by parameter name; the flax paths that map to no
    parameter; the pairs whose shapes disagree; the parameters no leaf fills.
    """
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    module = _unwrapped(module)
    leaves = dict(_flatten(tree))
    params = dict(module.named_parameters())
    values: dict[str, np.ndarray] = {}
    mismatched, unfilled = [], []
    for path, (name, transpose) in flax_names(module).items():
        value = leaves.pop(path, None)
        if value is None:
            unfilled.append(name)
            continue
        if transpose:
            value = value.T
        if tuple(value.shape) != tuple(params[name].shape):
            mismatched.append(
                f"{'/'.join(path)} {tuple(value.shape)} -> {name} {tuple(params[name].shape)}",
            )
            continue
        values[name] = value
    return values, ["/".join(path) for path in leaves], mismatched, unfilled


def load_jax_params(
    module: nn.Module,
    tree: Mapping[str, Any],
    missing_ok: Iterable[str] = (),
) -> None:
    """Fill ``module``'s parameters from a flax tree of numpy arrays."""
    values, unknown, mismatched, unfilled = match_jax_params(module, tree)
    unfilled = [name for name in unfilled if not name.startswith(tuple(missing_ok))]
    if unknown or mismatched or unfilled:
        msg = (
            "load_jax_params: the trees do not match.\n"
            f"  flax leaves with no parameter: {unknown}\n"
            f"  shape mismatches: {mismatched}\n"
            f"  parameters left unfilled: {unfilled}"
        )
        raise KeyError(msg)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, value in values.items():
            params[name].copy_(torch.tensor(value, dtype=params[name].dtype))


def jax_tree(module: nn.Module) -> dict[str, Any]:
    """``module``'s parameters as a flax tree of float32 numpy arrays under
    ``"params"`` (the inverse of ``load_jax_params``)."""
    tree: dict[str, Any] = {}
    params = dict(module.named_parameters())
    for path, (name, transpose) in flax_names(module).items():
        value = params[name].detach().float().cpu().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value.T if transpose else value
    return {"params": tree}
