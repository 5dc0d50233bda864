"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both the JAX
package and the port; on the CPU the port's kernel wrappers run their plain
versions.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from maestro_tpu_torch.port.from_jax import flax_path


@pytest.fixture(scope="module")
def single_thread_torch():
    """One torch thread per test worker (restored afterwards): several xdist
    workers each running a torch thread pool beside XLA:CPU oversubscribe
    the machine."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def rng_normal(seed: int, *shape: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def randomized_tree(params, seed: int):
    """A flax parameter tree as nested dicts of numpy arrays, perturbed so
    that zero-initialized biases and unit scales take part in the comparison."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32)
                   + 0.1 * rng.normal(size=np.shape(a))).astype(np.float32),
        params,
    )


def to_np(x) -> np.ndarray:
    """A jax array or torch tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def synthetic_tree(model, seed: int, skip: tuple[str, ...] = ()) -> dict:
    """A flax parameter tree (numpy leaves) for every parameter of the port's
    ``model`` whose name starts with none of ``skip``: dense kernels
    Normal(0, 1/fan_in), scales 1 + 0.1 N, everything else 0.2 N (biases and
    mask tokens included, so every leaf takes part).  Built from the port's
    names by ``port.from_jax.flax_path``, which ``load_jax_params`` checks
    back strictly both ways; tracing the JAX package's ``init`` would cost
    seconds."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for name, p in model.named_parameters():
        if name.startswith(skip):
            continue
        path, transpose = flax_path(model, name)
        shape = tuple(p.shape[::-1]) if transpose else tuple(p.shape)
        x = rng.normal(size=shape)
        if path[-1] == "kernel":
            x = x * shape[0] ** -0.5
        elif path[-1].endswith("scale"):
            x = 1.0 + 0.1 * x
        elif not path[-1].startswith("mask_token"):
            x = 0.2 * x
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = x.astype(np.float32)
    return {"params": tree}
