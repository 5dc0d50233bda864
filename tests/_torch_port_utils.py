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
