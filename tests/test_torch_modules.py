"""Port of the model modules (maestro_tpu_torch/models) against their flax
counterparts: the flax module is initialized, its parameters perturbed with
numpy from a seed, carried over by ``load_jax_params``, and both sides run on
the same numpy input in fp32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maestro_tpu.models import embed as JE
from maestro_tpu.models import heads as JH
from maestro_tpu.models import vit as JV
from maestro_tpu_torch.models import embed as TE
from maestro_tpu_torch.models import heads as TH
from maestro_tpu_torch.models import vit as TV
from maestro_tpu_torch.port.from_jax import load_jax_params

from _torch_port_utils import (  # noqa: F401
    randomized_tree,
    rng_normal,
    single_thread_torch,
    to_np,
)

pytestmark = pytest.mark.usefixtures("single_thread_torch")

TOL = dict(rtol=1e-4, atol=1e-4)  # fp32, observed max abs err <= 3e-6
F32 = torch.float32


def _gen():
    return torch.Generator().manual_seed(0)


def _flax_run(module, x, seed):
    """(perturbed numpy parameter tree, flax output) for input(s) ``x``."""
    xj = jax.tree.map(jnp.asarray, x)
    params = module.init(jax.random.PRNGKey(0), xj)
    tree = randomized_tree(params, seed)
    return tree, module.apply(tree, xj)


def _t(x):
    return jax.tree.map(torch.from_numpy, x)


@pytest.mark.parametrize("band_groups", [(3,), (2, 1, 3)])
def test_patch_embed(band_groups):
    x = rng_normal(0, 2, 3, sum(band_groups), 8, 8)
    tree, want = _flax_run(
        JE.PatchEmbed(band_groups, 4, 32, dtype=jnp.float32), x, seed=1)
    port = TE.PatchEmbed(band_groups, 4, 32, F32, _gen(), "cpu")
    load_jax_params(port, tree)
    got = port(_t(x))
    assert got.shape == (2, 3 * len(band_groups), 4, 32)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_transformer():
    x = rng_normal(2, 2, 20, 64)
    tree, want = _flax_run(
        JV.Transformer(64, 2, 2, 32, 128, dtype=jnp.float32), x, seed=3)
    port = TV.Transformer(64, 2, 2, 32, 128, F32, _gen(), "cpu")
    load_jax_params(port, tree)
    np.testing.assert_allclose(to_np(port(_t(x))), to_np(want), **TOL)


def test_attentive_reduce_rank3():
    x = rng_normal(4, 2, 12, 64)
    tree, want = _flax_run(JV.AttentiveReduce(64, heads=8, dtype=jnp.float32), x, seed=5)
    port = TV.AttentiveReduce(64, 8, F32, _gen(), "cpu")
    load_jax_params(port, tree)
    got = port(_t(x))
    assert got.shape == (2, 64)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


@pytest.mark.parametrize(
    ("shape", "fused"),
    [((2, 3, 6, 64), False), ((1, 3, 32, 128), True)],
    ids=["einsum-body", "fused-pool-gate"],
)
def test_attentive_reduce_rank4(shape, fused):
    """Below the gate the port runs the einsum body; at 128-aligned width and
    >= 32 positions it goes through ``attentive_pool`` (plain version here)
    while flax on the CPU keeps its einsum body — same function."""
    x = rng_normal(6, *shape)
    dim = shape[-1]
    tree, want = _flax_run(JV.AttentiveReduce(dim, heads=8, dtype=jnp.float32), x, seed=7)
    port = TV.AttentiveReduce(dim, 8, F32, _gen(), "cpu")
    load_jax_params(port, tree)
    xt = _t(x)
    assert port._use_fused_pool(xt) is fused
    got = port(xt)
    assert got.shape == (shape[0], shape[2], dim)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


@pytest.mark.parametrize("type_head", ["attentive", "linear"])
def test_classification_head(type_head):
    x = rng_normal(8, 2, 12, 64)
    tree, want = _flax_run(
        JH.ClassificationHead(type_head, 64, 5, dtype=jnp.float32), x, seed=9)
    port = TH.ClassificationHead(type_head, 64, 5, F32, _gen(), "cpu")
    load_jax_params(port, tree)
    got = port(_t(x))
    assert got.shape == (2, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


@pytest.mark.parametrize(
    ("type_head", "chunk_rows", "effective"),
    [("attentive", 2, 2), ("attentive", 3, 1), ("linear", 4, 4)],
    ids=["chunks-of-2", "non-dividing-falls-back-to-1", "mean-one-chunk"],
)
def test_chunked_seg_head(type_head, chunk_rows, effective):
    ref_grid, mod_grids, dim = 4, (4, 2, 5), 64
    xs = tuple(
        rng_normal(10 + i, 2, dates, g * g, dim)
        for i, (g, dates) in enumerate(zip(mod_grids, (1, 3, 2)))
    )
    flax_head = JH.ChunkedSegHead(
        type_head, dim, 3, 2, ref_grid, mod_grids, chunk_rows=chunk_rows,
        dtype=jnp.float32,
    )
    tree, want = _flax_run(flax_head, xs, seed=11)
    port = TH.ChunkedSegHead(
        type_head, dim, 3, 2, ref_grid, mod_grids, F32, _gen(), "cpu",
        chunk_rows=chunk_rows,
    )
    assert port.chunk_rows == effective
    load_jax_params(port, tree)
    got = port(_t(xs))
    assert got.shape == (2, 1, 3, 8, 8)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_chunked_seg_head_rejects_bad_chunk_rows():
    with pytest.raises(ValueError, match="chunk_rows"):
        TH.ChunkedSegHead("linear", 64, 3, 2, 4, (4,), F32, _gen(), "cpu", chunk_rows=0)


def test_init_is_reproducible_from_the_generator():
    a = TV.Transformer(64, 1, 2, 32, 128, F32, torch.Generator().manual_seed(3), "cpu")
    b = TV.Transformer(64, 1, 2, 32, 128, F32, torch.Generator().manual_seed(3), "cpu")
    c = TV.Transformer(64, 1, 2, 32, 128, F32, torch.Generator().manual_seed(4), "cpu")
    wa, wb, wc = (m.block0.attn.qkv.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.dtype == torch.float32
