"""Exact ring attention and the context-parallel trunk of the port
(``maestro_tpu_torch/ops/ring_attention.py``) against the JAX package's
``ops/ring_attention.py``.

The port's ring runs on 4 gloo ranks (``tests/_torch_dist_worker.py``, no
JAX in those processes), the JAX package's on its 8-device CPU mesh, both
on the same numpy inputs; each rank holds its chunk of the sequence and the
chunks are joined in rank order.  Tolerances as tests/test_ring_attention.py:
forward 2e-5 / 2e-6, input gradients 5e-5 / 5e-6, the CP trunk 2e-5 and its
parameter gradients 1e-4.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import maestro_tpu.models.mae as JM
from maestro_tpu.conf import MaskConfig as JMaskConfig
from maestro_tpu.conf import ModelConfig as JModelConfig
from maestro_tpu.ops.ring_attention import cp_trunk_forward as j_cp_trunk_forward
from maestro_tpu.ops.ring_attention import ring_mha as j_ring_mha
from maestro_tpu.parallel.mesh import make_mesh
from maestro_tpu_torch.port.from_jax import flax_names

from _torch_dist_worker import build_micro, launch, session_shared
from _torch_port_utils import rng_normal, synthetic_tree
from test_torch_parallel import _jax_datasets

RANKS = 4


def _jax_ring(mesh, q, k, v):
    d = q.shape[-1]
    return jax.shard_map(
        lambda q, k, v: j_ring_mha(q, k, v, "model", d**-0.5),
        mesh=mesh,
        in_specs=(P(None, "model"), P(None, "model"), P(None, "model")),
        out_specs=P(None, "model"),
    )(q, k, v)


def _join(results, key):
    return np.concatenate([r[key] for r in results], axis=1)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX package's results and the port's (one launch), computed by
    the first test worker that needs them (a file lock over the session's
    temporary root)."""
    want, got = session_shared(tmp_path_factory, "torch_ring_attention_case",
                               lambda root: _compute_case(root / "ring"))
    return want, got, build_micro()[0]


def _compute_case(work):
    mesh = make_mesh(1, 8)  # the sequence over the 8-way "model" axis
    inputs = {x: rng_normal(i, 2, 64, 4, 16) for i, x in enumerate(("q", "k", "v"))}
    inputs.update({x: rng_normal(10 + i, 1, 32, 2, 8) for i, x in enumerate(("gq", "gk", "gv"))})
    inputs["gw"] = rng_normal(20, 1, 32, 2, 8)

    model, _ = build_micro()
    tree = synthetic_tree(model, seed=4)
    trunk = tree["params"]["encoder_inter"]
    jmodel, _ = JM.build_model(_jax_datasets(), JMaskConfig(),
                               JModelConfig(model_size="micro", fusion_mode="group",
                                            inter_depth=1), dtype=jnp.float32)
    arch = jmodel.arch
    length = 8 * 13  # divisible by both rings
    inputs["x"] = rng_normal(30, 2, length, arch.embed_dim)
    inputs["w"] = rng_normal(31, 2, length, arch.embed_dim)

    # jitted: shard_map traced op by op outside jit takes about 80 s on the CPU
    want = {"ring": np.asarray(jax.jit(partial(_jax_ring, mesh))(
        *(jnp.asarray(inputs[x]) for x in "qkv")))}

    def ring_loss(q, k, v):
        return jnp.sum(_jax_ring(mesh, q, k, v) * jnp.asarray(inputs["gw"]))

    want["grads"] = [np.asarray(g) for g in jax.jit(jax.grad(ring_loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(inputs[x]) for x in ("gq", "gk", "gv")))]

    def cp(tp):
        return j_cp_trunk_forward(tp, jnp.asarray(inputs["x"]), mesh, arch.heads, arch.dim_head)

    want["cp"] = np.asarray(jax.jit(cp)(trunk))
    want["cp_grads"] = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda tp: jnp.sum(cp(tp) * jnp.asarray(inputs["w"]))))(trunk))
    got = launch("ring", RANKS, work, {**inputs, "tree": {"params": {"encoder_inter": trunk}}})
    return want, got


def test_ring_mha_matches_jax(case):
    want, got, _ = case
    assert not any(r["jax_loaded"] for r in got)
    np.testing.assert_allclose(_join(got, "ring"), want["ring"], rtol=2e-5, atol=2e-6)


def test_ring_mha_gradients_match_jax(case):
    """dq stays with its chunk; dk and dv come home after the second ring."""
    want, got, _ = case
    for i, w in enumerate(want["grads"]):
        g = np.concatenate([r["grads"][i] for r in got], axis=1)
        np.testing.assert_allclose(g, w, rtol=5e-5, atol=5e-6)


def test_cp_trunk_matches_jax(case):
    """The model's own ``encoder_inter`` on sequence-sharded activations,
    forward and parameter gradients (summed over the ranks), against the
    JAX package's CP trunk on the same parameters."""
    want, got, model = case
    np.testing.assert_allclose(_join(got, "cp"), want["cp"], rtol=2e-5, atol=2e-5)
    names = flax_names(model)
    compared = 0
    for path, g in jax.tree_util.tree_flatten_with_path(want["cp_grads"])[0]:
        name, transpose = names[("encoder_inter",) + tuple(str(k.key) for k in path)]
        w = np.asarray(g)
        np.testing.assert_allclose(got[0]["cp_grads"][name.removeprefix("encoder_inter.")],
                                   w.T if transpose else w, rtol=1e-4, atol=1e-4, err_msg=name)
        compared += 1
    assert compared == len(got[0]["cp_grads"]) > 5
