"""Port of the attentive date pool (maestro_tpu_torch/ops/attn_pool.py)
against the JAX package: ``attentive_pool_reference`` and the Pallas kernel
in interpret mode (output and the m/den softmax statistics).

On the CPU ``attentive_pool`` runs ``attentive_pool_plain``; the CUDA kernel
is held against the plain version on the GPU by chip_smoke.py.  The port takes
``w_kv`` in ``nn.Linear`` layout [2E, E], the JAX package in [E, 2E].
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maestro_tpu.ops import attn_pool as JP
from maestro_tpu_torch.ops import attn_pool as TP

from _torch_port_utils import rng_normal, single_thread_torch, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")

FP32_TOL = dict(rtol=1e-4, atol=1e-5)  # observed max abs err ~1e-6
KERNEL_TOL = dict(rtol=2e-3, atol=2e-4)  # the JAX package's own kernel-vs-reference tolerance
BF16_TOL = dict(rtol=3e-2, atol=3e-2)  # observed max abs err ~4e-3

# (b, d, l, e, heads): ragged L, the minimum of two dates, dh = 96
SHAPES = [(2, 5, 40, 128, 8), (1, 2, 64, 128, 8), (1, 3, 32, 384, 4)]


def _make(b, d, l, e, seed=0):
    x = rng_normal(seed, b, d, l, e, scale=1.7) + 0.3
    scale = 1.0 + rng_normal(seed + 1, e, scale=0.1)
    bias = rng_normal(seed + 2, e, scale=0.1)
    w_kv = rng_normal(seed + 3, e, 2 * e, scale=e**-0.5)  # JAX layout [E, 2E]
    query = rng_normal(seed + 4, e)
    return x, scale, bias, w_kv, query


def _port(x, scale, bias, w_kv, query, heads, dtype=torch.float32):
    t = torch.from_numpy
    return TP.attentive_pool(
        t(x).to(dtype), t(scale), t(bias), t(np.ascontiguousarray(w_kv.T)), t(query), heads,
    )


@pytest.mark.parametrize(("b", "d", "l", "e", "heads"), SHAPES)
def test_matches_reference(b, d, l, e, heads):
    args = _make(b, d, l, e)
    want = JP.attentive_pool_reference(*(jnp.asarray(a) for a in args), heads)
    out, m, den = _port(*args, heads)
    assert out.shape == (b, l, e) and m.shape == den.shape == (b, l, heads)
    np.testing.assert_allclose(to_np(out), to_np(want), **FP32_TOL)


@pytest.mark.parametrize(("b", "d", "l", "e", "heads"), SHAPES[:2])
def test_matches_interpret_kernel_and_its_statistics(monkeypatch, b, d, l, e, heads):
    monkeypatch.setattr(JP, "INTERPRET", True)
    args = _make(b, d, l, e, seed=10)
    want, want_m, want_den = JP._fwd_impl(*(jnp.asarray(a) for a in args), heads, 1e-5)
    out, m, den = _port(*args, heads)
    np.testing.assert_allclose(to_np(out), to_np(want), **KERNEL_TOL)
    np.testing.assert_allclose(to_np(m), to_np(want_m), **KERNEL_TOL)
    np.testing.assert_allclose(to_np(den), to_np(want_den), **KERNEL_TOL)


def test_bf16_matches_reference():
    b, d, l, e, heads = 2, 5, 40, 128, 8
    x, *rest = _make(b, d, l, e, seed=20)
    want = JP.attentive_pool_reference(
        jnp.asarray(x, jnp.bfloat16), *(jnp.asarray(a) for a in rest), heads,
    )
    out, _, _ = _port(x, *rest, heads, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(out), to_np(want), **BF16_TOL)


def test_statistics_reproduce_the_softmax():
    """out == sum_d exp(logit_d - m) / den * v_d: den is the sum of the
    shifted exponentials, so it lies in [1, D]."""
    b, d, l, e, heads = 1, 4, 32, 128, 8
    _, m, den = _port(*_make(b, d, l, e, seed=30), heads)
    assert torch.isfinite(m).all()
    assert (den >= 1.0).all() and (den <= d + 1e-4).all()


def test_bad_shapes_raise():
    x, scale, bias, w_kv, query = (torch.from_numpy(a) for a in _make(1, 2, 32, 128))
    with pytest.raises(ValueError, match="w_kv"):
        TP.attentive_pool(x, scale, bias, w_kv, query, 8)  # JAX layout [E, 2E]
    with pytest.raises(ValueError, match="heads"):
        TP.attentive_pool(x, scale, bias, w_kv.T, query, 7)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        TP.attentive_pool(x.double(), scale, bias, w_kv.T, query, 8)


def test_cpu_tensors_launch_no_kernel():
    before = TP.launch_count
    _port(*_make(1, 2, 32, 128), 8)
    assert TP.launch_count == before
