"""Port of attention (maestro_tpu_torch/ops/attention.py) against the JAX
package: the einsum tier and the Pallas kernels in interpret mode.

On the CPU ``mha_blhd`` runs ``mha_blhd_plain``; the CUDA kernel itself is
held against the plain version on the GPU by chip_smoke.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maestro_tpu.ops import attention as JA
from maestro_tpu_torch.ops import attention as TA

from _torch_port_utils import rng_normal, single_thread_torch, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")

FP32_TOL = dict(rtol=1e-5, atol=1e-5)  # observed max abs err ~5e-7
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # observed max abs err ~2e-3 (1 bf16 ulp)


def _qkv(l, h, d, seed=0, b=2):
    return tuple(rng_normal(seed + i, b, l, h, d) for i in range(3))


def _port(q, k, v, d, dtype=torch.float32):
    args = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    return to_np(TA.mha_blhd(*args, d**-0.5))


@pytest.mark.parametrize(("l", "h", "d"), [(50, 2, 32), (130, 2, 64), (256, 1, 128)])
def test_mha_blhd_matches_jax(l, h, d):
    q, k, v = _qkv(l, h, d)
    want = JA.mha_blhd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5)
    np.testing.assert_allclose(_port(q, k, v, d), to_np(want), **FP32_TOL)


@pytest.mark.parametrize(("l", "h", "d"), [(130, 2, 64), (256, 1, 128)])
def test_matches_packed_single_block_kernel(monkeypatch, l, h, d):
    monkeypatch.setattr(JA, "INTERPRET", True)
    q, k, v = _qkv(l, h, d, seed=3)
    want = JA.packed_single_block_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5,
    )
    np.testing.assert_allclose(_port(q, k, v, d), to_np(want), **FP32_TOL)


def test_matches_packed_qblock_kernel(monkeypatch):
    monkeypatch.setattr(JA, "INTERPRET", True)
    l, h, d = 256, 1, 128
    q, k, v = _qkv(l, h, d, seed=6)
    want = JA.packed_qblock_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5,
    )
    np.testing.assert_allclose(_port(q, k, v, d), to_np(want), **FP32_TOL)


def test_strided_qkv_view_needs_no_copy():
    """q, k, v as views of one fused projection output give the same result
    as contiguous copies, and the JAX result."""
    b, l, h, d = 2, 50, 2, 32
    qkv = torch.from_numpy(rng_normal(9, b, l, 3 * h * d))
    q, k, v = qkv.view(b, l, 3, h, d).unbind(dim=2)
    assert not q.is_contiguous()
    out = TA.mha_blhd(q, k, v, d**-0.5)
    assert out.is_contiguous() and out.shape == (b, l, h, d)
    copies = TA.mha_blhd(q.contiguous(), k.contiguous(), v.contiguous(), d**-0.5)
    np.testing.assert_array_equal(to_np(out), to_np(copies))
    want = JA.mha_blhd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), d**-0.5)
    np.testing.assert_allclose(to_np(out), to_np(want), **FP32_TOL)


def test_bf16_matches_jax():
    l, h, d = 130, 2, 64
    q, k, v = _qkv(l, h, d, seed=12)
    want = JA.mha_blhd(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), d**-0.5,
    )
    got = TA.mha_blhd(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), d**-0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), to_np(want), **BF16_TOL)


def test_unsupported_head_dim_raises():
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head dim 48"):
        TA.mha_blhd(q, q, q, 1.0)


def test_mismatched_inputs_raise():
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="share one"):
        TA.mha_blhd(q, q[:, :4], q, 1.0)
    with pytest.raises(TypeError, match="bfloat16 or all float32"):
        TA.mha_blhd(q, q.double(), q, 1.0)


def test_cpu_tensors_launch_no_kernel():
    before = TA.launch_count
    q = torch.from_numpy(rng_normal(1, 1, 8, 2, 32))
    TA.mha_blhd(q, q, q, 1.0)
    assert TA.launch_count == before
