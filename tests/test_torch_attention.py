"""Port of attention (maestro_tpu_torch/ops/attention.py) against the JAX
package: the einsum tier and the Pallas kernels in interpret mode, forward and
backward.

On the CPU ``mha_blhd`` runs ``mha_blhd_plain``, whose autograd is the
backward's plain version; the CUDA kernels themselves are held against the
plain versions on the GPU by chip_smoke.py.
"""

from __future__ import annotations

import jax
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
    """The kernels take head dims 32, 64, 96, 128 and refuse others; the plain
    version, which CPU tensors take, serves any (the test-only micro arch's
    decoder has 24-dim heads)."""
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head dim 48"):
        TA.check_kernel_shape(q)
    TA.check_kernel_shape(torch.zeros(1, 8, 2, 96))
    assert TA.mha_blhd(q, q, q, 1.0).shape == q.shape


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


def _grads_jax(fn, q, k, v, dout):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _grads_port(q, k, v, dout, d):
    qkv = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    TA.mha_blhd(*qkv, d**-0.5).backward(torch.from_numpy(dout))
    return [to_np(t.grad) for t in qkv]


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize(("l", "h", "d"), [(50, 2, 32), (100, 2, 24), (130, 2, 64)])
def test_plain_gradients_match_jax(l, h, d):
    """The plain version's autograd (the backward kernel's plain version)
    against jax.vjp through the JAX package's mha_blhd, fp32 (rtol 1e-5,
    atol 1e-5 of the largest gradient)."""
    q, k, v = _qkv(l, h, d, seed=20)
    dout = rng_normal(23, 2, l, h, d)
    want = _grads_jax(lambda a, b, c: JA.mha_blhd(a, b, c, d**-0.5), q, k, v, dout)
    _assert_grads_close(_grads_port(q, k, v, dout, d), want)


def test_plain_gradients_match_packed_backward_kernel(monkeypatch):
    """...and against the Pallas backward (_pk_bwd_kernel) in interpret mode."""
    monkeypatch.setattr(JA, "INTERPRET", True)
    l, h, d = 130, 2, 64
    q, k, v = _qkv(l, h, d, seed=30)
    dout = rng_normal(33, 2, l, h, d)
    want = _grads_jax(
        lambda a, b, c: JA.packed_single_block_attention(a, b, c, d**-0.5), q, k, v, dout)
    _assert_grads_close(_grads_port(q, k, v, dout, d), want)


def test_mha_qkv_and_logsumexp():
    """The fused-projection entry agrees with mha_blhd on its views, value
    and gradient; the saved logsumexp agrees with JAX's."""
    b, l, h, d = 2, 40, 2, 32
    qkv = torch.from_numpy(rng_normal(40, b, l, 3, h, d)).requires_grad_(True)
    out = TA.mha_qkv(qkv, d**-0.5)
    dout = torch.from_numpy(rng_normal(41, b, l, h, d))
    out.backward(dout)
    views = qkv.detach().clone().requires_grad_(True)
    ref = TA.mha_blhd(*views.unbind(dim=2), d**-0.5)
    ref.backward(dout)
    assert torch.equal(out, ref)
    assert torch.equal(qkv.grad, views.grad)
    assert torch.equal(TA.mha_qkv_plain(qkv, d**-0.5), out)
    q, k = qkv.detach()[:, :, 0], qkv.detach()[:, :, 1]
    logits = jnp.einsum("bqhd,bkhd->bhqk", jnp.asarray(q.numpy()), jnp.asarray(k.numpy()))
    want = jax.nn.logsumexp(logits * d**-0.5, axis=-1)
    np.testing.assert_allclose(to_np(TA.logsumexp_plain(q, k, d**-0.5)), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="3, H, D"):
        TA.mha_qkv(qkv.detach()[:, :, :2], 1.0)
