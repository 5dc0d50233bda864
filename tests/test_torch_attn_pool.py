"""Port of the attentive date pool (maestro_tpu_torch/ops/attn_pool.py)
against the JAX package: ``attentive_pool_reference`` and the Pallas kernel
in interpret mode (output and the m/den softmax statistics).

On the CPU ``attentive_pool`` runs ``attentive_pool_plain``; the CUDA kernel
is held against the plain version on the GPU by chip_smoke.py.  The port takes
``w_kv`` in ``nn.Linear`` layout [2E, E], the JAX package in [E, 2E].
"""

from __future__ import annotations

import jax
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


# ---------------------------------------------------------------- backward
GRAD_TOL = 1e-4  # of each gradient's max |value|, fp32; observed ~1e-6
# (b, d, l, e, heads): E = 128 with 8 heads, a ragged L, a D no date block of
# the JAX kernel divides into 128-row blocks; dh = 96
BWD_SHAPES = [(2, 5, 40, 128, 8), (1, 3, 32, 384, 4)]
GRAD_NAMES = ("dx", "d_ln_scale", "d_ln_bias", "d_w_kv", "d_query")


def _jax_grads(args, cot, heads, fn):
    """Gradients of sum(fn(...) * cot) in the port's layout (w_kv [2E, E])."""
    jargs = [jnp.asarray(a) for a in args]
    grads = jax.grad(lambda *a: jnp.sum(fn(*a, heads) * cot), argnums=(0, 1, 2, 3, 4))(*jargs)
    grads = [np.asarray(g, np.float32) for g in grads]
    grads[3] = grads[3].T
    return grads


def _assert_grads(got, want, names=GRAD_NAMES):
    for name, g, w in zip(names, got, want):
        g = to_np(g)
        limit = GRAD_TOL * np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= limit, f"{name}: max abs err {err:.3e} > {limit:.3e}"


def _port_backward(args, cot, heads, need_dx=True):
    """The Function's backward (autograd) on the port's layout."""
    x, scale, bias, w_kv, query = (torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    x.requires_grad_(need_dx)
    params = [t.requires_grad_(True) for t in (scale, bias, w_kv.T.contiguous(), query)]
    out, _, _ = TP.attentive_pool(x, *params, heads)
    (out * torch.from_numpy(cot)).sum().backward()
    return ([x.grad] if need_dx else []) + [p.grad for p in params]


@pytest.mark.parametrize(("b", "d", "l", "e", "heads"), BWD_SHAPES)
def test_backward_matches_interpret_kernel_and_reference(monkeypatch, b, d, l, e, heads):
    """All five gradients: the plain backward and the Function's backward
    against the JAX kernel's VJP (Pallas, interpret mode) and ``jax.grad`` of
    ``attentive_pool_reference``."""
    monkeypatch.setattr(JP, "INTERPRET", True)
    args = _make(b, d, l, e, seed=40)
    cot = rng_normal(41, b, l, e)
    want_kernel = _jax_grads(args, cot, heads, JP.attentive_pool)
    want_ref = _jax_grads(args, cot, heads, JP.attentive_pool_reference)
    _assert_grads(want_kernel, want_ref)  # the two JAX gradients agree

    t = torch.from_numpy
    x, scale, bias, w_kv, query = (t(np.ascontiguousarray(a)) for a in args)
    w_kv = w_kv.T.contiguous()
    out, m, den = TP.attentive_pool_plain(x, scale, bias, w_kv, query, heads)
    plain = TP.attentive_pool_bwd_plain(x, scale, bias, w_kv, query, out, m, den, t(cot), heads)
    _assert_grads(plain, want_kernel)
    _assert_grads(_port_backward(args, cot, heads), want_kernel)


def test_backward_without_dx(monkeypatch):
    """x that needs no gradient (the probe phase): the four parameter
    gradients only, the same as with dx."""
    monkeypatch.setattr(JP, "INTERPRET", True)
    b, d, l, e, heads = 2, 5, 40, 128, 8
    args = _make(b, d, l, e, seed=50)
    cot = rng_normal(51, b, l, e)
    want = _jax_grads(args, cot, heads, JP.attentive_pool)
    got = _port_backward(args, cot, heads, need_dx=False)
    assert len(got) == 4
    _assert_grads(got, want[1:], GRAD_NAMES[1:])
    t = torch.from_numpy
    x, scale, bias, w_kv, query = (t(np.ascontiguousarray(a)) for a in args)
    out, m, den = TP.attentive_pool_plain(x, scale, bias, w_kv.T, query, heads)
    dx, *rest = TP.attentive_pool_bwd(x, scale, bias, w_kv.T, query, out, m, den, t(cot),
                                      heads, need_dx=False)
    assert dx is None
    _assert_grads(rest, want[1:], GRAD_NAMES[1:])


def test_attentive_reduce_fused_gradients_match_jax(monkeypatch):
    """``AttentiveReduce`` on the fused gate (E % 128 == 0, L >= 32, D >= 2):
    output, input gradient and every parameter gradient against the JAX
    module with its Pallas pool in interpret mode."""
    from maestro_tpu.models.vit import AttentiveReduce as JReduce
    from maestro_tpu_torch.models.vit import AttentiveReduce
    from maestro_tpu_torch.port.from_jax import _target_name, load_jax_params

    monkeypatch.setattr(JP, "INTERPRET", True)
    b, d, l, e, heads = 2, 6, 40, 256, 8
    x = rng_normal(60, b, d, l, e)
    jmod = JReduce(dim=e, heads=heads, dtype=jnp.float32)
    assert jmod._use_fused_pool(jnp.asarray(x))
    params = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    params = jax.tree.map(lambda a: a + 0.1 * rng_normal(61, *a.shape), params)  # biases too

    def loss(p, xx):
        return jnp.sum(jnp.square(jmod.apply(p, xx)))

    want_out = np.asarray(jmod.apply(params, jnp.asarray(x)))
    want_gp, want_gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    mod = AttentiveReduce(e, heads, torch.float32, torch.Generator(), "cpu")
    load_jax_params(mod, params)
    assert mod._use_fused_pool(torch.zeros(b, d, l, e))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mod(xt)
    out.square().sum().backward()
    np.testing.assert_allclose(to_np(out), want_out, **FP32_TOL)
    _assert_grads([xt.grad], [np.asarray(want_gx)], ("dx",))
    grads = dict(mod.named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(want_gp["params"])[0]
    assert len(leaves) == len(grads) == 6
    for path, g in leaves:
        name, transpose = _target_name(tuple(str(k.key) for k in path))
        want = np.asarray(g, np.float32)
        _assert_grads([grads[name].grad], [want.T if transpose else want], (name,))


def test_bwd_bad_shapes_raise():
    b, d, l, e, heads = 1, 2, 32, 128, 8
    x, scale, bias, w_kv, query = (torch.from_numpy(a) for a in _make(b, d, l, e))
    out, m, den = TP.attentive_pool_plain(x, scale, bias, w_kv.T, query, heads)
    with pytest.raises(ValueError, match="out and g"):
        TP.attentive_pool_bwd(x, scale, bias, w_kv.T, query, out[:, :-1], m, den, out, heads)
    with pytest.raises(ValueError, match="m and den"):
        TP.attentive_pool_bwd(x, scale, bias, w_kv.T, query, out, m[..., :4], den, out, heads)
    with pytest.raises(TypeError, match="float32"):
        TP.attentive_pool_bwd(x, scale, bias, w_kv.T, query, out, m.double(), den, out, heads)


def test_cpu_backward_launches_no_kernel():
    before = (TP.launch_count, TP.bwd_launch_count)
    args = _make(1, 2, 32, 128, seed=70)
    _port_backward(args, rng_normal(71, 1, 32, 128), 8)
    assert (TP.launch_count, TP.bwd_launch_count) == before
    # the split-K slice count of the d_w_kv product at the finetune shape
    assert TP.bwd_splits(32 * 26 * 128, 768, 132) == 15
    assert TP.bwd_splits(100, 128, 132) == 1
