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
    from maestro_tpu_torch.port.from_jax import flax_names, load_jax_params

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
    names = flax_names(mod)
    for path, g in leaves:
        name, transpose = names[tuple(str(k.key) for k in path)]
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


# ---------------------------------------------------------------- the kernels' algebra
# The CUDA kernels (csrc/attn_pool.cu, attn_pool_bwd.cu) compute the pool in a
# factored form: u_h = sum_{j in h} q_j W_k[j], logit = s y . u_h, ybar_h =
# sum_d a y_d, out_h = W_v,h ybar_h; dybar_h = W_v,h^T g_h, T_h = g_h . out_h,
# da = dybar_h . y, dlogit = a (da - T), dy = sum_h (a dybar_h + s dlogit u_h),
# du_h = s sum dlogit y, dW_k[j] = q_j du_h(j), dW_v,h = sum g_h ybar_h,
# d_query_j = W_k[j] . du_h(j).  The two functions below transcribe them
# launch by launch in float64: the dates in steps of KERNEL_DATE_STEP with the
# online softmax, LayerNorm statistics from a row's sum and sum of squares,
# ybar recomputed in the backward.  They leave out only the bf16 roundings of
# the operands, which chip_smoke.py checks on the card.
KERNEL_DATE_STEP = 4  # csrc/pool_common.cuh kDC


def _ln_step(xs, scale, bias, eps):
    """LayerNorm of [P, c, E] rows as the row kernels take it: (xhat, y, rstd)."""
    mu = xs.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xs.square().mean(-1, keepdim=True) - mu.square()).clamp_min(0) + eps)
    xhat = (xs - mu) * rstd
    return xhat, xhat * scale + bias, rstd


def _factored_fwd(x, scale, bias, w_kv, query, heads, eps=1e-5):
    b, d, l, e = x.shape
    dh = e // heads
    s = dh**-0.5
    rows = x.permute(0, 2, 1, 3).reshape(b * l, d, e)  # [P, D, E]
    w_k, w_v = w_kv[:e].reshape(heads, dh, e), w_kv[e:].reshape(heads, dh, e)
    u = torch.einsum("hj,hje->he", query.reshape(heads, dh), w_k)  # launch 1
    m = torch.full((b * l, heads), -1e30, dtype=x.dtype)  # launch 2
    den = torch.zeros_like(m)
    acc = torch.zeros((b * l, heads, e), dtype=x.dtype)
    for d0 in range(0, d, KERNEL_DATE_STEP):
        _, y, _ = _ln_step(rows[:, d0:d0 + KERNEL_DATE_STEP], scale, bias, eps)
        logit = s * torch.einsum("pce,he->pch", y, u)
        mx = torch.maximum(m, logit.amax(dim=1))
        alpha = torch.exp(m - mx)
        p = torch.exp(logit - mx[:, None])
        den = den * alpha + p.sum(dim=1)
        acc = acc * alpha[..., None] + torch.einsum("pch,pce->phe", p, y)
        m = mx
    ybar = acc / den[..., None]
    out = torch.einsum("phe,hce->phc", ybar, w_v)  # launch 3
    return out.reshape(b, l, e), m.reshape(b, l, heads), den.reshape(b, l, heads)


def _factored_bwd(x, scale, bias, w_kv, query, out, m, den, g, heads, eps=1e-5, need_dx=True):
    b, d, l, e = x.shape
    dh = e // heads
    s = dh**-0.5
    rows = x.permute(0, 2, 1, 3).reshape(b * l, d, e)
    w_k, w_v = w_kv[:e], w_kv[e:].reshape(heads, dh, e)
    u = torch.einsum("hj,hje->he", query.reshape(heads, dh), w_k.reshape(heads, dh, e))
    gh = g.reshape(b * l, heads, dh)
    dybar = torch.einsum("phc,hce->phe", gh, w_v)  # launch 2
    pivot = (gh * out.reshape(b * l, heads, dh)).sum(-1)  # launch 3 from here
    m, den = m.reshape(b * l, 1, heads), den.reshape(b * l, 1, heads)
    du = torch.zeros((heads, e), dtype=x.dtype)
    ybar = torch.zeros((b * l, heads, e), dtype=x.dtype)
    d_scale, d_bias = torch.zeros(e, dtype=x.dtype), torch.zeros(e, dtype=x.dtype)
    dx = torch.zeros_like(rows)
    for d0 in range(0, d, KERNEL_DATE_STEP):
        xhat, y, rstd = _ln_step(rows[:, d0:d0 + KERNEL_DATE_STEP], scale, bias, eps)
        a = torch.exp(s * torch.einsum("pce,he->pch", y, u) - m) / den
        dlogit = a * (torch.einsum("pce,phe->pch", y, dybar) - pivot[:, None])
        dy = torch.einsum("pch,phe->pce", a, dybar) + s * torch.einsum("pch,he->pce", dlogit, u)
        du += s * torch.einsum("pch,pce->he", dlogit, y)
        ybar += torch.einsum("pch,pce->phe", a, y)
        d_scale += (dy * xhat).sum(dim=(0, 1))
        d_bias += dy.sum(dim=(0, 1))
        gd = dy * scale
        dx[:, d0:d0 + KERNEL_DATE_STEP] = rstd * (
            gd - gd.mean(-1, keepdim=True) - xhat * (gd * xhat).mean(-1, keepdim=True))
    d_w_v = torch.einsum("phc,phe->hce", gh, ybar).reshape(e, e)  # launches 4, 6
    du_rows = du.repeat_interleave(dh, dim=0)  # du of row j's head
    d_w = torch.cat([query[:, None] * du_rows, d_w_v])
    d_query = (w_k * du_rows).sum(-1)
    dx = dx.reshape(b, l, d, e).permute(0, 2, 1, 3) if need_dx else None
    return dx, d_scale, d_bias, d_w, d_query


# (b, d, l, e, heads, dx wanted): head dims 16, 48, 96, 128; 2, 3 and 26
# dates (26 leaves a short last step); ragged L
FACTORED_CASES = [
    (2, 2, 33, 128, 8, True),
    (1, 26, 7, 384, 8, False),
    (1, 26, 5, 768, 8, True),
    (2, 3, 9, 1024, 8, False),
    (1, 26, 3, 1024, 8, True),
]


@pytest.mark.parametrize(("b", "d", "l", "e", "heads", "need_dx"), FACTORED_CASES)
def test_kernel_factored_form_matches_plain(b, d, l, e, heads, need_dx):
    """The kernels' order of operations (float64) against the plain forward
    and backward (fp32) on the same inputs."""
    x, scale, bias, w_kv, query = (torch.from_numpy(np.ascontiguousarray(a))
                                   for a in _make(b, d, l, e, seed=80))
    args = (x, scale, bias, w_kv.T.contiguous(), query)
    want_fwd = TP.attentive_pool_plain(*args, heads)
    wide = [a.double() for a in args]
    for name, got, want in zip(("out", "m", "den"), _factored_fwd(*wide, heads), want_fwd):
        np.testing.assert_allclose(to_np(got), to_np(want), **FP32_TOL, err_msg=name)
    out, m, den = want_fwd
    g = torch.from_numpy(rng_normal(81, b, l, e))
    want = TP.attentive_pool_bwd_plain(*args, out, m, den, g, heads, need_dx=need_dx)
    got = _factored_bwd(*wide, out.double(), m.double(), den.double(), g.double(), heads,
                        need_dx=need_dx)
    assert (got[0] is None) == (not need_dx)
    for name, gk, gw in zip(GRAD_NAMES, got, want):
        if gw is not None:
            np.testing.assert_allclose(to_np(gk), to_np(gw), **FP32_TOL, err_msg=name)
