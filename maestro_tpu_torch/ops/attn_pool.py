"""Fused attentive date pool: LayerNorm + kv projection + softmax reduction,
forward and backward.

``attentive_pool`` is differentiable in ``x`` and in the four fp32 parameters
(``ln_scale``, ``ln_bias``, ``w_kv``, ``query``).  Its forward is one
registered op, ``torch.ops.maestro.attentive_pool_fwd`` (``attentive_pool_fwd``
below): for a CUDA tensor it launches the kernels of csrc/attn_pool.cu, for a
CPU tensor it runs ``attentive_pool_plain``, and its fake version gives the
shapes to ``torch.export``.  Without a gradient the op is called directly;
with one, an autograd ``Function`` calls it forward and runs
``attentive_pool_bwd`` backward (csrc/attn_pool_bwd.cu for a CUDA tensor,
``attentive_pool_bwd_plain`` for a CPU one).

Replaces the JAX package's ``ops/attn_pool.py`` (``attentive_pool`` with its
``_fwd_kernel`` and ``_bwd_kernel``) and computes what its
``attentive_pool_reference`` computes: for every (batch, position), one learned
query attends over the date axis of ``x [B, D, L, E]``; the final ``norm_fc``
LayerNorm stays in ``AttentiveReduce``.  As there, the forward saves
``(x, out, m, den)`` and the backward takes the softmax pivot from the saved
``out``: no second sweep over the dates.

What bounds it on an H100, and the design.  The TPU kernel forms the kv
projection of every (batch, date, position) row, ``4*E*E`` operations a row
forward and ``12*E*E`` backward, and so did this port's first kernels.  The
function needs far less: with ``u_h = sum_{j in h} q_j W_k[j, :]`` the logit
of head h is ``dh^-1/2 * y_d . u_h`` and the pooled output is ``W_v,h . ybar_h``
with ``ybar_h = sum_d a_dh y_d``, so a row costs about ``4*E*H + 8*E`` fp32
operations forward (``12*E*H + 21*E`` backward) and the ``E x E`` products
remain once per position, on the tensor cores.  At ``[32, 26, 128, 768]`` that
is 3.3 GFLOP of fp32 work plus 4.8 GFLOP of products forward, against 251 GFLOP
by the JAX count, and reading x once (164 MB) takes about as long as the fp32
work: the forward is bound by both at about 0.05 ms, the backward by its fp32
work at about 0.15 ms.  The kernels (csrc/attn_pool.cu, csrc/attn_pool_bwd.cu,
csrc/pool_common.cuh) read x once per call, one block over a run of positions
and eight columns of E a thread; their sources give each launch.  They take at
most 8 heads (``MAX_HEADS``), as every pool of the models has.

Precision: logits, softmax, ``u``, ``ybar`` and the backward's ``dybar``,
``du`` and every sum are fp32; the LayerNorm statistics are fp32 values of
fp64 sums and y is formed in the plain version's order of fp32 operations,
then rounded to x's dtype before the logits and ``ybar`` (as the plain version
rounds LN(x) before the kv projection); ``w_kv`` is multiplied as bf16.
``ybar`` and ``g`` are rounded to bf16 as operands of the tensor-core products
(fp32 accumulation).  For fp32 ``x`` the plain version keeps fp32 operands, so
kernel and plain version then differ by that rounding (about 1e-3 relative);
the serving and training paths run bf16.  The parameter gradients are fp32
sums in a fixed order: two calls on the same inputs give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from maestro_tpu_torch.ops.attention import needs_grad

# 8 heads at E = 128, 384 (small), 768 (medium, base), 1024 (large)
SUPPORTED_HEAD_DIMS = (16, 48, 96, 128)
MAX_EMBED_DIM = 1024
MAX_HEADS = 8  # csrc/pool_common.cuh kMaxHeads

launch_count = 0  # once per forward call (its three launches), nowhere else
bwd_launch_count = 0  # once per backward call (its six launches), nowhere else
plain_count = 0  # calls of either plain version, on any device: a run on the card keeps it 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_libs: dict[str, ctypes.CDLL] = {}


def attentive_pool_plain(
    x: torch.Tensor,  # [B, D, L, E]
    ln_scale: torch.Tensor,  # [E]
    ln_bias: torch.Tensor,  # [E]
    w_kv: torch.Tensor,  # [2E, E] (nn.Linear layout: rows 0..E-1 -> k, E.. -> v)
    query: torch.Tensor,  # [E], split as [heads, dh]
    heads: int,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(out [B, L, E], m [B, L, H], den [B, L, H])``.

    fp32 everywhere except that LN(x) and ``w_kv`` are rounded to ``x``'s
    dtype as operands of the kv projection (accumulated in fp32).
    """
    global plain_count
    plain_count += 1
    b, d, l, e = x.shape
    dh = e // heads
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    y = y.to(x.dtype).float()
    kv = y @ w_kv.to(x.dtype).float().T  # [B, D, L, 2E]
    k, v = kv.split(e, dim=-1)
    k = k.reshape(b, d, l, heads, dh)
    v = v.reshape(b, d, l, heads, dh)
    q = query.float().reshape(heads, dh)
    logits = torch.einsum("he,bdlhe->bdlh", q, k) * dh**-0.5
    m = logits.amax(dim=1)  # [B, L, H]
    p = torch.exp(logits - m[:, None])
    den = p.sum(dim=1)
    out = torch.einsum("bdlh,bdlhe->blhe", p / den[:, None], v)
    return out.reshape(b, l, e).to(x.dtype), m, den




def attentive_pool_bwd_plain(
    x: torch.Tensor,  # [B, D, L, E]
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w_kv: torch.Tensor,  # [2E, E]
    query: torch.Tensor,
    out: torch.Tensor,  # [B, L, E], the saved forward output
    m: torch.Tensor,  # [B, L, H]
    den: torch.Tensor,  # [B, L, H]
    g: torch.Tensor,  # [B, L, E], dLoss/dout
    heads: int,
    eps: float = 1e-5,
    need_dx: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, step by step as the JAX
    kernel takes it: ``(dx or None, d_ln_scale, d_ln_bias, d_w_kv, d_query)``.

    The softmax pivot ``T_h = sum_{e in h} g_e out_e`` comes from the saved
    ``out``; per date, LN and kv are recomputed, ``a = exp(logit - m) / den``,
    ``dlogit = a (t - T)`` with ``t_h = sum_{e in h} g_e v_e``,
    ``dv = a g``, ``dk = dlogit query dh^-1/2``, ``dy = [dk, dv] . w_kv`` and
    the LayerNorm backward gives ``dx``.  Operands of the products are
    rounded to x's dtype, ``[dk, dv]`` included; everything else is fp32.
    ``dx`` is in x's dtype, the parameter gradients fp32.
    """
    global plain_count
    plain_count += 1
    b, d, l, e = x.shape
    dh = e // heads
    sm_scale = dh**-0.5
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((xf - mu).square().mean(dim=-1, keepdim=True) + eps)
    xhat = (xf - mu) * rstd
    y = (xhat * ln_scale.float() + ln_bias.float()).to(x.dtype).float()
    w = w_kv.to(x.dtype).float()
    k, v = (y @ w.T).split(e, dim=-1)  # [B, D, L, E] each
    k = k.reshape(b, d, l, heads, dh)
    v = v.reshape(b, d, l, heads, dh)
    q = query.float().reshape(heads, dh)
    logits = torch.einsum("he,bdlhe->bdlh", q, k) * sm_scale
    a = torch.exp(logits - m[:, None]) / den[:, None]  # [B, D, L, H]
    gf = g.float().reshape(b, 1, l, heads, dh)
    pivot = (gf[:, 0] * out.float().reshape(b, l, heads, dh)).sum(dim=-1)  # [B, L, H]
    dlogit = a * ((gf * v).sum(dim=-1) - pivot[:, None])
    dk = dlogit[..., None] * q * sm_scale
    dv = a[..., None] * gf
    dkv = torch.cat([dk.reshape(b, d, l, e), dv.reshape(b, d, l, e)], dim=-1)
    dkv = dkv.to(x.dtype).float()
    dy = dkv @ w  # [B, D, L, E]
    d_w_kv = dkv.reshape(-1, 2 * e).T @ y.reshape(-1, e)
    d_query = (dlogit[..., None] * k).sum(dim=(0, 1, 2)).reshape(e) * sm_scale
    d_scale = (dy * xhat).sum(dim=(0, 1, 2))
    d_bias = dy.sum(dim=(0, 1, 2))
    dx = None
    if need_dx:
        dxh = dy * ln_scale.float()
        dx = rstd * (dxh - dxh.mean(dim=-1, keepdim=True)
                     - xhat * (dxh * xhat).mean(dim=-1, keepdim=True))
        dx = dx.to(x.dtype)
    return dx, d_scale, d_bias, d_w_kv, d_query


def _lib(name: str) -> ctypes.CDLL:
    """csrc/<name>.cu's library with its C functions' signatures set."""
    lib = _libs.get(name)
    if lib is None:
        from maestro_tpu_torch.ops.cuda_build import load_library

        lib = load_library(name)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "attn_pool":
            lib.attentive_pool_fwd.argtypes = (
                # x, ln_scale, ln_bias, w_kv, query, u, ybar, out, m, den
                [ptr] * 10 + [i32] * 5 + [f32, i32, ptr]  # B, D, L, E, H; eps, dtype, stream
            )
            lib.attentive_pool_fwd_smem_bytes.argtypes = [i32]
        else:
            lib.attentive_pool_bwd.argtypes = (
                # x, ln_scale, ln_bias, w_kv, query, out, g, g16, m, den, dx,
                # u, dybar, ybar, part, small, dwv_part, d_w, d_query
                [ptr] * 19 + [i32] * 5 + [f32, i32, ptr]  # B, D, L, E, H; eps, dtype, stream
            )
            lib.attentive_pool_bwd_plan.argtypes = [ctypes.c_longlong, i32, i32, i32, ptr]
            lib.attentive_pool_bwd_smem_bytes.argtypes = [i32]
        _libs[name] = lib
    return lib


def _kernel() -> ctypes.CDLL:
    return _lib("attn_pool")


def _bwd_kernel() -> ctypes.CDLL:
    return _lib("attn_pool_bwd")


def smem_bytes(e: int, backward: bool) -> int:
    """Dynamic shared memory of the row kernel (forward or backward) at width E."""
    if backward:
        return _bwd_kernel().attentive_pool_bwd_smem_bytes(e)
    return _kernel().attentive_pool_fwd_smem_bytes(e)


def _check_params(x, ln_scale, ln_bias, w_kv, query, heads) -> None:
    if x.ndim != 4:
        msg = f"x must be [B, D, L, E], got {tuple(x.shape)}"
        raise ValueError(msg)
    b, d, l, e = x.shape
    if b < 1 or d < 1 or l < 1 or heads < 1 or e % heads:
        msg = f"bad pool shape {tuple(x.shape)} with {heads} heads"
        raise ValueError(msg)
    if x.dtype not in _DTYPE_CODE:
        msg = f"x must be bfloat16 or float32, got {x.dtype}"
        raise TypeError(msg)
    if (
        tuple(ln_scale.shape) != (e,) or tuple(ln_bias.shape) != (e,)
        or tuple(query.shape) != (e,) or tuple(w_kv.shape) != (2 * e, e)
    ):
        msg = (
            f"expected ln_scale/ln_bias/query [{e}] and w_kv [{2 * e}, {e}], got "
            f"{tuple(ln_scale.shape)}, {tuple(ln_bias.shape)}, {tuple(query.shape)}, "
            f"{tuple(w_kv.shape)}"
        )
        raise ValueError(msg)
    if x.device.type not in ("cpu", "cuda"):
        msg = f"attentive_pool runs on cuda or cpu tensors, got {x.device}"
        raise ValueError(msg)
    if any(t.device != x.device for t in (ln_scale, ln_bias, w_kv, query)):
        msg = "attentive_pool: parameters must lie on x's device"
        raise ValueError(msg)


def _check_kernel_shape(e: int, heads: int, name: str) -> None:
    dh = e // heads
    if dh not in SUPPORTED_HEAD_DIMS or e % 64 or e > MAX_EMBED_DIM or heads > MAX_HEADS:
        msg = (
            f"{name} is built for head dims {SUPPORTED_HEAD_DIMS}, at most {MAX_HEADS} heads "
            f"and E a multiple of 64 up to {MAX_EMBED_DIM}; got E={e}, heads={heads}"
        )
        raise ValueError(msg)


def _raise_on(err: int, name: str, x: torch.Tensor) -> None:
    if err != 0:
        msg = f"{name} launch failed with CUDA error {err} for x {tuple(x.shape)} {x.dtype}"
        raise RuntimeError(msg)


def _params32(ln_scale, ln_bias, query):
    return tuple(t.detach().to(torch.float32).contiguous() for t in (ln_scale, ln_bias, query))


def _fwd_kernel(x, ln_scale, ln_bias, w16, query, heads, eps):
    """One call of ``attentive_pool_fwd`` (three launches): ``(out, m, den)``."""
    global launch_count
    b, d, l, e = x.shape
    _check_kernel_shape(e, heads, "attentive_pool_fwd")
    dev = x.device
    x = x.contiguous()
    scale32, bias32, query32 = _params32(ln_scale, ln_bias, query)
    w16 = w16.detach().to(torch.bfloat16).contiguous()
    u = torch.empty((MAX_HEADS, e), dtype=torch.float32, device=dev)
    ybar = torch.empty((b * l, heads, e), dtype=torch.bfloat16, device=dev)
    out = torch.empty((b, l, e), dtype=x.dtype, device=dev)
    m = torch.empty((b, l, heads), dtype=torch.float32, device=dev)
    den = torch.empty_like(m)
    with torch.cuda.device(dev):
        err = _kernel().attentive_pool_fwd(
            x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), w16.data_ptr(),
            query32.data_ptr(), u.data_ptr(), ybar.data_ptr(), out.data_ptr(), m.data_ptr(),
            den.data_ptr(), b, d, l, e, heads, float(eps), _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "attentive_pool_fwd", x)
    launch_count += 1
    return out, m, den


def attentive_pool_bwd(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w_kv: torch.Tensor,
    query: torch.Tensor,
    out: torch.Tensor,
    m: torch.Tensor,
    den: torch.Tensor,
    g: torch.Tensor,
    heads: int,
    eps: float = 1e-5,
    need_dx: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of the pool from the saved ``(x, out, m, den)`` and the
    gradient ``g`` of ``out``: ``(dx or None, d_ln_scale, d_ln_bias, d_w_kv,
    d_query)``, dx in x's dtype and the rest fp32.

    For CPU tensors ``attentive_pool_bwd_plain``; for CUDA tensors the kernels
    of csrc/attn_pool_bwd.cu (``w_kv`` multiplied as bf16)."""
    global bwd_launch_count
    _check_params(x, ln_scale, ln_bias, w_kv, query, heads)
    b, d, l, e = x.shape
    if tuple(out.shape) != (b, l, e) or tuple(g.shape) != (b, l, e):
        msg = f"out and g must be [{b}, {l}, {e}], got {tuple(out.shape)}, {tuple(g.shape)}"
        raise ValueError(msg)
    if tuple(m.shape) != (b, l, heads) or tuple(den.shape) != (b, l, heads):
        msg = f"m and den must be [{b}, {l}, {heads}], got {tuple(m.shape)}, {tuple(den.shape)}"
        raise ValueError(msg)
    if m.dtype != torch.float32 or den.dtype != torch.float32:
        msg = f"m and den must be float32, got {m.dtype}, {den.dtype}"
        raise TypeError(msg)
    if any(t.device != x.device for t in (out, m, den, g)):
        msg = "attentive_pool_bwd: out, m, den and g must lie on x's device"
        raise ValueError(msg)
    if x.device.type == "cpu":
        return attentive_pool_bwd_plain(x, ln_scale, ln_bias, w_kv, query, out, m, den, g,
                                        heads, eps, need_dx)
    _check_kernel_shape(e, heads, "attentive_pool_bwd")
    dev = x.device
    x = x.contiguous()
    out = out.to(x.dtype).contiguous()
    g = g.to(x.dtype).contiguous()
    g16 = g if g.dtype == torch.bfloat16 else g.to(torch.bfloat16)  # tensor-core operand
    m, den = m.contiguous(), den.contiguous()
    scale32, bias32, query32 = _params32(ln_scale, ln_bias, query)
    w16 = w_kv.detach().to(torch.bfloat16).contiguous()
    n_pos = b * l
    lib = _bwd_kernel()
    plan = (ctypes.c_int * 2)()
    with torch.cuda.device(dev):
        _raise_on(lib.attentive_pool_bwd_plan(n_pos, e, heads, _DTYPE_CODE[x.dtype], plan),
                  "attentive_pool_bwd (plan)", x)
    row_blocks, splits = plan
    dx = torch.empty_like(x) if need_dx else None
    f32 = {"dtype": torch.float32, "device": dev}
    u = torch.empty((MAX_HEADS, e), **f32)
    dybar = torch.empty((n_pos, heads, e), **f32)
    ybar = torch.empty((n_pos, heads, e), dtype=torch.bfloat16, device=dev)
    part = torch.empty((row_blocks, (heads + 2) * e), **f32)
    small = torch.empty((heads + 2) * e, **f32)  # du | d_ln_scale | d_ln_bias
    dwv_part = torch.empty((splits, e, e), **f32)
    d_w = torch.empty((2 * e, e), **f32)
    d_query = torch.empty(e, **f32)
    with torch.cuda.device(dev):
        err = lib.attentive_pool_bwd(
            x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), w16.data_ptr(),
            query32.data_ptr(), out.data_ptr(), g.data_ptr(), g16.data_ptr(), m.data_ptr(),
            den.data_ptr(), 0 if dx is None else dx.data_ptr(), u.data_ptr(), dybar.data_ptr(),
            ybar.data_ptr(), part.data_ptr(), small.data_ptr(), dwv_part.data_ptr(),
            d_w.data_ptr(), d_query.data_ptr(), b, d, l, e, heads, float(eps),
            _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "attentive_pool_bwd", x)
    bwd_launch_count += 1
    return dx, small[heads * e:(heads + 1) * e], small[(heads + 1) * e:], d_w, d_query


def _bf16_weight(x, w_kv, w_kv_bf16):
    """On the card, the bf16 copy of ``w_kv`` the kernels multiply with."""
    if x.device.type != "cuda":
        return None
    w16 = w_kv.detach().to(torch.bfloat16) if w_kv_bf16 is None else w_kv_bf16
    if w16.shape != w_kv.shape or w16.dtype != torch.bfloat16 or w16.device != x.device:
        msg = f"w_kv_bf16 must be a bfloat16 {tuple(w_kv.shape)} tensor on {x.device}"
        raise ValueError(msg)
    return w16


def attentive_pool_forward(x, ln_scale, ln_bias, w_kv, query, heads, eps=1e-5,
                           w_kv_bf16=None):
    """``(out, m, den)`` with no gradient: the forward of ``attentive_pool``
    (the kernel for a CUDA tensor, the plain version for a CPU one), for a
    caller that runs the backward itself with ``attentive_pool_bwd``."""
    _check_params(x, ln_scale, ln_bias, w_kv, query, heads)
    return _pool_fwd(x, ln_scale, ln_bias, w_kv, query, heads, eps,
                     _bf16_weight(x, w_kv, w_kv_bf16))


@torch.library.custom_op("maestro::attentive_pool_fwd", mutates_args=(), device_types="cpu")
def attentive_pool_fwd(
    x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor, w_kv: torch.Tensor,
    query: torch.Tensor, heads: int, eps: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pool's forward as a registered op: ``(out [B, L, E], m [B, L, H],
    den [B, L, H])``, contiguous, m and den fp32.  On the card ``w_kv`` may
    be its bf16 copy (the kernels multiply in bf16 either way).  This body
    serves CPU tensors, with the plain version."""
    out, m, den = attentive_pool_plain(x, ln_scale, ln_bias, w_kv, query, heads, eps)
    return out.contiguous(), m, den


@attentive_pool_fwd.register_kernel("cuda")
def _attentive_pool_fwd_cuda(x, ln_scale, ln_bias, w_kv, query, heads, eps):
    return _fwd_kernel(x, ln_scale, ln_bias, w_kv, query, heads, eps)


@attentive_pool_fwd.register_fake
def _attentive_pool_fwd_fake(x, ln_scale, ln_bias, w_kv, query, heads, eps):
    b, _, l, e = x.shape
    stats = x.new_empty((b, l, heads), dtype=torch.float32)
    return x.new_empty((b, l, e)), stats, torch.empty_like(stats)


def _pool_fwd(x, ln_scale, ln_bias, w_kv, query, heads, eps, w16):
    with torch.no_grad():
        return attentive_pool_fwd(x, ln_scale, ln_bias, w_kv if w16 is None else w16, query,
                                  heads, eps)


class _AttentivePool(torch.autograd.Function):
    """The pool with its gradient in x and the four parameters; saves
    ``(x, out, m, den)`` and the parameters, as the JAX ``_vjp_fwd`` does."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w_kv, query, heads, eps, w16):
        out, m, den = _pool_fwd(x, ln_scale, ln_bias, w_kv, query, heads, eps, w16)
        ctx.mark_non_differentiable(m, den)
        ctx.save_for_backward(x, ln_scale, ln_bias, w_kv, query, out, m, den, w16)
        ctx.heads, ctx.eps = heads, eps
        return out, m, den

    @staticmethod
    def backward(ctx, g, g_m, g_den):
        del g_m, g_den  # m and den are statistics, not differentiable outputs
        x, ln_scale, ln_bias, w_kv, query, out, m, den, w16 = ctx.saved_tensors
        dx, d_scale, d_bias, d_w, d_query = attentive_pool_bwd(
            x, ln_scale, ln_bias, w_kv if w16 is None else w16, query, out, m, den, g,
            ctx.heads, ctx.eps, need_dx=ctx.needs_input_grad[0],
        )
        return (dx, d_scale.to(ln_scale.dtype), d_bias.to(ln_bias.dtype),
                d_w.to(w_kv.dtype), d_query.to(query.dtype), None, None, None)


def attentive_pool(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w_kv: torch.Tensor,
    query: torch.Tensor,
    heads: int,
    eps: float = 1e-5,
    w_kv_bf16: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[B, D, L, E] -> out [B, L, E]`` plus the softmax statistics
    ``m, den [B, L, H]`` (fp32, not differentiable); ``out`` is
    differentiable in ``x`` and the parameters.

    On the card ``w_kv`` is multiplied as bf16: a caller that keeps a bf16
    copy of it passes it as ``w_kv_bf16`` and saves a cast on every launch
    (the gradient still goes to ``w_kv``)."""
    _check_params(x, ln_scale, ln_bias, w_kv, query, heads)
    w16 = _bf16_weight(x, w_kv, w_kv_bf16)
    if needs_grad(x, ln_scale, ln_bias, w_kv, query):
        return _AttentivePool.apply(x, ln_scale, ln_bias, w_kv, query, heads, eps, w16)
    return attentive_pool_fwd(x, ln_scale, ln_bias, w_kv if w16 is None else w16, query,
                              heads, eps)
