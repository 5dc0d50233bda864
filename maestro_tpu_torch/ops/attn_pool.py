"""Fused attentive date pool: LayerNorm + kv projection + softmax reduction.

``attentive_pool`` launches ``attentive_pool_fwd`` (csrc/attn_pool.cu) for a
CUDA tensor and runs ``attentive_pool_plain`` for a CPU tensor.

Replaces the forward of the JAX package's ``ops/attn_pool.py``
(``attentive_pool`` / ``_fwd_kernel``) and computes what its
``attentive_pool_reference`` computes: for every (batch, position), one learned
query per head attends over the date axis of ``x [B, D, L, E]``; the final
``norm_fc`` LayerNorm stays in ``AttentiveReduce``.

What bounds it on an H100: operations.  The kv projection needs
``4*B*D*L*E*E`` operations for ``B*D*L*E`` input elements — 2*E = 1536
operations per byte of bf16 input at E = 768, far above the card's ~295.  The
plain version is bound by bytes instead: it writes and re-reads LN(x)
``[B, D, L, E]`` and kv ``[B, D, L, 2E]`` through device memory.  The design
keeps both on chip: a block owns (row tile, one head), so its accumulator is
``[rows, dh]`` fp32 in tensor-core fragments rather than the ``[rows, E]`` fp32
tile plus ``[rows, 2E]`` kv tile the TPU kernel holds (which exceed an SM's
shared memory at E = 768); the date loop and the online softmax run inside the
block, x is read and out written once, and the per-head logit is a register dot
product with a 4-thread shuffle in place of the TPU kernel's selector matmuls.
Per 16-row group, k-warps multiply the k columns into partial logits and
v-warps multiply the v columns and pool (two warps of each kind when dh is a
multiple of 32); W_kv streams through a two-stage ``cp.async`` buffer.  A
block has 32 rows, so that the serving path's 512 rows spread over the SMs.

Precision: LayerNorm statistics, logits, softmax and the pooled sum are fp32;
the kv projection runs on the tensor cores with bf16 operands (LN(x) and
``w_kv`` rounded to bf16) and fp32 accumulation.  For bf16 ``x`` this is what
``attentive_pool_plain`` does too.  For fp32 ``x`` the plain version keeps
fp32 operands, so kernel and plain version then differ by bf16 operand
rounding (about 1e-2 relative); the serving path runs bf16.
"""

from __future__ import annotations

import ctypes

import torch

# 8 heads at E = 128, 384 (small), 768 (medium, base), 1024 (large)
SUPPORTED_HEAD_DIMS = (16, 48, 96, 128)
MAX_EMBED_DIM = 1024

launch_count = 0  # incremented once per kernel launch, nowhere else

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_fn = None


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


def _kernel():
    global _fn
    if _fn is None:
        from maestro_tpu_torch.ops.cuda_build import load_library

        fn = load_library("attn_pool").attentive_pool_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 8  # x, ln_scale, ln_bias, w_kv, query, out, m, den
            + [ctypes.c_int] * 5  # B, D, L, E, H
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # eps, dtype, stream
        )
        _fn = fn
    return _fn


def attentive_pool(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    w_kv: torch.Tensor,
    query: torch.Tensor,
    heads: int,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[B, D, L, E] -> out [B, L, E]`` plus the softmax statistics
    ``m, den [B, L, H]`` (fp32) that a backward pass needs.

    On the card ``w_kv`` is multiplied as bf16: a caller that keeps a bf16
    copy saves the cast on every launch."""
    global launch_count
    if x.ndim != 4:
        msg = f"x must be [B, D, L, E], got {tuple(x.shape)}"
        raise ValueError(msg)
    b, d, l, e = x.shape
    if min(b, d, l) < 1 or heads < 1 or e % heads:
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
    if x.device.type == "cpu":
        return attentive_pool_plain(x, ln_scale, ln_bias, w_kv, query, heads, eps)
    if x.device.type != "cuda":
        msg = f"attentive_pool runs on cuda or cpu tensors, got {x.device}"
        raise ValueError(msg)
    if any(t.device != x.device for t in (ln_scale, ln_bias, w_kv, query)):
        msg = "attentive_pool: parameters must lie on x's device"
        raise ValueError(msg)
    dh = e // heads
    if dh not in SUPPORTED_HEAD_DIMS or e % 64 or e > MAX_EMBED_DIM:
        msg = (
            f"attentive_pool_fwd is built for head dims {SUPPORTED_HEAD_DIMS} and "
            f"E a multiple of 64 up to {MAX_EMBED_DIM}; got E={e}, heads={heads}"
        )
        raise ValueError(msg)
    if heads > 65535:
        msg = f"{heads} heads exceed the kernel's grid limit"
        raise ValueError(msg)
    x = x.contiguous()
    scale32 = ln_scale.detach().to(torch.float32).contiguous()
    bias32 = ln_bias.detach().to(torch.float32).contiguous()
    query32 = query.detach().to(torch.float32).contiguous()
    w16 = w_kv.detach().to(torch.bfloat16).contiguous()
    out = torch.empty((b, l, e), dtype=x.dtype, device=x.device)
    m = torch.empty((b, l, heads), dtype=torch.float32, device=x.device)
    den = torch.empty_like(m)
    with torch.cuda.device(x.device):
        err = _kernel()(
            x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), w16.data_ptr(),
            query32.data_ptr(), out.data_ptr(), m.data_ptr(), den.data_ptr(),
            b, d, l, e, heads, float(eps), _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = (
            f"attentive_pool_fwd launch failed with CUDA error {err} "
            f"for x {tuple(x.shape)} {x.dtype}"
        )
        raise RuntimeError(msg)
    launch_count += 1
    return out, m, den
