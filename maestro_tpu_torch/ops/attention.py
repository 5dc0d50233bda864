"""Multi-head attention on the head-packed ``[B, L, H, D]`` layout, with its
gradient.

For CUDA tensors ``mha_blhd`` / ``mha_qkv`` are ``torch.autograd.Function``s:
the forward launches ``flash_attention_fwd`` (csrc/flash_attention.cu), which
also writes each row's fp32 logsumexp when a gradient will be needed, and the
backward launches ``flash_attention_bwd`` (csrc/flash_attention_bwd.cu).  For
CPU tensors both run ``mha_blhd_plain``, whose autograd is the backward's
plain version.

Replaces, in the JAX package's ``ops/attention.py``: the forward and backward
passes of ``packed_single_block_attention`` (``_pk_fwd_kernel``,
``_pk_bwd_kernel``), ``packed_qblock_attention`` (``_qb_*``),
``single_block_attention`` (``_sb_*``), the stock flash kernel behind
``_flash`` and the einsum tier for short sequences.  Those tiers exist because
of on-chip memory size and the 128-lane layout of the other accelerator; the
mathematics is one function, so here it is one kernel each way.

What bounds it on an H100: operations.  At the model's shapes (D = 128,
L = 50..1880) the forward's two products need 4*B*H*L^2*D operations against
4*B*L*H*D elements of traffic, i.e. L/2 operations per byte in bf16 — above
the card's ~295 for the long sequences, near or below it for the short
streams, which are in practice launch- and occupancy-bound.  The forward keeps
scores, softmax and the P tile in registers (online softmax over 64-key
tiles), reads q/k/v straight out of the fused qkv projection through strides
(no transposed or contiguous copy), masks ragged tiles in the kernel (no
padding of L in device memory), and runs both products on the tensor cores
(``mma.sync`` bf16, fp32 accumulation).  The backward (10*B*H*L^2*D
operations) is described in its source.  fp32 inputs take shared-memory FMA
kernels with full fp32 products.  ``wgmma``, TMA and pipelined loads are left
for a later change.
"""

from __future__ import annotations

import ctypes

import torch

SUPPORTED_HEAD_DIMS = (32, 64, 96, 128)

launch_count = 0  # forward: incremented once per flash_attention_fwd launch, nowhere else
bwd_launch_count = 0  # backward: once per flash_attention_bwd call (its three launches)

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_fwd_fn = None
_bwd_fn = None


def mha_blhd_plain(
    q: torch.Tensor,  # [B, L, H, D]
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """Plain PyTorch version: fp32 scores and softmax, P rounded to V's dtype
    before P·V (as the JAX package's einsum tier, ops/attention.py:51-56)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    attn = torch.softmax(logits * sm_scale, dim=-1).to(v.dtype)
    if v.dtype == torch.float32:
        return torch.einsum("bhqk,bkhd->bqhd", attn, v).contiguous()
    # fp32 accumulation of the rounded P against V, one rounding at the end
    out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
    return out.to(v.dtype).contiguous()


def logsumexp_plain(q: torch.Tensor, k: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """fp32 ``[B, H, L]`` logsumexp of the scaled scores: what the forward
    kernel saves for the backward."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return torch.logsumexp(logits * sm_scale, dim=-1)


def _load_fwd():
    global _fwd_fn
    if _fwd_fn is None:
        from maestro_tpu_torch.ops.cuda_build import load_library

        fn = load_library("flash_attention").flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5  # q, k, v, o, lse (null: not written)
            + [ctypes.c_int] * 4  # B, L, H, D
            + [ctypes.c_longlong] * 12  # (batch, row, head) strides of q, k, v, o
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
        )
        _fwd_fn = fn
    return _fwd_fn


def _load_bwd():
    global _bwd_fn
    if _bwd_fn is None:
        from maestro_tpu_torch.ops.cuda_build import load_library

        fn = load_library("flash_attention_bwd").flash_attention_bwd
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 10  # q, k, v, o, dO, lse, delta, dq, dk, dv
            + [ctypes.c_int] * 4  # B, L, H, D
            + [ctypes.c_longlong] * 18  # strides of q, k, v, o, dO, and of dq/dk/dv
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
        )
        _bwd_fn = fn
    return _bwd_fn


def _kernel():
    """Both attention libraries (built together at first use)."""
    return _load_fwd(), _load_bwd()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or q.shape != k.shape or q.shape != v.shape:
        msg = f"q, k, v must share one [B, L, H, D] shape, got {q.shape}, {k.shape}, {v.shape}"
        raise ValueError(msg)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        msg = f"q, k, v must all be bfloat16 or all float32, got {q.dtype}, {k.dtype}, {v.dtype}"
        raise TypeError(msg)
    if not (q.device == k.device == v.device):
        msg = "q, k, v must lie on one device"
        raise ValueError(msg)
    b, l, _, _ = q.shape
    if b < 1 or l < 1:
        msg = f"empty attention input {tuple(q.shape)}"
        raise ValueError(msg)
    if q.device.type not in ("cpu", "cuda"):
        msg = f"attention runs on cuda or cpu tensors, got {q.device}"
        raise ValueError(msg)


def check_kernel_shape(q: torch.Tensor) -> None:
    """Raise unless the kernels take this ``[B, L, H, D]`` shape (the plain
    version, which CPU tensors take, accepts any head dim)."""
    b, _, h, d = q.shape
    if d not in SUPPORTED_HEAD_DIMS:
        msg = (
            f"head dim {d} is not supported by the attention kernels; "
            f"supported: {SUPPORTED_HEAD_DIMS}"
        )
        raise ValueError(msg)
    if b > 65535 or h > 65535:
        msg = f"batch {b} / heads {h} exceed the kernel's grid limits"
        raise ValueError(msg)


def _aligned(t: torch.Tensor) -> bool:
    """The kernels read 16-byte vectors along D: a contiguous last dim and
    16-byte aligned base and strides."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        (s * t.element_size()) % 16 == 0 for s in t.stride()[:3]
    )


def _check_layout(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not _aligned(t):
            msg = (
                f"{name} must have a contiguous last dim and 16-byte aligned "
                f"base and strides, got strides {t.stride()}"
            )
            raise ValueError(msg)


def _fwd(q, k, v, sm_scale: float, with_lse: bool):
    """Launch the forward kernel: ``(out [B, L, H, D], lse [B, H, L] or None)``."""
    global launch_count
    check_kernel_shape(q)
    _check_layout(q=q, k=k, v=v)
    b, l, h, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device) if with_lse else None
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _load_fwd()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, l, h, d, *strides, float(sm_scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = (
            f"flash_attention_fwd launch failed with CUDA error {err} "
            f"for shape {tuple(q.shape)} {q.dtype}"
        )
        raise RuntimeError(msg)
    launch_count += 1
    return out, lse


def _bwd(q, k, v, out, lse, dout, sm_scale: float) -> torch.Tensor:
    """Launch the backward kernels; returns ``dqkv [B, L, 3, H, D]`` (slots
    dq, dk, dv) in the input dtype."""
    global bwd_launch_count
    if dout.dtype != q.dtype:
        dout = dout.to(q.dtype)
    if not _aligned(dout):
        dout = dout.contiguous()
    b, l, h, d = q.shape
    dqkv = torch.empty((b, l, 3, h, d), dtype=q.dtype, device=q.device)
    delta = torch.empty((b, h, l), dtype=torch.float32, device=q.device)
    x_strides = (dqkv.stride(0), dqkv.stride(1), dqkv.stride(3))
    strides = [s for t in (q, k, v, out, dout) for s in t.stride()[:3]] + list(x_strides)
    with torch.cuda.device(q.device):
        err = _load_bwd()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            dqkv[:, :, 0].data_ptr(), dqkv[:, :, 1].data_ptr(), dqkv[:, :, 2].data_ptr(),
            b, l, h, d, *strides, float(sm_scale), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = (
            f"flash_attention_bwd launch failed with CUDA error {err} "
            f"for shape {tuple(q.shape)} {q.dtype}"
        )
        raise RuntimeError(msg)
    bwd_launch_count += 1
    return dqkv


class _Attention(torch.autograd.Function):
    """Kernel attention of separate q, k, v; the gradients are three views of
    one ``[B, L, 3, H, D]`` buffer."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        out, lse = _fwd(q, k, v, sm_scale, with_lse=any(ctx.needs_input_grad[:3]))
        if lse is not None:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dqkv = _bwd(q, k, v, out, lse, dout, ctx.sm_scale)
        return dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2], None


class _AttentionQKV(torch.autograd.Function):
    """Kernel attention of a fused ``[B, L, 3, H, D]`` projection; its
    gradient is one contiguous tensor of that shape."""

    @staticmethod
    def forward(ctx, qkv, sm_scale):
        q, k, v = qkv.unbind(dim=2)
        out, lse = _fwd(q, k, v, sm_scale, with_lse=ctx.needs_input_grad[0])
        if lse is not None:
            ctx.save_for_backward(qkv, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        q, k, v = qkv.unbind(dim=2)
        return _bwd(q, k, v, out, lse, dout, ctx.sm_scale), None


def mha_blhd(
    q: torch.Tensor,  # [B, L, H, D], any batch/row/head strides, D contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """Exact softmax attention; returns a contiguous ``[B, L, H, D]`` tensor."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return mha_blhd_plain(q, k, v, sm_scale)
    return _Attention.apply(q, k, v, float(sm_scale))


def mha_qkv(qkv: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Attention of a fused projection viewed as ``[B, L, 3, H, D]`` (slots q,
    k, v); returns a contiguous ``[B, L, H, D]`` tensor."""
    if qkv.ndim != 5 or qkv.shape[2] != 3:
        msg = f"qkv must be [B, L, 3, H, D], got {tuple(qkv.shape)}"
        raise ValueError(msg)
    q, k, v = qkv.unbind(dim=2)
    _check(q, k, v)
    if qkv.device.type == "cpu":
        return mha_blhd_plain(q, k, v, sm_scale)
    return _AttentionQKV.apply(qkv, float(sm_scale))


def mha_qkv_plain(qkv: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """``mha_qkv`` through the plain version on any device (no kernel)."""
    q, k, v = qkv.unbind(dim=2)
    return mha_blhd_plain(q, k, v, sm_scale)
