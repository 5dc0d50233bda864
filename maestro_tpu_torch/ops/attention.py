"""Multi-head attention on the head-packed ``[B, L, H, D]`` layout.

``mha_blhd`` launches ``flash_attention_fwd`` (csrc/flash_attention.cu) for a
CUDA tensor and runs ``mha_blhd_plain`` for a CPU tensor.

Replaces, in the JAX package's ``ops/attention.py``: the forward passes of
``packed_single_block_attention`` (``_pk_fwd_kernel``),
``packed_qblock_attention`` (``_qb_fwd_kernel``), ``single_block_attention``
(``_sb_fwd_kernel``), the stock flash kernel behind ``_flash`` and the einsum
tier for short sequences.  Those tiers exist because of on-chip memory size
and the 128-lane layout of the other accelerator; the mathematics is one
function, so here it is one kernel.

What bounds it on an H100: operations.  At the serving path's shapes
(D = 128, L = 200..1880) the two products need 4*B*H*L^2*D operations against
4*B*L*H*D elements of traffic, i.e. L/2 operations per byte in bf16 — above
the card's ~295 for the trunk (L = 1880), near or below it for the short
streams, which are in practice launch- and occupancy-bound.  The design keeps
scores, softmax and the P tile in registers (online softmax over 64-key
tiles), reads q/k/v straight out of the fused qkv projection through strides
(no transposed or contiguous copy), masks ragged tiles in the kernel (no
padding of L in device memory), and runs both products on the tensor cores
(``mma.sync`` bf16, fp32 accumulation).  fp32 inputs take a shared-memory FMA
kernel with the same tiling and full fp32 products.  ``wgmma``, TMA and
pipelined loads are left for a later change.
"""

from __future__ import annotations

import ctypes

import torch

SUPPORTED_HEAD_DIMS = (32, 64, 96, 128)

launch_count = 0  # incremented once per kernel launch, nowhere else

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_fn = None


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


def _kernel():
    global _fn
    if _fn is None:
        from maestro_tpu_torch.ops.cuda_build import load_library

        fn = load_library("flash_attention").flash_attention_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4  # q, k, v, o
            + [ctypes.c_int] * 4  # B, L, H, D
            + [ctypes.c_longlong] * 12  # (batch, row, head) strides of q, k, v, o
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
        )
        _fn = fn
    return _fn


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
    b, l, _, d = q.shape
    if b < 1 or l < 1:
        msg = f"empty attention input {tuple(q.shape)}"
        raise ValueError(msg)
    if d not in SUPPORTED_HEAD_DIMS:
        msg = (
            f"head dim {d} is not supported by flash_attention_fwd; "
            f"supported: {SUPPORTED_HEAD_DIMS}"
        )
        raise ValueError(msg)


def mha_blhd(
    q: torch.Tensor,  # [B, L, H, D], any batch/row/head strides, D contiguous
    k: torch.Tensor,
    v: torch.Tensor,
    sm_scale: float,
) -> torch.Tensor:
    """Exact softmax attention; returns a contiguous ``[B, L, H, D]`` tensor."""
    global launch_count
    _check(q, k, v)
    if q.device.type == "cpu":
        return mha_blhd_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        msg = f"mha_blhd runs on cuda or cpu tensors, got {q.device}"
        raise ValueError(msg)
    b, l, h, d = q.shape
    if b > 65535 or h > 65535:
        msg = f"batch {b} / heads {h} exceed the kernel's grid limits"
        raise ValueError(msg)
    for name, t in (("q", q), ("k", k), ("v", v)):
        # the kernel reads 16-byte vectors along D
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
            (s * t.element_size()) % 16 for s in t.stride()[:3]
        ):
            msg = (
                f"{name} must have a contiguous last dim and 16-byte aligned "
                f"base and strides, got strides {t.stride()}"
            )
            raise ValueError(msg)
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
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
    return out
