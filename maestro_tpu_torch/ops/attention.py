"""Multi-head attention on the head-packed ``[B, L, H, D]`` layout, with its
gradient.

The forward is one registered op, ``torch.ops.maestro.flash_attention_fwd``
(``flash_attention_fwd`` below): on CUDA tensors it launches the kernel of
csrc/flash_attention.cu, which also writes each row's fp32 logsumexp when
asked; on CPU tensors it runs ``mha_blhd_plain``; its fake version gives the
shapes, so ``torch.export`` traces a model through it and the artifact calls
the kernel.  ``mha_blhd`` / ``mha_qkv`` call the op directly where no
gradient is needed.  With a gradient, CUDA tensors go through
``torch.autograd.Function``s whose forward calls the op and whose backward
launches ``flash_attention_bwd`` (csrc/flash_attention_bwd.cu); CPU tensors
run ``mha_blhd_plain``, whose autograd is the backward's plain version.

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
streams, which are in practice launch- and occupancy-bound.  The bf16 kernels
are built for Hopper: one thread feeds swizzled shared memory by TMA (tensor
maps of the strided views, so q, k, v are read straight out of the fused qkv
projection with no copy, and rows past L arrive zero-filled) through mbarrier
rings, and two warpgroups run every product as ``wgmma`` (fp32 accumulation,
P and dS rounded to bf16 as operands).  The forward keeps scores, the online
softmax and P in registers; the backward (10*B*H*L^2*D operations) forms S
once per (key block, query tile) and adds dQ into an fp32 scratch by bulk
reduce-add (``dq_scratch_shape``); both are described in their sources.  fp32
inputs take shared-memory FMA kernels with full fp32 products.
"""

from __future__ import annotations

import ctypes

import torch

SUPPORTED_HEAD_DIMS = (32, 64, 96, 128)

launch_count = 0  # forward: incremented once per flash_attention_fwd launch, nowhere else
bwd_launch_count = 0  # backward: once per flash_attention_bwd call (its three launches)
plain_count = 0  # calls of mha_blhd_plain, on any device: what a run on the card keeps at 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
DQ_TILE = 64  # queries per tile of the backward kernel's dQ scratch
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
    global plain_count
    plain_count += 1
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
            [ctypes.c_void_p] * 11  # q, k, v, o, dO, lse, delta, dq scratch, dq, dk, dv
            + [ctypes.c_int] * 4  # B, L, H, D
            + [ctypes.c_longlong] * 18  # strides of q, k, v, o, dO, and of dq/dk/dv
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
        )
        _bwd_fn = fn
    return _bwd_fn


def _kernel():
    """Both attention libraries (built together at first use)."""
    return _load_fwd(), _load_bwd()


def smem_bytes(d: int, backward: bool) -> int:
    """Dynamic shared memory of one block of the bf16 forward or backward
    kernel at head dim ``d`` (builds the libraries)."""
    from maestro_tpu_torch.ops.cuda_build import load_library

    fn = getattr(load_library("flash_attention_bwd" if backward else "flash_attention"),
                 "flash_attention_bwd_smem" if backward else "flash_attention_fwd_smem")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return fn(d)


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


def kernel_view_ok(t: torch.Tensor) -> bool:
    """Whether the kernels read this ``[B, L, H, D]`` view in place: TMA maps
    it with a 16-byte aligned base, 16-byte multiples as the batch, row and
    head strides, and a contiguous D.  Every q, k, v view of a fused
    ``[B, L, 3, H, D]`` projection qualifies when D is a multiple of 8."""
    return t.stride(3) == 1 and t.data_ptr() % 16 == 0 and all(
        (s * t.element_size()) % 16 == 0 for s in t.stride()[:3]
    )


def _check_layout(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not kernel_view_ok(t):
            msg = (
                f"{name} must have a contiguous last dim and 16-byte aligned "
                f"base and strides, got strides {t.stride()}"
            )
            raise ValueError(msg)


def dq_scratch_shape(b: int, l: int, h: int, d: int) -> tuple[int, ...]:
    """Shape of the bf16 backward's fp32 dQ scratch: for each (sample, head,
    64-query tile), the wgmma accumulators in thread order — float4 ``j`` of
    thread ``t`` holds rows ``16*(t//32) + (t%32)//4`` and ``+8`` of the tile,
    columns ``8*j + 2*(t%4)`` and ``+1`` (``dq_from_scratch_plain``)."""
    return (b, h, -(-l // DQ_TILE), d // 8, 128, 4)


def dq_from_scratch_plain(scratch: torch.Tensor, l: int, sm_scale: float) -> torch.Tensor:
    """Plain version of the backward's last launch: ``sm_scale`` times the
    scratch as an fp32 ``[B, L, H, D]`` tensor (padding rows dropped)."""
    b, h, n_q, d8, _, _ = scratch.shape
    # [b, h, qt, j, warp, g, q, (row half, column)] -> [b, qt, warp, half, g, h, j, q, column]
    x = scratch.reshape(b, h, n_q, d8, 4, 8, 4, 2, 2).permute(0, 2, 4, 7, 5, 1, 3, 6, 8)
    return (x.reshape(b, n_q * DQ_TILE, h, 8 * d8)[:, :l] * sm_scale).contiguous()


def _launch_error(name: str, err: int, maps: tuple[str, ...], q: torch.Tensor) -> RuntimeError:
    """The error of a failed launch; the sources' return codes past
    cudaError_t's name the tensor map, shared-memory size or launch that CUDA
    refused (``hopper_host::kMapRefused``, ``kSmemRefused``,
    ``kLaunchRefused``)."""
    if err >= 300_000:
        what = f"the wgmma kernel's launch was refused (CUDA error {err - 300_000})"
    elif err >= 200_000:
        what = f"the kernel's shared memory size was refused (CUDA error {err - 200_000})"
    elif err >= 100_000:
        what = (f"cuTensorMapEncodeTiled refused the TMA map of {maps[err % 100]} "
                f"(CUresult {(err - 100_000) // 100})")
    else:
        what = f"CUDA error {err}"
    return RuntimeError(f"{name} launch failed: {what} for shape {tuple(q.shape)} {q.dtype}")


def _fwd_args(q, k, v, out, lse, sm_scale: float) -> tuple:
    """The forward launch's arguments (no stream): the views' own pointers
    and strides; raises for a view the kernel cannot read in place."""
    check_kernel_shape(q)
    _check_layout(q=q, k=k, v=v)
    b, l, h, d = q.shape
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    return (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, l, h, d, *strides, float(sm_scale), _DTYPE_CODE[q.dtype],
    )


def _fwd(q, k, v, sm_scale: float, with_lse: bool):
    """Launch the forward kernel: ``(out [B, L, H, D], lse [B, H, L] or None)``."""
    global launch_count
    b, l, h, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, l), dtype=torch.float32, device=q.device) if with_lse else None
    args = _fwd_args(q, k, v, out, lse, sm_scale)
    with torch.cuda.device(q.device):
        err = _load_fwd()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise _launch_error("flash_attention_fwd", err, ("q", "k", "v"), q)
    launch_count += 1
    return out, lse


def _no_lse(q: torch.Tensor) -> torch.Tensor:
    """The op's second output when no logsumexp was asked for."""
    return q.new_empty((0,), dtype=torch.float32)


@torch.library.custom_op("maestro::flash_attention_fwd", mutates_args=(), device_types="cpu")
def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float, with_lse: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The attention forward as a registered op: ``(out [B, L, H, D]
    contiguous, lse [B, H, L] fp32)``, lse empty unless ``with_lse``.  q, k, v
    may be strided views (of one fused projection).  This body serves CPU
    tensors, with the plain versions."""
    out = mha_blhd_plain(q, k, v, sm_scale)
    return out, logsumexp_plain(q, k, sm_scale) if with_lse else _no_lse(q)


@flash_attention_fwd.register_kernel("cuda")
def _flash_attention_fwd_cuda(q, k, v, sm_scale, with_lse):
    out, lse = _fwd(q, k, v, sm_scale, with_lse)
    return out, _no_lse(q) if lse is None else lse


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, sm_scale, with_lse):
    b, l, h, d = q.shape
    lse = q.new_empty((b, h, l), dtype=torch.float32) if with_lse else _no_lse(q)
    return q.new_empty((b, l, h, d)), lse


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether a call on ``tensors`` records a gradient (the ops then go
    through their ``autograd.Function``, else straight to the forward op)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _bwd_args(q, k, v, out, lse, dout, delta, dq_scratch, dqkv, sm_scale: float) -> tuple:
    """The backward launch's arguments (no stream): every input read in
    place, raising for a view the kernels cannot take; gradients written into
    the slots of ``dqkv``."""
    _check_layout(q=q, k=k, v=v, out=out, dout=dout)
    b, l, h, d = q.shape
    x_strides = (dqkv.stride(0), dqkv.stride(1), dqkv.stride(3))
    strides = [s for t in (q, k, v, out, dout) for s in t.stride()[:3]] + list(x_strides)
    return (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if dq_scratch is None else dq_scratch.data_ptr(),
        dqkv[:, :, 0].data_ptr(), dqkv[:, :, 1].data_ptr(), dqkv[:, :, 2].data_ptr(),
        b, l, h, d, *strides, float(sm_scale), _DTYPE_CODE[q.dtype],
    )


def _bwd(q, k, v, out, lse, dout, sm_scale: float) -> torch.Tensor:
    """Launch the backward kernels; returns ``dqkv [B, L, 3, H, D]`` (slots
    dq, dk, dv) in the input dtype.  ``dout`` is the one input copied, when
    autograd hands over a layout the kernels cannot read."""
    global bwd_launch_count
    if dout.dtype != q.dtype:
        dout = dout.to(q.dtype)
    if not kernel_view_ok(dout):
        dout = dout.contiguous()
    b, l, h, d = q.shape
    dqkv = torch.empty((b, l, 3, h, d), dtype=q.dtype, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        # Delta and lse * log2 e in rows padded to whole 64-query tiles, and
        # the dQ scratch (zeroed by the first launch)
        delta = torch.empty((2, b, h, dq_scratch_shape(b, l, h, d)[2] * DQ_TILE), **f32)
        dq_scratch = torch.empty(dq_scratch_shape(b, l, h, d), **f32)
    else:
        delta, dq_scratch = torch.empty((b, h, l), **f32), None
    args = _bwd_args(q, k, v, out, lse, dout, delta, dq_scratch, dqkv, sm_scale)
    with torch.cuda.device(q.device):
        err = _load_bwd()(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise _launch_error("flash_attention_bwd", err, ("q", "k", "v", "dout"), q)
    bwd_launch_count += 1
    return dqkv


class _Attention(torch.autograd.Function):
    """Kernel attention of separate q, k, v; the gradients are three views of
    one ``[B, L, 3, H, D]`` buffer."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        with_lse = any(ctx.needs_input_grad[:3])
        out, lse = flash_attention_fwd(q, k, v, sm_scale, with_lse)
        if with_lse:
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
        out, lse = flash_attention_fwd(q, k, v, sm_scale, ctx.needs_input_grad[0])
        if ctx.needs_input_grad[0]:
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
    if not needs_grad(q, k, v):
        return flash_attention_fwd(q, k, v, float(sm_scale), False)[0]
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
    if not needs_grad(qkv):
        return flash_attention_fwd(q, k, v, float(sm_scale), False)[0]
    if qkv.device.type == "cpu":
        return mha_blhd_plain(q, k, v, sm_scale)
    return _AttentionQKV.apply(qkv, float(sm_scale))


def mha_qkv_plain(qkv: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """``mha_qkv`` through the plain version on any device (no kernel)."""
    q, k, v = qkv.unbind(dim=2)
    return mha_blhd_plain(q, k, v, sm_scale)
