"""Fused patch-group-norm + masked reconstruction loss.

Layout: patches are rows ``[N, F]`` with N = B*D*L tokens and F = C*p*p
features in (C, ph, pw) order, so each norm group is a contiguous column
slice.  ``masked_patchnorm_sums`` computes

    t_norm = (t - mean_g) * rsqrt(var_g + 1e-6)    per norm group g (ddof=1)
    err    = |t_norm - r|  (or squared)
    returns (sum(err * row_mask), sum(row_mask) * F)

and its gradient ``d_rec = g * (-sign(t_norm - r) or -2 (t_norm - r)) * mask``
(recomputing the normalization; targets and masks get no gradient).

``masked_patchnorm_sums_multi`` computes the sums of several modalities at
once: for CUDA tensors in one launch of ``masked_patchnorm_sums_fwd_multi``
(csrc/fused_loss.cu), whose backward launches ``masked_patchnorm_sums_bwd``
once a modality; for CPU tensors both run the plain versions below.
``masked_patchnorm_sums`` is the grouped entry with one item.  Replaces the JAX package's ``ops/fused_loss.py`` ``_fwd_kernel`` and
``_bwd_kernel``; unlike that kernel's 128-lane gate, every feature width takes
the kernel, so on the card every single-band-group modality of the four
datasets goes through it.  What bounds it, and how the kernel meets it, is
written in its source.
"""

from __future__ import annotations

import ctypes

import torch

from maestro_tpu_torch.ops.patch import patchify_pixels

EPS = 1.0e-6
MAX_SLICES = 16  # csrc/fused_loss.cu kMaxSlices
MAX_MODALITIES = 8  # csrc/fused_loss.cu kMaxMods

fwd_launch_count = 0  # once per masked_patchnorm_sums_fwd_multi launch (all modalities)
bwd_launch_count = 0  # once per masked_patchnorm_sums_bwd launch (one modality)
plain_count = 0  # calls of either plain version, on any device: a run on the card keeps it 0

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_lib = None
_scratch: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def _norm_diffs(t: torch.Tensor, r: torch.Tensor, norm_slices) -> list[torch.Tensor]:
    """``t_norm - r`` per norm-group column slice, in fp32."""
    tf, rf = t.float(), r.float()
    out = []
    for start, size in norm_slices:
        grp = tf[:, start : start + size]
        mean = grp.mean(dim=1, keepdim=True)
        var = ((grp - mean) ** 2).sum(dim=1, keepdim=True) / max(size - 1, 1)
        out.append((grp - mean) * torch.rsqrt(var + EPS) - rf[:, start : start + size])
    return out


def masked_patchnorm_sums_plain_fwd(t, r, m, norm_slices, square: bool):
    """Plain version of the forward: ``(sum_err, count)`` as fp32 scalars."""
    global plain_count
    plain_count += 1
    diffs = _norm_diffs(t, r, norm_slices)
    errs = [d * d if square else d.abs() for d in diffs]
    err = torch.cat(errs, dim=1) if len(errs) > 1 else errs[0]
    mf = m.float()
    return (err * mf).sum(), mf.sum() * t.shape[1]


def masked_patchnorm_sums_plain_bwd(t, r, m, g, norm_slices, square: bool):
    """Plain version of the backward: ``d_rec`` in r's dtype."""
    global plain_count
    plain_count += 1
    parts = [-2.0 * d if square else -torch.sign(d) for d in _norm_diffs(t, r, norm_slices)]
    d = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    return (g * d * m.float()).to(r.dtype)


def masked_patchnorm_sums_multi_plain(items, square: bool) -> torch.Tensor:
    """Plain version of the grouped forward: ``[len(items), 2]`` fp32, a row
    ``(sum_err, count)`` per ``(t, r, m, norm_slices)`` item."""
    return torch.stack([torch.stack(masked_patchnorm_sums_plain_fwd(t, r, m, sl, square))
                        for t, r, m, sl in items])


def _kernel():
    """The loss library (built with the other sources at first use)."""
    global _lib
    if _lib is None:
        from maestro_tpu_torch.ops.cuda_build import load_library

        lib = load_library("fused_loss")
        int_p = ctypes.POINTER(ctypes.c_int)
        lib.masked_patchnorm_sums_multi_scratch.restype = ctypes.c_int
        lib.masked_patchnorm_sums_multi_scratch.argtypes = []
        lib.masked_patchnorm_sums_fwd_multi.restype = ctypes.c_int
        lib.masked_patchnorm_sums_fwd_multi.argtypes = (
            [ctypes.c_int] + [ctypes.POINTER(ctypes.c_void_p)] * 3
            + [ctypes.POINTER(ctypes.c_longlong)] + [int_p] * 6
            + [ctypes.c_int] + [ctypes.c_void_p] * 4
        )
        lib.masked_patchnorm_sums_bwd.restype = ctypes.c_int
        lib.masked_patchnorm_sums_bwd.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [int_p, int_p]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        )
        _lib = lib
    return _lib


def _scratch_for(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The grouped forward's block partials and its ticket (zeroed once; the
    kernel's last block sets it back to 0), kept per device: calls on one
    device take turns on one stream."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _scratch:
        n = _kernel().masked_patchnorm_sums_multi_scratch()
        _scratch[key] = (torch.empty(n, dtype=torch.float32, device=device),
                         torch.zeros(1, dtype=torch.int32, device=device))
    return _scratch[key]


def _slice_arrays(norm_slices):
    n = len(norm_slices)
    starts = (ctypes.c_int * n)(*(int(s) for s, _ in norm_slices))
    sizes = (ctypes.c_int * n)(*(int(z) for _, z in norm_slices))
    return starts, sizes


def _check(t: torch.Tensor, r: torch.Tensor, m: torch.Tensor, norm_slices) -> None:
    if t.ndim != 2 or t.shape != r.shape:
        msg = f"t and r must share one [N, F] shape, got {tuple(t.shape)}, {tuple(r.shape)}"
        raise ValueError(msg)
    if t.dtype != r.dtype or t.dtype not in _DTYPE_CODE:
        msg = f"t and r must both be bfloat16 or both float32, got {t.dtype}, {r.dtype}"
        raise TypeError(msg)
    if m.shape != (t.shape[0], 1) or m.dtype != torch.float32:
        msg = f"m must be float32 [N, 1], got {m.dtype} {tuple(m.shape)}"
        raise ValueError(msg)
    if not (t.device == r.device == m.device) or t.device.type not in ("cpu", "cuda"):
        msg = "t, r and m must lie on one cpu or cuda device"
        raise ValueError(msg)
    # the slices tile the feature axis in order: every d_rec column is written
    ends = [0] + [s + z for s, z in norm_slices]
    if (not 1 <= len(norm_slices) <= MAX_SLICES or ends[-1] != t.shape[1]
            or any(s != e or z < 1 for (s, z), e in zip(norm_slices, ends))):
        msg = f"norm slices {norm_slices} must tile [0, {t.shape[1]}) in order"
        raise ValueError(msg)


def _fwd_multi_kernel(items, square: bool) -> torch.Tensor:
    """One launch of ``masked_patchnorm_sums_fwd_multi`` for every item."""
    global fwd_launch_count
    lib = _kernel()
    items = [(t.contiguous(), r.contiguous(), m.contiguous(), sl) for t, r, m, sl in items]
    dev = items[0][0].device
    k = len(items)
    ptrs = [(ctypes.c_void_p * k)(*(it[i].data_ptr() for it in items)) for i in range(3)]
    rows = (ctypes.c_longlong * k)(*(it[0].shape[0] for it in items))
    ints = lambda values: (ctypes.c_int * len(values))(*values)  # noqa: E731
    slices = [sl for *_, sl in items]
    offsets = [0]
    for sl in slices:
        offsets.append(offsets[-1] + len(sl))
    out = torch.empty((k, 2), dtype=torch.float32, device=dev)
    partials, ticket = _scratch_for(dev)
    with torch.cuda.device(dev):
        err = lib.masked_patchnorm_sums_fwd_multi(
            k, *ptrs, rows, ints([it[0].shape[1] for it in items]),
            ints([_DTYPE_CODE[it[0].dtype] for it in items]), ints([len(sl) for sl in slices]),
            ints(offsets[:-1]), ints([s for sl in slices for s, _ in sl]),
            ints([z for sl in slices for _, z in sl]), int(square), partials.data_ptr(),
            ticket.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        shapes = [tuple(it[0].shape) for it in items]
        msg = f"masked_patchnorm_sums_fwd_multi failed with CUDA error {err} for rows {shapes}"
        raise RuntimeError(msg)
    fwd_launch_count += 1
    return out


def _bwd_kernel(t, r, m, g, norm_slices, square: bool):
    global bwd_launch_count
    lib = _kernel()
    t, r, m = t.contiguous(), r.contiguous(), m.contiguous()
    g = g.detach().to(torch.float32).reshape(1).contiguous()
    n, f = t.shape
    dr = torch.empty_like(r)
    starts, sizes = _slice_arrays(norm_slices)
    with torch.cuda.device(t.device):
        err = lib.masked_patchnorm_sums_bwd(
            t.data_ptr(), r.data_ptr(), m.data_ptr(), g.data_ptr(), n, f, starts, sizes,
            len(norm_slices), int(square), _DTYPE_CODE[t.dtype], dr.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = f"masked_patchnorm_sums_bwd failed with CUDA error {err} for [{n}, {f}] {t.dtype}"
        raise RuntimeError(msg)
    bwd_launch_count += 1
    return dr


class _MaskedPatchnormSumsMulti(torch.autograd.Function):
    """The grouped forward over items ``(t_k, r_k, m_k)`` (passed flat) with
    their ``norm_slices``; differentiable in every r_k, one backward launch
    a modality."""

    @staticmethod
    def forward(ctx, norm_slices, square, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.norm_slices, ctx.square = norm_slices, square
        items = [(*tensors[3 * k : 3 * k + 3], sl) for k, sl in enumerate(norm_slices)]
        if tensors[0].device.type == "cpu":
            return masked_patchnorm_sums_multi_plain(items, square)
        return _fwd_multi_kernel(items, square)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = [None] * len(saved)
        for k, sl in enumerate(ctx.norm_slices):
            if not ctx.needs_input_grad[3 + 3 * k]:  # r_k (after norm_slices, square, t_k)
                continue
            t, r, m = saved[3 * k : 3 * k + 3]
            bwd = masked_patchnorm_sums_plain_bwd if t.device.type == "cpu" else _bwd_kernel
            # the count column's cotangent is dropped: the count does not depend on r
            grads[3 * k + 1] = bwd(t, r, m, g[k, 0], sl, ctx.square)
        return (None, None, *grads)


def masked_patchnorm_sums_multi(items, square: bool) -> torch.Tensor:
    """``[len(items), 2]`` fp32: ``(sum_err, count)`` with patch-group-norm
    targets for each ``(t, r, m, norm_slices)`` item (at most 8, one device),
    in one launch on the card; differentiable in every r."""
    items = [(t, r, m, tuple((int(s), int(z)) for s, z in sl)) for t, r, m, sl in items]
    if not 1 <= len(items) <= MAX_MODALITIES:
        msg = f"masked_patchnorm_sums_multi takes 1 to {MAX_MODALITIES} items, got {len(items)}"
        raise ValueError(msg)
    for t, r, m, sl in items:
        _check(t, r, m, sl)
    if len({t.device for t, *_ in items}) != 1:
        msg = "masked_patchnorm_sums_multi: every item must lie on one device"
        raise ValueError(msg)
    return _MaskedPatchnormSumsMulti.apply(
        tuple(sl for *_, sl in items), bool(square),
        *(x for t, r, m, _ in items for x in (t, r, m)))


def masked_patchnorm_sums(t, r, m, norm_slices, square: bool):
    """``(sum_err, count)`` with patch-group-norm targets; differentiable in r
    (the grouped forward with one item)."""
    out = masked_patchnorm_sums_multi([(t, r, m, norm_slices)], square)
    return out[0, 0], out[0, 1]


def fused_reconstruction_loss(plan, targets, rec, masks, loss_type: str = "l1_norm",
                              stage_dtype: torch.dtype | None = None,
                              count_reduce=None) -> torch.Tensor:
    """Drop-in for ``train.losses.reconstruction_loss`` using the fused kernel.

    Accepts per modality either a token-space reconstruction
    (``[B, D, L, C*p*p]``, token mask ``[B, D, L]`` — the model's
    ``return_pixels=False`` hot path, no pixel grid ever materialized) or the
    pixel-space form (``[B, D, C, H, W]`` + pixel mask), which is
    re-patchified here.  Requires a ``_norm`` loss variant and single-band-group
    modalities (all four reference datasets); falls back to the pixel loss per
    modality otherwise.  The kernel's modalities go through one grouped call.
    ``stage_dtype`` (default bf16 on the card, fp32 on the
    CPU, as the JAX package picks bf16 for its accelerator) is the dtype of the
    patchified staging rows — normalization statistics are always fp32.
    ``count_reduce`` turns a data-parallel rank's counts into the global
    batch's (``train.losses``).
    """
    from maestro_tpu_torch.train.losses import (
        EPS_COUNT,
        loss_elem,
        patch_group_normalize,
        reconstruction_loss,
    )

    if not loss_type.endswith("_norm"):
        return reconstruction_loss(plan, targets, rec, masks, loss_type, count_reduce)
    if count_reduce is None:
        count_reduce = lambda c: c  # noqa: E731
    square = loss_type.startswith("l2")
    if stage_dtype is None:
        on_card = next(iter(targets.values())).device.type == "cuda"
        stage_dtype = torch.bfloat16 if on_card else torch.float32

    items, fallback = {}, {}
    for name, spec in plan.mod_specs.items():
        p = spec.patch_size
        if spec.len_bands != 1:  # pixel-space fallback for this modality
            loss_fn, _ = loss_elem(loss_type)
            target = patch_group_normalize(targets[name].float(), p, spec.norm_groups)
            err = loss_fn(target - rec[name].float())
            m = masks[name].float()
            fallback[name] = (err * m).sum() / (count_reduce(m.sum()) + EPS_COUNT)
            continue

        t = patchify_pixels(targets[name].to(stage_dtype), p)
        b, d, l, f = t.shape
        t = t.reshape(b * d * l, f)
        if rec[name].ndim == 4:  # token-space reconstruction
            r = rec[name].to(stage_dtype).reshape(b * d * l, f)
            m = masks[name].reshape(b * d * l, 1)
        else:
            r = patchify_pixels(rec[name].to(stage_dtype), p).reshape(b * d * l, f)
            # one band group -> pixel mask constant over the patch
            m = masks[name][:, :, 0, ::p, ::p].reshape(b * d * l, 1)

        # column slices per norm group in (C, ph, pw) feature order
        slices, off = [], 0
        for chans in spec.norm_groups:
            slices.append((off * p * p, chans * p * p))
            off += chans
        items[name] = (t, r, m.float(), tuple(slices))

    # every kernel modality in one launch (a launch per 8)
    names = list(items)
    sums = {}
    for i in range(0, len(names), MAX_MODALITIES):
        group = names[i : i + MAX_MODALITIES]
        out = masked_patchnorm_sums_multi([items[n] for n in group], square)
        sums.update((n, out[j]) for j, n in enumerate(group))

    total, weights = 0.0, 0.0
    for name, spec in plan.mod_specs.items():
        weight = spec.num_dates * spec.tokens_per_date
        weights = weights + weight
        if name in fallback:
            total = total + weight * fallback[name]
        else:
            count = count_reduce(sums[name][1])
            total = total + weight * sums[name][0] / torch.clamp(count, min=1e-8)
    return total / weights
