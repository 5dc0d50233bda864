"""Downstream heads (classification / dense segmentation).

Reference: maestro/layers/head.py:66-130.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from maestro_tpu_torch.models.vit import LN_EPS, AttentiveReduce, dense, init_linear, layer_norm
from maestro_tpu_torch.ops.attn_pool import attentive_pool_bwd, attentive_pool_forward

# the pool's forward and backward as a recomputed chunk calls them (a caller may
# point them at the plain versions)
pool_forward = attentive_pool_forward
pool_backward = attentive_pool_bwd


def resize_matrix(in_grid: int, out_grid: int) -> np.ndarray:
    """[out, in] float32 matrix form of bilinear 1-D interpolation.

    Linear resize is separable and linear, so the 2-D grid resize equals
    ``A @ X @ A.T`` — which lets a row slice of the output be computed
    without materializing the full resized grid (A[rows] @ X @ A.T).
    Half-pixel centers, edge taps clamped, no antialias prefilter — also when
    a modality grid DOWNsamples to the ref grid (e.g. PASTIS spot 10 -> s2 8),
    as the reference's F.interpolate (mim.py:362-366).
    """
    src = (np.arange(out_grid, dtype=np.float64) + 0.5) * (in_grid / out_grid) - 0.5
    lo = np.floor(src)
    w_hi = src - lo
    mat = np.zeros((out_grid, in_grid), np.float64)
    rows = np.arange(out_grid)
    np.add.at(mat, (rows, np.clip(lo, 0, in_grid - 1).astype(int)), 1.0 - w_hi)
    np.add.at(mat, (rows, np.clip(lo + 1, 0, in_grid - 1).astype(int)), w_hi)
    return mat.astype(np.float32)


class ClassificationHead(nn.Module):
    """[B, N, C] -> [B, num_classes] via mean or attentive pooling."""

    def __init__(self, type_head: str, dim: int, num_classes: int,
                 dtype: torch.dtype, generator: torch.Generator, device,
                 heads: int = 8) -> None:
        super().__init__()
        self.type_head = type_head
        if type_head == "attentive":
            self.reduce = AttentiveReduce(dim, heads, dtype, generator, device)
        self.linear = nn.Linear(dim, num_classes, device=device)
        init_linear(self.linear, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.type_head == "attentive":
            pooled = self.reduce(x)
        else:
            pooled = x.mean(dim=1)
        # the classifier runs in fp32 on fp32 input
        return dense(pooled, self.linear, torch.float32)


class ChunkedSegHead(nn.Module):
    """Segmentation head over per-modality token grids, chunked by ref rows.

    Functionally ``PixelifyHead(concat_mods(resize_to_ref_grid(x)))`` — the
    reference's segmentation path (mim.py:343-394 + head.py:96-130) — but the
    [B, sum(dates), ref_grid^2, E] date-stacked tensor is never materialized:
    the bilinear resize is applied in matrix form per row-chunk of the ref
    grid and the (per-position independent) date reduction + projection run
    in a loop over chunks.  Parameter tree: "reduce", "proj".
    """

    def __init__(self, type_head: str, dim: int, num_classes: int,
                 patch_size: int, ref_grid: int, mod_grids: tuple[int, ...],
                 dtype: torch.dtype, generator: torch.Generator, device,
                 heads: int = 8, chunk_rows: int = 2) -> None:
        super().__init__()
        if chunk_rows < 1:
            msg = f"chunk_rows must be >= 1, got {chunk_rows}"
            raise ValueError(msg)
        self.type_head, self.num_classes, self.patch_size = type_head, num_classes, patch_size
        self.ref_grid, self.mod_grids, self.dtype = ref_grid, tuple(mod_grids), dtype
        # a chunk size that does not divide the grid falls back to single rows
        self.chunk_rows = chunk_rows if ref_grid % chunk_rows == 0 else 1
        if type_head == "attentive":
            self.reduce = AttentiveReduce(dim, heads, dtype, generator, device)
        # proj runs in the compute dtype; fp32 params
        self.proj = nn.Linear(dim, num_classes * patch_size**2, device=device)
        init_linear(self.proj, generator)
        for i, g in enumerate(self.mod_grids):
            self.register_buffer(
                f"resize{i}",
                torch.from_numpy(resize_matrix(g, ref_grid)).to(device),
                persistent=False,
            )

    def _x_ref(self, row0: int, xs: tuple[torch.Tensor, ...]) -> torch.Tensor:
        """The chunk's date-stacked grid ``[B, DG_tot, r*G, E]``: each
        modality's grid resized to the chunk's ref rows, concatenated."""
        rows = self.chunk_rows
        parts = []
        for i, (x, g) in enumerate(zip(xs, self.mod_grids)):
            a_full = getattr(self, f"resize{i}").to(x.dtype)
            b, dg, _, e = x.shape
            # the chunk's rows first, then the columns: two-operand products
            # in a fixed order (a three-operand einsum asks opt_einsum for an
            # order, which fixes the batch size under torch.export)
            part = torch.einsum("rg,bdghe->bdrhe", a_full[row0 : row0 + rows],
                                x.reshape(b, dg, g, g, e))
            part = torch.einsum("bdrhe,sh->bdrse", part, a_full)
            parts.append(part.reshape(b, dg, -1, e))
        return torch.cat(parts, dim=1)

    def _pixels(self, y: torch.Tensor) -> torch.Tensor:
        """proj + the pixel shuffle inside the chunk, feature order (C, ph, pw)."""
        b = y.shape[0]
        y = dense(y, self.proj, self.dtype)  # [B, r*G, K*p^2]
        g, p, k, rows = self.ref_grid, self.patch_size, self.num_classes, self.chunk_rows
        y = y.reshape(b, rows, g, k, p, p).permute(0, 3, 1, 4, 2, 5)
        return y.reshape(b, k, rows * p, g * p)

    def _chunk(self, row0: int, w_kv, w16, *xs: torch.Tensor) -> torch.Tensor:
        """One ref-grid row chunk: resize-slice + concat + reduce + proj
        (``w_kv`` / ``w16``: the pool's whole weight and its bf16 copy)."""
        x_ref = self._x_ref(row0, xs)
        if self.type_head != "attentive":
            return self._pixels(x_ref.mean(dim=1))
        return self._pixels(self.reduce(x_ref, w_kv, w16))

    def _fused_pool_shape(self, xs) -> bool:
        b, e = xs[0].shape[0], xs[0].shape[-1]
        shape = (b, sum(x.shape[1] for x in xs), self.chunk_rows * self.ref_grid, e)
        return (self.type_head == "attentive"
                and self.reduce._use_fused_pool(torch.empty(shape, device="meta")))

    def _chunk_recomputed(self, row0: int, xs: tuple[torch.Tensor, ...], w_kv,
                          w16) -> torch.Tensor:
        """``_chunk`` with its activations recomputed in the backward, as the
        JAX package remats each chunk keeping only the fused pool's residuals
        (out, m, den): the backward replays the resize that rebuilds the
        chunk's grid, never the pool's forward.  Without the fused pool the
        whole chunk is recomputed."""
        if not self._fused_pool_shape(xs):
            return checkpoint(self._chunk, row0, w_kv, w16, *xs, use_reentrant=False,
                              preserve_rng_state=False)
        red = self.reduce
        out = _RecomputedChunkPool.apply(
            lambda parts: self._x_ref(row0, parts).to(red.dtype), red.heads, len(xs),
            w16, *xs, red.norm.weight, red.norm.bias, w_kv, red.query)
        return self._pixels(layer_norm(out, red.norm_fc, red.dtype))

    def forward(self, xs: tuple[torch.Tensor, ...]) -> torch.Tensor:
        # the pool's weight whole (gathered under tensor parallelism) and its
        # bf16 copy for the fused pool, taken once for all the chunks
        w_kv = w16 = None
        if self.type_head == "attentive":
            w_kv = self.reduce.kv_weight()
            if self._fused_pool_shape(xs):
                w16 = self.reduce.kv_weight_bf16(xs[0], w_kv)
        # several chunks under autograd: each recomputed in the backward (the
        # reference's remat-scan), so no chunk's grid outlives its forward
        recompute = torch.is_grad_enabled() and self.ref_grid // self.chunk_rows > 1
        chunks = [
            self._chunk_recomputed(row0, xs, w_kv, w16) if recompute
            else self._chunk(row0, w_kv, w16, *xs)
            for row0 in range(0, self.ref_grid, self.chunk_rows)
        ]
        pixels = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=2)
        return pixels[:, None]  # [B, 1, K, H, W]


class _RecomputedChunkPool(torch.autograd.Function):
    """The date pool of one chunk, ``pool(build(xs)) -> out``, saving only xs
    (the trunk's grids, alive anyway), the pool's parameters and its
    ``(out, m, den)``; the backward rebuilds the chunk's grid from xs and
    runs the pool's backward on it."""

    @staticmethod
    def forward(ctx, build, heads, n_x, w16, *inputs):
        xs, params = inputs[:n_x], inputs[n_x:]
        x_ref = build(xs)
        out, m, den = pool_forward(x_ref, *params, heads, LN_EPS, w_kv_bf16=w16)
        ctx.save_for_backward(*xs, *params, out, m, den)
        ctx.build, ctx.heads, ctx.n_x, ctx.w16 = build, heads, n_x, w16
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        n_x = ctx.n_x
        xs, (ln_scale, ln_bias, w_kv, query), (out, m, den) = (
            saved[:n_x], saved[n_x : n_x + 4], saved[n_x + 4 :])
        need_dx = any(ctx.needs_input_grad[4 : 4 + n_x])
        with torch.enable_grad() if need_dx else torch.no_grad():
            xs_d = [x.detach().requires_grad_(need_dx) for x in xs]
            x_ref = ctx.build(xs_d)
        dx, d_scale, d_bias, d_w, d_query = pool_backward(
            x_ref.detach(), ln_scale, ln_bias, w_kv if ctx.w16 is None else ctx.w16, query,
            out, m, den, g, ctx.heads, LN_EPS, need_dx=need_dx)
        d_xs = torch.autograd.grad(x_ref, xs_d, dx) if need_dx else (None,) * n_x
        return (None, None, None, None, *d_xs, d_scale.to(ln_scale.dtype),
                d_bias.to(ln_bias.dtype), d_w.to(w_kv.dtype), d_query.to(query.dtype))
