"""Downstream heads (classification / dense segmentation).

Reference: maestro/layers/head.py:66-130.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from maestro_tpu_torch.models.vit import AttentiveReduce, dense, init_linear


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

    def _chunk(self, row0: int, xs: tuple[torch.Tensor, ...]) -> torch.Tensor:
        """One ref-grid row chunk: resize-slice + concat + reduce + proj."""
        rows = self.chunk_rows
        parts = []
        for i, (x, g) in enumerate(zip(xs, self.mod_grids)):
            a_full = getattr(self, f"resize{i}").to(x.dtype)
            b, dg, _, e = x.shape
            part = torch.einsum(
                "rg,bdghe,sh->bdrse", a_full[row0 : row0 + rows],
                x.reshape(b, dg, g, g, e), a_full,
            )
            parts.append(part.reshape(b, dg, -1, e))
        x_ref = torch.cat(parts, dim=1)  # [B, DG_tot, r*G, E]
        b = x_ref.shape[0]
        if self.type_head == "attentive":
            y = self.reduce(x_ref)  # [B, r*G, dim]
        else:
            y = x_ref.mean(dim=1)
        y = dense(y, self.proj, self.dtype)  # [B, r*G, K*p^2]
        # pixel shuffle inside the chunk, feature order (C, ph, pw)
        g, p, k = self.ref_grid, self.patch_size, self.num_classes
        y = y.reshape(b, rows, g, k, p, p).permute(0, 3, 1, 4, 2, 5)
        return y.reshape(b, k, rows * p, g * p)

    def forward(self, xs: tuple[torch.Tensor, ...]) -> torch.Tensor:
        chunks = [
            self._chunk(row0, xs)
            for row0 in range(0, self.ref_grid, self.chunk_rows)
        ]
        pixels = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=2)
        return pixels[:, None]  # [B, 1, K, H, W]
