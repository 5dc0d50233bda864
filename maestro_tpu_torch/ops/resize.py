"""Image resize helpers with ``F.interpolate`` semantics.

The reference resizes with ``F.interpolate`` (mim.py:428, baselines/base.py:
208); the JAX package reproduces its three modes exactly (``nearest`` with the
legacy asymmetric mapping ``src = floor(dst * in/out)``; ``bilinear`` with
half-pixel centers and no antialias prefilter, also on downsample; ``bicubic``
with the Keys kernel at A = -0.75 as a separable matrix), so ``nearest`` and
``bilinear`` are direct calls here and ``bicubic`` keeps the matrix form
(``bicubic_matrix_np``, which the tests pin against both).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def bicubic_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] 1-D torch-bicubic weights (A=-0.75, half-pixel centers,
    border-replicated, no antialias) — ``F.interpolate(mode="bicubic",
    align_corners=False)`` exactly."""
    A = -0.75

    def w(x: float) -> float:
        x = abs(x)
        if x <= 1:
            return (A + 2) * x**3 - (A + 3) * x**2 + 1
        if x < 2:
            return A * x**3 - 5 * A * x**2 + 8 * A * x - 4 * A
        return 0.0

    scale = in_size / out_size
    mat = np.zeros((out_size, in_size), np.float32)
    for o in range(out_size):
        src = (o + 0.5) * scale - 0.5
        base = int(np.floor(src))
        for tap in range(-1, 3):
            idx = min(max(base + tap, 0), in_size - 1)
            mat[o, idx] += w(src - (base + tap))
    return mat


_BICUBIC: dict[tuple[int, int, torch.device], torch.Tensor] = {}


def bicubic_matrix(in_size: int, out_size: int, device) -> torch.Tensor:
    """``bicubic_matrix_np`` as an fp32 tensor on ``device``, made once per
    (sizes, device): a copy from pageable host memory waits for the device."""
    key = (in_size, out_size, torch.device(device))
    if key not in _BICUBIC:
        _BICUBIC[key] = torch.from_numpy(bicubic_matrix_np(in_size, out_size)).to(device)
    return _BICUBIC[key]


def _resize_hw(x: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """Resize trailing (H, W) dims of [..., H, W] for one mode."""
    if mode in ("bicubic", "cubic"):
        a_r = bicubic_matrix(x.shape[-2], size, x.device)
        a_c = bicubic_matrix(x.shape[-1], size, x.device)
        # two products in a fixed order (a three-operand einsum asks
        # opt_einsum for an order, which fixes the batch size under torch.export)
        y = torch.matmul(torch.matmul(a_r, x.float()), a_c.T)
        return y.to(x.dtype)
    lead = x.shape[:-2]
    flat = x.reshape(1, -1, x.shape[-2], x.shape[-1])
    if mode == "nearest":
        out = F.interpolate(flat, size=(size, size), mode="nearest")
    elif mode in ("bilinear", "linear"):
        out = F.interpolate(
            flat, size=(size, size), mode="bilinear", align_corners=False,
            antialias=False,
        )
    else:
        msg = f"unknown interpolate mode {mode!r}"
        raise ValueError(msg)
    return out.reshape(*lead, size, size)


def resize_spatial(x: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """Resize the trailing two (H, W) dims of [..., H, W] to (size, size)."""
    if x.shape[-1] == size and x.shape[-2] == size:
        return x
    return _resize_hw(x, size, mode)


def resize_token_grid(x: torch.Tensor, out_grid: int, mode: str = "bilinear") -> torch.Tensor:
    """Resize token features [B, D, L, C] (L = g*g) to a new grid -> [B, D, L', C]."""
    b, d, l, c = x.shape
    g = round(l**0.5)
    if g == out_grid:
        return x
    xg = x.reshape(b, d, g, g, c).permute(0, 1, 4, 2, 3)  # [..., H, W]
    xg = _resize_hw(xg, out_grid, mode)
    return xg.permute(0, 1, 3, 4, 2).reshape(b, d, out_grid * out_grid, c)
