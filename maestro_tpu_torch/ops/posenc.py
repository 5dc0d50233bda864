"""Positional and date encodings.

Reference semantics: reference maestro/layers/utils.py:103-198.

All modalities share one reference positional grid (``grid_pos_enc``); each
modality's encoding is the block-mean-pool of that grid down to its own token
grid (with a bilinear resize when the grids do not divide).  This is how
modalities at different resolutions land in one spatial coordinate frame.

Positional encodings are *static*: they are computed once per (plan, dim) in
float32 numpy at model-build time and held as module buffers — no params, no
runtime resize.  Date encodings depend on the batch and are a small tensor
function.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


def posemb_sincos_2d(h: int, w: int, dim: int, date_dim: int,
                     temperature: float = 10000.0) -> np.ndarray:
    """2-D sin/cos positional embedding with the last date_dim channels zeroed.

    Channel layout: [sin(x), cos(x), sin(y), cos(y), zeros(date_dim)], each
    frequency block of size (dim - date_dim) // 4.
    """
    if dim % 4 or date_dim % 4:
        msg = f"dim={dim} and date_dim={date_dim} must be multiples of 4."
        raise ValueError(msg)
    nfreq = (dim - date_dim) // 4
    omega = np.arange(nfreq, dtype=np.float64) / (nfreq - 1)
    omega = 1.0 / temperature**omega

    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xo = x[:, :, None] * omega[None, None, :]
    yo = y[:, :, None] * omega[None, None, :]
    pe = np.concatenate(
        [np.sin(xo), np.cos(xo), np.sin(yo), np.cos(yo), np.zeros((h, w, date_dim))],
        axis=-1,
    )
    return pe.astype(np.float32)


def pool_encoding_to_grid(encoding: np.ndarray, grid: int) -> np.ndarray:
    """Mean-pool an (H, W, C) encoding grid down to (grid*grid, C).

    When the source grid does not divide evenly it is first bilinearly resized
    to the nearest multiple (reference layers/utils.py:116-121), then
    block-mean-pooled.
    """
    h = encoding.shape[0]
    if h < grid:  # broadcast case (constant-per-sample encodings)
        encoding = np.broadcast_to(encoding, (grid, grid, encoding.shape[-1]))
        h = grid
    if h % grid:
        resize = grid * round(h / float(grid))
        encoding = _bilinear_resize_np(encoding, resize)
        h = resize
    f = h // grid
    pooled = encoding.reshape(grid, f, grid, f, -1).mean(axis=(1, 3))
    return pooled.reshape(grid * grid, -1).astype(np.float32)


def _bilinear_resize_np(x: np.ndarray, out: int) -> np.ndarray:
    """Separable bilinear (half-pixel centers) resize of (H, H, C) -> (out, out, C)."""
    h = x.shape[0]
    src = (np.arange(out) + 0.5) * (h / out) - 0.5
    lo = np.clip(np.floor(src).astype(int), 0, h - 1)
    hi = np.clip(lo + 1, 0, h - 1)
    w = np.clip(src - lo, 0.0, 1.0)

    def interp_axis0(a: np.ndarray) -> np.ndarray:
        shape = (out,) + (1,) * (a.ndim - 1)
        return a[lo] * (1 - w).reshape(shape) + a[hi] * w.reshape(shape)

    y = interp_axis0(x)
    y = interp_axis0(y.swapaxes(0, 1)).swapaxes(0, 1)
    return y


@lru_cache(maxsize=None)
def build_pos_encoding(grid_pos_enc: int, grid: int, dim: int, date_dim: int,
                       fac: float = 1.0) -> np.ndarray:
    """Static [L, dim] positional encoding for one modality (cached)."""
    shared = posemb_sincos_2d(grid_pos_enc, grid_pos_enc, dim, date_dim) * fac
    return pool_encoding_to_grid(shared, grid)


def encode_dates(
    dates: torch.Tensor,  # [B, D, 3] int (year, day-of-year, hour)
    ref_date: torch.Tensor,  # [B, 1, 3]
    dim: int,
    date_dim: int,
    fac_date_enc: float,
    num_tokens: int,
    len_bands: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Per-token date features packed into the last ``date_dim`` channels.

    Output [B, G*D, L, dim] (band-group-major date axis), with channel layout
    [zeros(dim - date_dim) | diff-years x (date_dim - 4) | sin/cos(doy) |
    sin/cos(hour)] (reference layers/utils.py:128-173).  The token axis is a
    broadcast view (stride 0): the caller's add materializes it.
    """
    dates = dates.to(torch.float32)
    ref_date = ref_date.to(torch.float32)

    year = dates[:, :, 0]
    doy = dates[:, :, 1] / 365.25
    hour = dates[:, :, 2] / 24.0
    diff = (year + doy) - (ref_date[:, :, 0] + ref_date[:, :, 1] / 365.25)

    doy = 2.0 * torch.pi * doy
    hour = 2.0 * torch.pi * hour
    feats = torch.stack(
        [diff, torch.sin(doy), torch.cos(doy), torch.sin(hour), torch.cos(hour)],
        dim=-1,
    )
    feats = feats * fac_date_enc  # [B, D, 5]

    b, d, _ = feats.shape
    zeros = feats.new_zeros((b, d, dim - date_dim))
    pad_diff = feats[:, :, :1].expand(b, d, date_dim - 4)
    enc = torch.cat([zeros, pad_diff, feats[:, :, 1:]], dim=-1)  # [B, D, dim]
    enc = enc.to(dtype)

    enc = enc[:, None].expand(b, len_bands, d, dim).reshape(b, len_bands * d, dim)
    return enc[:, :, None, :].expand(b, len_bands * d, num_tokens, dim)
