"""Patchify / pixelify as reshape + matmul.

The reference implements patch embedding as strided Conv2d + GroupNorm(1)
(reference maestro/layers/embed.py:37-66) and pixel reconstruction as a 1x1
conv + pixel shuffle (:123-160).  A stride-p conv with kernel p is exactly a
block reshape followed by a dense matmul; feature order (C, ph, pw) matches
the conv-kernel layout for checkpoint porting.
"""

from __future__ import annotations

import torch


def patchify_pixels(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, D, C, H, W] -> [B, D, L, C*p*p] with feature order (C, ph, pw)."""
    b, d, c, hh, ww = x.shape
    h, w = hh // patch, ww // patch
    x = x.reshape(b, d, c, h, patch, w, patch)
    x = x.permute(0, 1, 3, 5, 2, 4, 6)  # [B, D, h, w, C, p, p]
    return x.reshape(b, d, h * w, c * patch * patch)


def unpatchify_pixels(x: torch.Tensor, patch: int, channels: int) -> torch.Tensor:
    """[B, D, L, C*p*p] (feature order (C, ph, pw)) -> [B, D, C, H, W].

    Exact inverse of :func:`patchify_pixels`.
    """
    b, d, l, _ = x.shape
    h = round(l**0.5)
    x = x.reshape(b, d, h, h, channels, patch, patch)
    x = x.permute(0, 1, 4, 2, 5, 3, 6)  # [B, D, C, h, p, w, p]
    return x.reshape(b, d, channels, h * patch, h * patch)


def group_norm_tokens(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm(1) over token layout: normalize over (L, C) per (B, D) slice.

    Equivalent to torch GroupNorm(1, C) on the [B*D, C, h, w] activation map
    (normalizes jointly over channels and spatial dims), with per-channel
    affine.
    """
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, unbiased=False)
    x = (x - mean) * torch.rsqrt(var + eps)
    return x * scale + bias


def expand_token_mask_to_pixels(
    mask: torch.Tensor,  # [B, D, L] or [B, D, L, 1] bool token mask (one group)
    patch: int,
    channels: int,
) -> torch.Tensor:
    """Expand a per-token mask to the pixel grid: -> [B, D, C, H, W]."""
    if mask.ndim == 4:
        mask = mask[..., 0]
    b, d, l = mask.shape
    h = round(l**0.5)
    m = mask.reshape(b, d, 1, h, 1, h, 1)
    m = m.expand(b, d, channels, h, patch, h, patch)
    return m.reshape(b, d, channels, h * patch, h * patch)
