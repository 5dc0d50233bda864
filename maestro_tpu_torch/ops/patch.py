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
