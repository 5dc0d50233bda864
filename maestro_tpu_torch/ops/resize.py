"""Image resize helpers with ``F.interpolate`` semantics.

The reference resizes with ``F.interpolate`` (mim.py:428); the JAX package
reproduces two of its modes exactly (``nearest`` with the legacy asymmetric
mapping ``src = floor(dst * in/out)``; ``bilinear`` with half-pixel centers
and no antialias prefilter, also on downsample), so here both are direct
calls.  The bicubic matrix form arrives with the baseline adapters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _resize_hw(x: torch.Tensor, size: int, mode: str) -> torch.Tensor:
    """Resize trailing (H, W) dims of [..., H, W] for one mode."""
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
