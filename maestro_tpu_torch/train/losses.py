"""Reconstruction losses of MAE pretraining.

Reconstruction loss with patch-group-wise target normalization (reference
maestro/train/model.py:195-247).  The masked mean is a sum/count formulation
over static shapes, as in the JAX package's ``train/losses.py``; it is the
pixel-space reference of ``ops/fused_loss.py`` and that module's fallback for
multi-band-group modalities.  The prediction losses of the supervised phases
arrive with their train step.
"""

from __future__ import annotations

from typing import Callable

import torch

EPS_NORM = 1.0e-6
EPS_COUNT = 1.0e-8


def loss_elem(loss_type: str) -> tuple[Callable, bool]:
    """(elementwise error, whether targets are patch-group normalized)."""
    match loss_type:
        case "l1":
            return torch.abs, False
        case "l2":
            return torch.square, False
        case "l1_norm":
            return torch.abs, True
        case "l2_norm":
            return torch.square, True
    msg = f"Invalid loss {loss_type!r}."
    raise ValueError(msg)


def patch_group_normalize(
    target: torch.Tensor,  # [B, D, C, H, W]
    patch: int,
    norm_groups: tuple[int, ...],
) -> torch.Tensor:
    """Normalize each patch per band group: zero mean, unit variance.

    Statistics are taken over (patch pixels x channels of the group) for every
    (sample, date, patch location, band group) independently.  Variance is
    UNBIASED (ddof=1), as the reference's ``target_group.var(dim=(-2,-1))``
    (model.py:228), and eps sits inside the square root.
    """
    b, d, c, hh, ww = target.shape
    g = hh // patch
    # -> [B, D, G_spatial^2, p*p, C]
    x = target.reshape(b, d, c, g, patch, g, patch)
    x = x.permute(0, 1, 3, 5, 4, 6, 2).reshape(b, d, g * g, patch * patch, c)

    parts = []
    off = 0
    for chans in norm_groups:
        grp = x[..., off : off + chans]
        off += chans
        mean = grp.mean(dim=(-2, -1), keepdim=True)
        var = grp.var(dim=(-2, -1), keepdim=True, unbiased=True)
        parts.append((grp - mean) / torch.sqrt(var + EPS_NORM))
    x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]

    x = x.reshape(b, d, g, g, patch, patch, c).permute(0, 1, 6, 2, 4, 3, 5)
    return x.reshape(b, d, c, hh, ww)


def reconstruction_loss(
    plan,
    targets: dict[str, torch.Tensor],
    pixels_rec: dict[str, torch.Tensor],
    mask_pixels: dict[str, torch.Tensor],
    loss_type: str = "l1_norm",
) -> torch.Tensor:
    """Masked reconstruction loss, weighted per modality by D * grid^2."""
    loss_fn, norm_pix = loss_elem(loss_type)

    total, weights = 0.0, 0.0
    for name, spec in plan.mod_specs.items():
        target = targets[name].float()
        if norm_pix:
            target = patch_group_normalize(target, spec.patch_size, spec.norm_groups)
        err = loss_fn(target - pixels_rec[name].float())
        m = mask_pixels[name].float()
        mod_loss = (err * m).sum() / (m.sum() + EPS_COUNT)
        weight = spec.num_dates * spec.tokens_per_date
        total = total + weight * mod_loss
        weights = weights + weight
    return total / weights
