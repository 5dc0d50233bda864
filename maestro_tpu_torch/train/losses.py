"""Losses of the three phases.

Reconstruction loss with patch-group-wise target normalization (reference
maestro/train/model.py:195-247).  The masked mean is a sum/count formulation
over static shapes, as in the JAX package's ``train/losses.py``; it is the
pixel-space reference of ``ops/fused_loss.py`` and that module's fallback for
multi-band-group modalities.  ``prediction_losses`` are the probe / finetune
losses (reference base.py:120-150): per-pixel cross-entropy for segmentation,
binary cross-entropy for multilabel and cross-entropy for single-label
classification, rows whose label is ``missing_val`` masked out.

Every loss is a ratio of batch sums.  Under data parallelism a rank holds
part of the batch, and the loss of the global batch is the sum over ranks of
each rank's sum over the GLOBAL count: ``count_reduce`` (where given) turns a
rank's count into the global one (``parallel.mesh.Parallel.count_reduce``).
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
    count_reduce: Callable | None = None,
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
        count = m.sum() if count_reduce is None else count_reduce(m.sum())
        mod_loss = (err * m).sum() / (count + EPS_COUNT)
        weight = spec.num_dates * spec.tokens_per_date
        total = total + weight * mod_loss
        weights = weights + weight
    return total / weights


def _masked_mean(per_row: torch.Tensor, valid: torch.Tensor,
                 logits: torch.Tensor, count_reduce: Callable | None = None) -> torch.Tensor:
    """Mean of ``per_row`` over the valid rows; ``0 * logits.mean()`` when no
    row is valid, so the gradient stays defined (reference base.py:147-148).
    No host sync: both branches are computed and selected on the device."""
    count = valid.sum() if count_reduce is None else count_reduce(valid.sum())
    mean = (per_row * valid).sum() / count.clamp(min=1)
    return torch.where(count > 0, mean, 0.0 * logits.mean())


def prediction_losses(
    head_specs,
    batch: dict[str, torch.Tensor],
    logits: dict[str, torch.Tensor],
    count_reduce: Callable | None = None,
) -> tuple[torch.Tensor, dict[str, dict[str, torch.Tensor]]]:
    """Sum of the per-target losses, and per target what the metrics read:
    ``preds`` (segment: argmax over the class axis), or ``logits``, with
    ``labels`` and the ``valid`` row mask.  Losses are taken in fp32."""
    total = 0.0
    aux: dict[str, dict[str, torch.Tensor]] = {}
    for hs in head_specs:
        lg = logits[hs.name].float()
        y = batch[hs.name]
        if hs.type_target == "segment":
            lgc = lg[:, 0]  # [B, C, H, W]
            y2 = y[:, 0, 0].long()  # [B, H, W]
            y_safe = y2.clamp(0, hs.num_classes - 1)
            lse = torch.logsumexp(lgc, dim=1)
            picked = lgc.gather(1, y_safe[:, None])[:, 0]
            ce = (lse - picked).reshape(-1)
            valid = (y2 != hs.missing_val).reshape(-1)
            loss = _masked_mean(ce, valid, lg, count_reduce)
            aux[hs.name] = {"preds": lgc.argmax(dim=1).reshape(-1),
                            "labels": y2.reshape(-1), "valid": valid}
        elif hs.type_target == "multilabel_classif":
            yf = y.float()
            valid = (y != hs.missing_val).all(dim=1)
            bce = lg.clamp(min=0) - lg * yf + torch.log1p(torch.exp(-lg.abs()))
            loss = _masked_mean(bce.mean(dim=1), valid, lg, count_reduce)
            aux[hs.name] = {"logits": lg, "labels": y, "valid": valid}
        else:  # classif
            y1 = y.reshape(-1).long()
            valid = y1 != hs.missing_val
            y_safe = y1.clamp(0, hs.num_classes - 1)
            ce = -torch.log_softmax(lg, dim=-1).gather(1, y_safe[:, None])[:, 0]
            loss = _masked_mean(ce, valid, lg, count_reduce)
            aux[hs.name] = {"logits": lg, "labels": y1, "valid": valid}
        total = total + loss
    return total, aux
