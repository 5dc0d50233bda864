"""Structured + random token masking of MAE pretraining.

Reference semantics: maestro/ssl/mae.py:178-287; the JAX package's
``ops/masking.py``.

  1. ``structural_mask`` — per-sample Bernoulli masking at modality /
     band-group / date / location granularity, OR-combined, redrawn per
     (sample, stream) while any stream would be masked entirely (at most
     1000 redraws, one host sync per redraw to test the condition).
  2. ``shuffle_mask`` — MAE random masking biased by the structural mask
     (structurally-masked tokens get noise 0, sort first and are masked
     preferentially); the masked count per stream is a static int.  The sort
     is stable, as ``jnp.argsort`` is, so which of the tied structurally
     masked tokens get masked matches the JAX package for the same noise.
  3. ``unmask`` — re-expansion of encoded tokens to the full sequence by a
     cumulative-rank gather, filling masked slots with the mask token.

``draw_masks`` draws everything random a pretrain forward needs from one
``torch.Generator``; it is the single place the random bits come from.  On a
CPU generator (the train step's) the redraw test reads host memory, and
``to_device`` hands the draws to the card without waiting for it.
"""

from __future__ import annotations

import torch

from maestro_tpu_torch.specs.fusion import FusionPlan

MAX_REDRAWS = 1000


def _draw_struct(plan: FusionPlan, generator: torch.Generator,
                 batch_size: int) -> dict[str, torch.Tensor]:
    device = generator.device
    masks_mod = {}
    for name in plan.mods:
        spec = plan.mod_specs[name]
        sm = plan.struct_masks[name]
        b, g, d, l = batch_size, spec.len_bands, spec.num_dates, spec.tokens_per_date
        m = torch.zeros((b, g, d, l), dtype=torch.bool, device=device)
        for p, shape in ((sm.p_mod, (b, 1, 1, 1)), (sm.p_bands, (b, g, 1, 1)),
                         (sm.p_dates, (b, 1, d, 1)), (sm.p_loc, (b, 1, 1, l))):
            if p:
                m = m | (torch.rand(shape, generator=generator, device=device) < p)
        masks_mod[name] = m.reshape(b, g * d, l)
    return plan.group(masks_mod)


def structural_mask(plan: FusionPlan, generator: torch.Generator,
                    batch_size: int) -> dict[str, torch.Tensor]:
    """The structural mask: dict[stream] -> ``[B, L_stream]`` bool.

    For batch-flattened fusion modes structural masking is disabled and the
    mask is all-False (batch axis ``B * date_axis`` per stream).
    """
    device = generator.device
    if plan.batch_flattened or not any(plan.struct_masks[m].enabled for m in plan.mods):
        return {
            name: torch.zeros((batch_size * s.batch_factor, s.seq_len), dtype=torch.bool,
                              device=device)
            for name, s in plan.streams.items()
        }
    masks = {
        name: torch.ones((batch_size, s.seq_len), dtype=torch.bool, device=device)
        for name, s in plan.streams.items()
    }
    for _ in range(MAX_REDRAWS):
        full = {name: m.all(dim=1, keepdim=True) for name, m in masks.items()}
        if not torch.cat(list(full.values())).any().item():
            break
        fresh = _draw_struct(plan, generator, batch_size)
        masks = {name: torch.where(full[name], fresh[name], m) for name, m in masks.items()}
    return masks


def draw_masks(plan: FusionPlan, generator: torch.Generator,
               batch_size: int) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(structural masks, shuffle noise): dict[stream] -> ``[B', L]`` bool and
    fp32 uniform [0, 1) noise, drawn on ``generator``'s device."""
    struct = structural_mask(plan, generator, batch_size)
    noise = {
        name: torch.rand((batch_size * s.batch_factor, s.seq_len), generator=generator,
                         device=generator.device)
        for name, s in plan.streams.items()
    }
    return struct, noise


def local_rows(plan: FusionPlan, draws: dict[str, torch.Tensor], offset: int,
               size: int) -> dict[str, torch.Tensor]:
    """Samples ``offset .. offset + size`` of draws made for a larger batch
    (a data-parallel rank's rows of the global batch's masks; a stream
    flattened into the batch holds ``batch_factor`` rows a sample)."""
    out = {}
    for name, t in draws.items():
        f = plan.streams[name].batch_factor
        out[name] = t[offset * f : (offset + size) * f]
    return out


def to_device(masks: dict[str, torch.Tensor], device: torch.device) -> dict[str, torch.Tensor]:
    """``masks`` on ``device``; host tensors go to a CUDA device through
    pinned memory, so the copy does not wait for the work queued before it."""
    out = {}
    for name, m in masks.items():
        if m.device.type == "cpu" and device.type == "cuda":
            m = m.pin_memory()
        out[name] = m.to(device, non_blocking=True)
    return out


def shuffle_mask(
    x: torch.Tensor,  # [B, L, C]
    struct: torch.Tensor,  # [B, L] bool structural mask (bias)
    noise: torch.Tensor,  # [B, L] uniform [0, 1)
    num_masked: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Biased MAE shuffle masking for one stream.

    Returns (x_kept [B, L-k, C], mask_rec [B, L] bool, ids_keep [B, L-k]).
    """
    b, l, c = x.shape
    noise = noise * (1.0 - struct.to(noise.dtype))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)  # masked candidates first
    rank = torch.empty_like(ids_shuffle).scatter_(
        1, ids_shuffle, torch.arange(l, device=x.device).expand(b, l),
    )
    mask_rec = rank < num_masked
    ids_keep = torch.sort(ids_shuffle[:, num_masked:], dim=1).values
    x_kept = torch.gather(x, 1, ids_keep[..., None].expand(b, l - num_masked, c))
    return x_kept, mask_rec, ids_keep


def unmask(
    x_enc: torch.Tensor,  # [B, L_enc, C] encoded (kept) tokens, original order
    mask_token_full: torch.Tensor,  # [B, L, C] per-position mask token
    mask_rec: torch.Tensor,  # [B, L] bool
) -> torch.Tensor:
    """Re-expand to the full sequence, filling masked slots with mask tokens.

    Position i (unmasked) fetches encoded row ``cumsum(~mask)[i] - 1``;
    masked positions read a zero row and take the mask token.
    """
    keep_rank = torch.cumsum(~mask_rec, dim=1) - 1
    idx = torch.where(mask_rec, x_enc.shape[1], keep_rank)
    x_pad = torch.cat([x_enc, torch.zeros_like(x_enc[:, :1])], dim=1)
    x_full = torch.gather(x_pad, 1, idx[..., None].expand(-1, -1, x_enc.shape[2]))
    return torch.where(mask_rec[..., None], mask_token_full.to(x_full.dtype), x_full)
