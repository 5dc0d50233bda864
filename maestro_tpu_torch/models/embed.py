"""Patch embedding / pixel reconstruction modules.

Reference: maestro/layers/embed.py (Patchify/Pixelify).  Convs are expressed
as block-reshape + dense matmuls (see ops/patch.py), one dense per band group,
with GroupNorm(1) over each (sample, date) token grid.
"""

from __future__ import annotations

import torch
from torch import nn

from maestro_tpu_torch.models.vit import dense, init_linear
from maestro_tpu_torch.ops.patch import (
    expand_token_mask_to_pixels,
    patchify_pixels,
    unpatchify_pixels,
)


class PatchEmbed(nn.Module):
    """[B, D, C, H, W] -> [B, G*D, L, E] tokens (band-group-major date axis)."""

    def __init__(self, band_groups: tuple[int, ...], patch_size: int,
                 embed_dim: int, dtype: torch.dtype,
                 generator: torch.Generator, device) -> None:
        super().__init__()
        self.band_groups, self.patch_size, self.dtype = band_groups, patch_size, dtype
        for g, chans in enumerate(band_groups):
            proj = nn.Linear(chans * patch_size**2, embed_dim, device=device)
            init_linear(proj, generator)
            self.add_module(f"proj{g}", proj)
            self.register_parameter(
                f"norm{g}_scale", nn.Parameter(torch.ones(embed_dim, device=device)),
            )
            self.register_parameter(
                f"norm{g}_bias", nn.Parameter(torch.zeros(embed_dim, device=device)),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        offset = 0
        for g, chans in enumerate(self.band_groups):
            xg = x[:, :, offset : offset + chans]
            offset += chans
            tokens = patchify_pixels(xg.to(self.dtype), self.patch_size)
            tokens = dense(tokens, getattr(self, f"proj{g}"), self.dtype)
            # GroupNorm(1): normalize over (L, E) per (b, d) with fp32
            # statistics, per-channel affine in the compute dtype
            stats = tokens.float()
            mean = stats.mean(dim=(-2, -1), keepdim=True)
            var = stats.var(dim=(-2, -1), keepdim=True, unbiased=False)
            tokens = ((stats - mean) * torch.rsqrt(var + 1e-5)).to(self.dtype)
            scale = getattr(self, f"norm{g}_scale").to(self.dtype)
            bias = getattr(self, f"norm{g}_bias").to(self.dtype)
            outs.append(tokens * scale + bias)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


class Pixelify(nn.Module):
    """[B, G*D, L, C_dec] -> pixels [B, D, C, H, W] (+ pixel mask expansion),
    one dense per band group."""

    def __init__(self, band_groups: tuple[int, ...], patch_size: int,
                 decoder_dim: int, dtype: torch.dtype,
                 generator: torch.Generator, device) -> None:
        super().__init__()
        self.band_groups, self.patch_size, self.dtype = band_groups, patch_size, dtype
        for g, chans in enumerate(band_groups):
            proj = nn.Linear(decoder_dim, chans * patch_size**2, device=device)
            init_linear(proj, generator)
            self.add_module(f"proj{g}", proj)

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor | None = None,  # [B, G*D, L] bool token mask
        tokens_only: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        num_groups = len(self.band_groups)
        b, gd, l, _ = x.shape
        d = gd // num_groups
        x = x.reshape(b, num_groups, d, l, x.shape[-1])
        if mask is not None:
            mask = mask.reshape(b, num_groups, d, l)

        if tokens_only:
            # token-space reconstruction [B, D, L, C*p*p] in (C, ph, pw)
            # feature order + per-token mask; skips the pixel shuffle so the
            # loss never materializes / re-patchifies the full pixel grid
            if num_groups != 1:
                msg = "tokens_only requires a single band group."
                raise ValueError(msg)
            y = dense(x[:, 0], self.proj0, self.dtype)
            return y, (mask[:, 0] if mask is not None else None)

        pix, pix_mask = [], []
        for g, chans in enumerate(self.band_groups):
            y = dense(x[:, g], getattr(self, f"proj{g}"), self.dtype)
            pix.append(unpatchify_pixels(y, self.patch_size, chans))
            if mask is not None:
                pix_mask.append(expand_token_mask_to_pixels(mask[:, g], self.patch_size, chans))
        pixels = pix[0] if num_groups == 1 else torch.cat(pix, dim=2)
        if mask is None:
            return pixels, None
        return pixels, pix_mask[0] if num_groups == 1 else torch.cat(pix_mask, dim=2)
