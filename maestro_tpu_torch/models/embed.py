"""Patch embedding / pixel reconstruction modules.

Reference: maestro/layers/embed.py (Patchify/Pixelify).  Convs are expressed
as block-reshape + dense matmuls (see ops/patch.py), one dense per band group,
with GroupNorm(1) over each (sample, date) token grid.
"""

from __future__ import annotations

import torch
from torch import nn

from maestro_tpu_torch.models.vit import dense, init_linear
from maestro_tpu_torch.ops.patch import patchify_pixels


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
    """Token -> pixel projection of the pretrain decoder, one dense per band
    group.  Only the parameters exist so far: the reconstruction forward
    arrives with the pretrain step."""

    def __init__(self, band_groups: tuple[int, ...], patch_size: int,
                 decoder_dim: int, generator: torch.Generator, device) -> None:
        super().__init__()
        for g, chans in enumerate(band_groups):
            proj = nn.Linear(decoder_dim, chans * patch_size**2, device=device)
            init_linear(proj, generator)
            self.add_module(f"proj{g}", proj)
