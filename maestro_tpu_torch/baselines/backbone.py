"""Generic ViT backbone for the baseline foundation-model adapters.

The port of the JAX package's ``baselines/backbone.py``: one configurable
pre-LN ViT covering the variants the five adapters need (reference vendored
copies: baselines/dinov2.py via HF modules, satmae.py:93+, dofa.py timm
blocks):
  - CLS token (optional) + learned positional embeddings with a bicubic resize
    to the input grid that leaves the CLS position out
  - qkv with bias, LayerScale (DINOv2), standard MLP with exact GELU
  - arbitrary prefix tokens (e.g. SatMAE timestamp embeddings are added by
    the caller before the encoder)

Precision as ``models/vit.py``: fp32 parameters, dense layers in the compute
dtype, LayerNorm statistics in fp32.  The LayerNorms keep flax's default
epsilon, 1e-6, as the JAX package's adapters do.  Self-attention goes through
``ops/attention.mha_qkv``: the flash-attention kernels on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maestro_tpu_torch.models.vit import dense, init_linear, layer_norm, normal_parameter
from maestro_tpu_torch.ops.attention import mha_qkv
from maestro_tpu_torch.ops.patch import patchify_pixels
from maestro_tpu_torch.ops.resize import bicubic_matrix

FLAX_LN_EPS = 1e-6  # flax.linen.LayerNorm's default epsilon


def layer_norm_module(dim: int, device, eps: float = FLAX_LN_EPS) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps, device=device)


def linear(in_f: int, out_f: int, generator: torch.Generator, device,
           bias: bool = True) -> nn.Linear:
    """``nn.Linear`` with ``init_linear``'s seeded weights."""
    layer = nn.Linear(in_f, out_f, bias=bias, device=device)
    init_linear(layer, generator)
    return layer


def interpolate_pos_embed(
    pos: torch.Tensor,  # [1, L(+1), C] learned positions (optionally with CLS)
    grid: int,
    has_cls: bool,
) -> torch.Tensor:
    """CLS-aware bicubic resize of learned position embeddings.

    Reference: baselines/utils.py:148-196 (interpolate_pos_encoding) — fp32
    ``F.interpolate(mode="bicubic", align_corners=False)``; separable, so
    applied as A @ P @ A.T with the exact torch kernel matrix.
    """
    cls_pos, patch_pos = None, pos
    if has_cls:
        cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    src = round(patch_pos.shape[1] ** 0.5)
    if src != grid:
        c = patch_pos.shape[-1]
        p = patch_pos.reshape(src, src, c).float()
        a = bicubic_matrix(src, grid, p.device)
        p = torch.einsum("rg,ghc,sh->rsc", a, p, a)
        patch_pos = p.reshape(1, grid * grid, c).to(pos.dtype)
    if has_cls:
        return torch.cat([cls_pos, patch_pos], dim=1)
    return patch_pos


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, L, C*p*p], feature order (C, ph, pw)."""
    return patchify_pixels(x[:, None], patch)[:, 0]


class EncoderBlock(nn.Module):
    """Pre-LN block with optional LayerScale (DINOv2-style)."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype,
                 generator: torch.Generator, device, mlp_ratio: float = 4.0,
                 layerscale: bool = False, qkv_bias: bool = True) -> None:
        super().__init__()
        self.dim, self.heads, self.dtype, self.layerscale = dim, heads, dtype, layerscale
        self.norm1 = layer_norm_module(dim, device)
        self.qkv = linear(dim, dim * 3, generator, device, bias=qkv_bias)
        self.proj = linear(dim, dim, generator, device)
        if layerscale:
            self.ls1 = nn.Parameter(torch.full((dim,), 1e-5, device=device))
            self.ls2 = nn.Parameter(torch.full((dim,), 1e-5, device=device))
        self.norm2 = layer_norm_module(dim, device)
        self.fc1 = linear(dim, int(dim * mlp_ratio), generator, device)
        self.fc2 = linear(int(dim * mlp_ratio), dim, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        dh = self.dim // self.heads
        y = layer_norm(x, self.norm1, self.dtype)
        qkv = dense(y, self.qkv, self.dtype)
        out = mha_qkv(qkv.view(b, l, 3, self.heads, dh), dh**-0.5)
        out = dense(out.reshape(b, l, self.dim), self.proj, self.dtype)
        if self.layerscale:
            out = out * self.ls1.to(self.dtype)
        x = x + out
        y = layer_norm(x, self.norm2, self.dtype)
        y = F.gelu(dense(y, self.fc1, self.dtype), approximate="none")
        y = dense(y, self.fc2, self.dtype)
        if self.layerscale:
            y = y * self.ls2.to(self.dtype)
        return x + y


class EncoderStack(nn.Module):
    """Blocks ``block0`` .. ``block{depth-1}`` (the JAX package's
    ``ViTBackboneEncoderOnly``; patch embed and positions are the caller's)."""

    def __init__(self, dim: int, depth: int, heads: int, dtype: torch.dtype,
                 generator: torch.Generator, device, mlp_ratio: float = 4.0,
                 layerscale: bool = False) -> None:
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(
                dim, heads, dtype, generator, device, mlp_ratio, layerscale=layerscale))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
        return tokens


class ViTBackbone(nn.Module):
    """Patch projection + CLS + learned positions + encoder stack (+ final LN)."""

    def __init__(self, dim: int, depth: int, heads: int, in_chans: int, patch_size: int,
                 pos_grid: int, dtype: torch.dtype, generator: torch.Generator, device,
                 mlp_ratio: float = 4.0, use_cls: bool = True, layerscale: bool = False,
                 keep_norm: bool = True) -> None:
        super().__init__()
        self.dim, self.depth, self.patch_size, self.dtype = dim, depth, patch_size, dtype
        self.use_cls, self.keep_norm = use_cls, keep_norm
        self.patch_proj = linear(in_chans * patch_size**2, dim, generator, device)
        num_pos = pos_grid**2 + (1 if use_cls else 0)
        self.pos_embed = normal_parameter((1, num_pos, dim), generator, device, std=0.02)
        if use_cls:
            self.cls_token = nn.Parameter(torch.zeros((1, 1, dim), device=device))
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(
                dim, heads, dtype, generator, device, mlp_ratio, layerscale=layerscale))
        if keep_norm:
            self.norm = layer_norm_module(dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] pixels -> [B, L, dim] patch features (CLS removed)."""
        b = x.shape[0]
        grid = x.shape[2] // self.patch_size
        tokens = dense(patchify(x.to(self.dtype), self.patch_size), self.patch_proj, self.dtype)
        pos = interpolate_pos_embed(self.pos_embed, grid, self.use_cls)
        if self.use_cls:
            cls = self.cls_token.to(self.dtype).expand(b, 1, self.dim)
            tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + pos.to(self.dtype)
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
        if self.keep_norm:
            tokens = layer_norm(tokens, self.norm, self.dtype)
        return tokens[:, 1:] if self.use_cls else tokens
