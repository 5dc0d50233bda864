"""DOFA baseline adapter (wavelength-conditioned dynamic patch embedding).

The port of the JAX package's ``baselines/dofa.py`` (reference
baselines/dofa.py:22-678).  Each modality's patch-embed conv weights are
*generated* from sin/cos embeddings of its band center wavelengths (um) by a
small transformer ("TransformerWeightGenerator"): 128 learned weight tokens +
per-band wavelength tokens + 1 bias token run through a post-LN encoder
layer; band-token outputs map to per-band conv kernels, the bias token to the
conv bias, both scaled by 0.01.  The dynamic conv uses stride=patch and
padding=1 (kept as-is for weight parity).  A plain CLS+pos ViT encodes the
tokens; fusion is shared/monotemp.

The weight generator runs in fp32 and its attention is a plain einsum, as
XLA computes it in the JAX package (it is no Pallas kernel there); the
encoder blocks' attention is the flash kernel (``backbone.EncoderBlock``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from maestro_tpu_torch.baselines.backbone import (
    EncoderBlock,
    interpolate_pos_embed,
    layer_norm_module,
    linear,
)
from maestro_tpu_torch.baselines.base import BaselineShell, build_baseline_plan
from maestro_tpu_torch.conf.core import BaselineConfig
from maestro_tpu_torch.conf.datasets import DatasetsConfig
from maestro_tpu_torch.models.vit import layer_norm, normal_parameter
from maestro_tpu_torch.ops.resize import resize_token_grid

DOFA_ARCHS = {
    # "micro" is a test-only size for fast CPU tests; not a DOFA release
    "micro": (64, 2, 2),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
}

# per-modality band center wavelengths in micrometers (reference dofa.py:114-131)
DOFA_WAVELENGTHS = {
    "aerial": (0.64, 0.56, 0.48, 0.81),
    "spot": (0.66, 0.56, 0.48),
    "s2": (0.665, 0.560, 0.490, 0.842, 0.705, 0.740, 0.783, 0.865, 1.610, 2.190),
    "s1_asc": (5.405, 5.405),
    "s1_des": (5.405, 5.405),
    "s1": (5.405, 5.405),
    "dem": (0.0, 0.0),  # elevation has no wavelength; zeros as neutral input
    "landsat": (0.443, 0.482, 0.561, 0.655, 0.865, 1.609, 2.201, 0.590, 1.373,
                10.9, 12.0),
}
WAVE_DIM = 128
WEIGHT_TOKENS = 128


def wave_position_embedding(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """1-D sin/cos embedding of wavelengths*1000 (reference dofa.py:429-461)."""
    omega = torch.arange(dim // 2, dtype=torch.float32, device=pos.device) / (dim / 2.0)
    omega = 1.0 / 10000.0**omega
    out = torch.einsum("m,d->md", pos.reshape(-1).float(), omega)
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


class PostLNEncoderLayer(nn.Module):
    """torch ``nn.TransformerEncoderLayer(norm_first=False)`` semantics, fp32."""

    def __init__(self, dim: int, generator: torch.Generator, device, heads: int = 4,
                 ffn_dim: int = 2048) -> None:
        super().__init__()
        self.dim, self.heads = dim, heads
        self.qkv = linear(dim, dim * 3, generator, device)
        self.proj = linear(dim, dim, generator, device)
        self.norm1 = layer_norm_module(dim, device)
        self.fc1 = linear(dim, ffn_dim, generator, device)
        self.fc2 = linear(ffn_dim, dim, generator, device)
        self.norm2 = layer_norm_module(dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        l, _ = x.shape
        dh = self.dim // self.heads
        q, k, v = self.qkv(x).reshape(l, 3, self.heads, dh).permute(1, 2, 0, 3)
        attn = torch.softmax(torch.einsum("hqd,hkd->hqk", q, k) * dh**-0.5, dim=-1)
        out = torch.einsum("hqk,hkd->hqd", attn, v).permute(1, 0, 2).reshape(l, self.dim)
        x = self.norm1(x + self.proj(out))
        y = self.fc2(F.gelu(self.fc1(x), approximate="none"))
        return self.norm2(x + y)


class DOFAEmbedding(nn.Module):
    """Wavelength -> dynamic conv patch embedding."""

    def __init__(self, patch_size: int, embed_dim: int, dtype: torch.dtype,
                 generator: torch.Generator, device) -> None:
        super().__init__()
        self.patch_size, self.embed_dim, self.dtype = patch_size, embed_dim, dtype
        self.fcres_w1 = linear(WAVE_DIM, WAVE_DIM, generator, device)
        self.fcres_w2 = linear(WAVE_DIM, WAVE_DIM, generator, device)
        self.weight_tokens = normal_parameter((WEIGHT_TOKENS, WAVE_DIM), generator, device,
                                              std=0.02)
        self.bias_token = normal_parameter((1, WAVE_DIM), generator, device, std=0.02)
        self.weight_gen = PostLNEncoderLayer(WAVE_DIM, generator, device)
        self.fc_weight = linear(WAVE_DIM, patch_size * patch_size * embed_dim, generator,
                                device)
        self.fc_bias = linear(WAVE_DIM, embed_dim, generator, device)

    def forward(self, x: torch.Tensor, wavelengths: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> [B, L, embed_dim] via generated conv weights."""
        num_bands, p = wavelengths.shape[0], self.patch_size
        waves = wave_position_embedding(WAVE_DIM, wavelengths * 1000.0)
        # FCResLayer: two ReLU-activated linears with a residual
        waves = waves + F.relu(self.fcres_w2(F.relu(self.fcres_w1(waves))))
        # the weight generator over [128 weight tokens | bands | bias]
        seq = self.weight_gen(torch.cat([self.weight_tokens, waves, self.bias_token], dim=0))
        weight = self.fc_weight(seq[WEIGHT_TOKENS : WEIGHT_TOKENS + num_bands] + waves)
        bias = self.fc_bias(seq[-1]) * 0.01
        # [bands, p, p, embed] -> conv weight [embed, bands, p, p]
        kernel = weight.reshape(num_bands, p, p, self.embed_dim).permute(3, 0, 1, 2) * 0.01
        out = F.conv2d(x.float(), kernel, bias, stride=p, padding=1)  # reference quirk
        b, c, gh, gw = out.shape
        return out.reshape(b, c, gh * gw).transpose(1, 2).to(self.dtype)


class DOFABaseline(BaselineShell):
    """DOFA adapter: dynamic patch embed + shared/per-mod ViT encoder."""

    def __init__(self, plan, head_specs, *, backbone_size: str = "base", keep_norm: bool = True,
                 generator: torch.Generator, device, **shell) -> None:
        dim, depth, heads = DOFA_ARCHS[backbone_size]
        super().__init__(plan, head_specs, embed_dim=dim, **shell)
        self.keep_norm = keep_norm
        self.embedders = nn.ModuleDict({
            name: DOFAEmbedding(spec.patch_size, dim, self.dtype, generator, device)
            for name, spec in plan.mod_specs.items()
        })
        self.cls_token = normal_parameter((1, 1, dim), generator, device, std=0.02)
        # positions trained at 224 px / patch 16 -> grid 14 (+CLS)
        self.pos = nn.ParameterDict({
            name: normal_parameter((1, 14 * 14 + 1, dim), generator, device, std=0.02)
            for name in plan.mods
        })
        self.blocks = nn.ModuleDict({
            enc: nn.ModuleList([EncoderBlock(dim, heads, self.dtype, generator, device)
                                for _ in range(depth)])
            for enc in plan.encoder_names
        })
        if keep_norm:
            self.final_norm = layer_norm_module(dim, device)
        for name, spec in plan.mod_specs.items():
            waves = torch.tensor(DOFA_WAVELENGTHS[name][: spec.num_channels], device=device)
            self.register_buffer(f"waves_{name}", waves, persistent=False)
        self.make_heads(generator, device)

    def encode_for_heads(self, batch: dict) -> dict[str, torch.Tensor]:
        batch = self.resize_and_rescale(batch)
        pixels = self.plan.group({name: batch[name] for name in self.plan.mods})
        feats = {}
        for name, spec in self.plan.mod_specs.items():
            tokens = self.embedders[name](pixels[name], getattr(self, f"waves_{name}"))
            grid = round(tokens.shape[1] ** 0.5)
            pos = interpolate_pos_embed(self.pos[name], grid, has_cls=True)
            cls = self.cls_token.to(self.dtype) + pos[:, :1].to(self.dtype)
            tokens = tokens + pos[:, 1:].to(self.dtype)
            tokens = torch.cat([cls.expand(tokens.shape[0], 1, self.embed_dim), tokens], dim=1)
            for block in self.blocks[self.plan.streams[name].encoder]:
                tokens = block(tokens)
            if self.keep_norm:
                tokens = layer_norm(tokens, self.final_norm, self.dtype)
            tokens = tokens[:, 1:]
            # the padding quirk can change the grid by one row/col: resize back
            if grid != spec.grid:
                tokens = resize_token_grid(tokens[:, None], spec.grid, "bilinear")[:, 0]
            feats[name] = tokens
        if self.add_date_enc:
            feats = self.add_date_encodings(feats, batch)
        return feats


def build_dofa(datasets: DatasetsConfig, cfg: BaselineConfig, dtype: torch.dtype, *,
               generator: torch.Generator, device) -> DOFABaseline:
    if cfg.fusion_mode not in ("shared", "monotemp"):
        msg = f"DOFA supports shared/monotemp fusion, got {cfg.fusion_mode!r}."
        raise ValueError(msg)
    for name in datasets.dataset.inputs:
        if name not in DOFA_WAVELENGTHS:
            msg = f"No DOFA wavelength table for modality {name!r}."
            raise ValueError(msg)
    plan, head_specs = build_baseline_plan(datasets, cfg.fusion_mode, "dofa")
    return DOFABaseline(
        plan, head_specs, backbone_size=cfg.model_size, keep_norm=cfg.keep_norm,
        generator=generator, device=device, type_head=cfg.type_head,
        interpolate=cfg.interpolate, seg_chunk_rows=cfg.seg_chunk_rows,
        ref_input=datasets.dataset.ref_input, add_date_enc=cfg.add_date_enc, dtype=dtype,
    )
