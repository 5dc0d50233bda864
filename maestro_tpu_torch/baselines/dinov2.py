"""DINOv2 baseline adapter.

The port of the JAX package's ``baselines/dinov2.py`` (reference
baselines/dinov2.py:27-424): per-modality patch projections with their own
CLS tokens and learned positions (bicubic-resized to each modality's grid), a
weight-shared ("shared") or per-modality ("monotemp") DINOv2 encoder
(LayerScale ViT), the final LayerNorm, optional date encodings, and the
common probe/finetune heads.

Weight layouts: "imagenat" (facebook/dinov2-<size>, patch 14, position grid
37) or "sat" (satellite-adapted large, patch 16, grid 14).
"""

from __future__ import annotations

import torch
from torch import nn

from maestro_tpu_torch.baselines.backbone import (
    EncoderStack,
    interpolate_pos_embed,
    layer_norm_module,
    linear,
    patchify,
)
from maestro_tpu_torch.baselines.base import BaselineShell, build_baseline_plan
from maestro_tpu_torch.conf.core import BaselineConfig
from maestro_tpu_torch.conf.datasets import DatasetsConfig
from maestro_tpu_torch.models.vit import dense, layer_norm, normal_parameter

DINOV2_ARCHS = {
    # "micro" is a test-only size for fast CPU tests; not a DINOv2 release
    "micro": (64, 2, 2),
    "small": (384, 12, 6),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
    "huge": (1280, 32, 16),
}


class Dinov2Baseline(BaselineShell):
    """DINOv2 adapter: per-mod patch embed, shared/per-mod encoder."""

    def __init__(self, plan, head_specs, *, backbone_size: str = "small",
                 weight_source: str = "imagenat", keep_norm: bool = True,
                 generator: torch.Generator, device, **shell) -> None:
        dim, depth, heads = DINOV2_ARCHS[backbone_size]
        super().__init__(plan, head_specs, embed_dim=dim, **shell)
        # imagenat: patch 14 trained at 518 px -> 37x37 grid; sat: 16 @ 224 -> 14
        pos_grid = 37 if weight_source == "imagenat" else 14
        self.patch = 14 if weight_source == "imagenat" else 16
        self.keep_norm = keep_norm
        specs = plan.mod_specs
        self.patch_projs = nn.ModuleDict({
            name: linear(specs[name].num_channels * self.patch**2, dim, generator, device)
            for name in plan.mods
        })
        self.cls = nn.ParameterDict({
            name: nn.Parameter(torch.zeros((1, 1, dim), device=device)) for name in plan.mods
        })
        self.pos = nn.ParameterDict({
            name: normal_parameter((1, pos_grid**2 + 1, dim), generator, device, std=0.02)
            for name in plan.mods
        })
        self.encoders = nn.ModuleDict({
            name: EncoderStack(dim, depth, heads, self.dtype, generator, device,
                               layerscale=True)
            for name in plan.encoder_names
        })
        if keep_norm:
            self.final_norm = layer_norm_module(dim, device)
        self.make_heads(generator, device)

    def encode_for_heads(self, batch: dict) -> dict[str, torch.Tensor]:
        batch = self.resize_and_rescale(batch)
        # [B*D, C, H, W] per stream (shared / monotemp flatten the dates)
        pixels = self.plan.group({name: batch[name] for name in self.plan.mods})
        feats = {}
        for name, spec in self.plan.mod_specs.items():
            x = pixels[name].to(self.dtype)
            tokens = dense(patchify(x, self.patch), self.patch_projs[name], self.dtype)
            pos = interpolate_pos_embed(self.pos[name], spec.grid, has_cls=True)
            cls = self.cls[name].to(self.dtype).expand(x.shape[0], 1, self.embed_dim)
            tokens = torch.cat([cls, tokens], dim=1) + pos.to(self.dtype)
            tokens = self.encoders[self.plan.streams[name].encoder](tokens)
            if self.keep_norm:
                tokens = layer_norm(tokens, self.final_norm, self.dtype)
            feats[name] = tokens[:, 1:]  # drop CLS
        if self.add_date_enc:
            feats = self.add_date_encodings(feats, batch)
        return feats


def build_dinov2(datasets: DatasetsConfig, cfg: BaselineConfig, dtype: torch.dtype, *,
                 generator: torch.Generator, device) -> Dinov2Baseline:
    if cfg.fusion_mode not in ("shared", "monotemp"):
        msg = f"DINOv2 supports shared/monotemp fusion, got {cfg.fusion_mode!r}."
        raise ValueError(msg)
    plan, head_specs = build_baseline_plan(datasets, cfg.fusion_mode,
                                           f"dinov2_{cfg.weight_source}")
    return Dinov2Baseline(
        plan, head_specs, backbone_size=cfg.model_size, weight_source=cfg.weight_source,
        keep_norm=cfg.keep_norm, generator=generator, device=device,
        type_head=cfg.type_head, interpolate=cfg.interpolate,
        seg_chunk_rows=cfg.seg_chunk_rows, ref_input=datasets.dataset.ref_input,
        add_date_enc=cfg.add_date_enc, dtype=dtype,
    )
