"""Prithvi-EO baseline adapter (S2 only, 3-D patch embedding).

The port of the JAX package's ``baselines/prithvi.py`` (reference
baselines/prithvi.py:16-260, a terratorch backbone reimplemented).  A Conv3d
patch embed with tubelet size 1 over the date axis (a per-date 2-D patch
embed with shared weights), 3-D sincos positions over (T, H, W), an optional
temporal encoding from (year, day-of-year) coordinates (the v2 "_tl"
variant), a CLS token and plain ViT blocks.  Channel surgery maps the
HLS-pretrained 6-band patch kernel onto the dataset's S2 bands
(``ORIG_BANDS``, prithvi.py:13) when released weights are carried over.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from maestro_tpu_torch.baselines.backbone import EncoderBlock, layer_norm_module, linear
from maestro_tpu_torch.baselines.base import BaselineShell, build_baseline_plan
from maestro_tpu_torch.baselines.satmae import check_s2_only, sincos_1d, sincos_2d_grid
from maestro_tpu_torch.conf.core import BaselineConfig
from maestro_tpu_torch.conf.datasets import DatasetsConfig
from maestro_tpu_torch.models.vit import dense, layer_norm, normal_parameter
from maestro_tpu_torch.ops.patch import patchify_pixels

PRITHVI_ARCHS = {
    # "micro" is a test-only size for fast CPU tests; not a Prithvi release
    "micro": (64, 2, 2),
    "base": (768, 12, 12),  # v1 / 100M
    "large": (1024, 24, 16),  # v2 / 300M
}
ORIG_BANDS = (0, 1, 2, 6, 8, 9)


def sincos_3d(dim: int, t: int, grid: int) -> np.ndarray:
    """[T*L, dim] 3-D sincos: 1/4 of dims on time, 3/4 on space."""
    t_dim = dim // 4
    spatial = sincos_2d_grid(dim - t_dim, grid)  # [L, s_dim]
    omega = np.arange(t_dim // 2, dtype=np.float64) / (t_dim / 2.0)
    omega = 1.0 / 10000.0**omega
    out = np.einsum("m,d->md", np.arange(t, dtype=np.float64), omega)
    temporal = np.concatenate([np.sin(out), np.cos(out)], axis=1)  # [T, t_dim]
    full = np.concatenate(
        [np.repeat(temporal[:, None], grid * grid, axis=1), np.repeat(spatial[None], t, axis=0)],
        axis=-1,
    )
    return full.reshape(t * grid * grid, dim).astype(np.float32)


class PrithviBaseline(BaselineShell):
    """Prithvi adapter (fusion_mode='mod', S2 series only)."""

    def __init__(self, plan, head_specs, *, backbone_size: str = "large",
                 temporal_encoding: bool = True, keep_norm: bool = True,
                 generator: torch.Generator, device, **shell) -> None:
        dim, depth, heads = PRITHVI_ARCHS[backbone_size]
        super().__init__(plan, head_specs, embed_dim=dim, **shell)
        self.temporal_encoding, self.keep_norm = temporal_encoding, keep_norm
        spec = plan.mod_specs["s2"]
        self.patch_proj = linear(spec.num_channels * spec.patch_size**2, dim, generator, device)
        self.cls_token = normal_parameter((1, 1, dim), generator, device, std=0.02)
        self.blocks = nn.ModuleList([EncoderBlock(dim, heads, self.dtype, generator, device)
                                     for _ in range(depth)])
        if temporal_encoding:
            # terratorch's temporal encoder: a linear map of the year/doy sincos
            self.temp_proj = linear(dim, dim, generator, device)
        if keep_norm:
            self.final_norm = layer_norm_module(dim, device)
        self.register_buffer(
            "pos3d", torch.from_numpy(sincos_3d(dim, spec.num_dates, spec.grid)).to(device),
            persistent=False)
        self.make_heads(generator, device)

    def encode_for_heads(self, batch: dict) -> dict[str, torch.Tensor]:
        batch = self.resize_and_rescale(batch)
        spec = self.plan.mod_specs["s2"]
        x = batch["s2"].to(self.dtype)  # [B, D, C, H, W]
        b, d = x.shape[:2]
        l, dim = spec.grid**2, self.embed_dim
        xp = patchify_pixels(x, spec.patch_size).reshape(b, d * l, -1)  # date-major tokens
        tokens = dense(xp, self.patch_proj, self.dtype)
        tokens = tokens + self.pos3d[None].to(self.dtype)
        if self.temporal_encoding:
            dates = batch["s2_dates"].float()
            coords = torch.cat([sincos_1d(dim // 2, dates[:, :, 0]).reshape(b, d, -1),
                                sincos_1d(dim // 2, dates[:, :, 1] / 365.25).reshape(b, d, -1)],
                               dim=-1)
            temp = dense(coords, self.temp_proj, self.dtype)  # [B, D, dim]
            tokens = tokens + temp[:, :, None].expand(b, d, l, dim).reshape(b, d * l, dim)
        cls = self.cls_token.to(self.dtype).expand(b, 1, dim)
        tokens = torch.cat([cls, tokens], dim=1)
        for block in self.blocks:
            tokens = block(tokens)
        if self.keep_norm:
            tokens = layer_norm(tokens, self.final_norm, self.dtype)
        return {"s2": tokens[:, 1:]}


def build_prithvi(datasets: DatasetsConfig, cfg: BaselineConfig, dtype: torch.dtype, *,
                  generator: torch.Generator, device) -> PrithviBaseline:
    check_s2_only(datasets, cfg.fusion_mode, "Prithvi")
    version = cfg.version or ("v2" if cfg.model_size == "large" else "v1")
    allowed = {("base", "v1", False), ("large", "v2", False), ("large", "v2", True)}
    if cfg.model_size == "micro":  # test-only size: any combination
        allowed = {("micro", version, cfg.add_date_enc)}
    if (cfg.model_size, version, cfg.add_date_enc) not in allowed:
        msg = (
            f"Unsupported Prithvi combo size={cfg.model_size} version={version} "
            f"temporal={cfg.add_date_enc}; supported: {sorted(allowed)}."
        )
        raise ValueError(msg)
    plan, head_specs = build_baseline_plan(datasets, "mod", "prithvi")
    return PrithviBaseline(
        plan, head_specs, backbone_size=cfg.model_size, temporal_encoding=cfg.add_date_enc,
        keep_norm=cfg.keep_norm, generator=generator, device=device, type_head=cfg.type_head,
        interpolate=cfg.interpolate, seg_chunk_rows=cfg.seg_chunk_rows,
        ref_input=datasets.dataset.ref_input, add_date_enc=cfg.add_date_enc, dtype=dtype,
    )
