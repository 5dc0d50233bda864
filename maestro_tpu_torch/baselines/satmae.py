"""SatMAE baseline adapter (S2 only, timestamp positional embeddings).

The port of the JAX package's ``baselines/satmae.py`` (reference
baselines/satmae.py:26-519).  A ViT encoder whose positions reserve 384
channels for three 128-d sincos timestamp embeddings (year, day-of-year slot,
hour — the reference feeds doy into the "month" slot, kept for parity)
concatenated per date with a 2-D sincos grid embedding over the remaining
``dim - 384`` channels; all dates of the S2 series are concatenated on the
sequence axis ("mod" fusion); CLS prepended and dropped after the final norm.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from maestro_tpu_torch.baselines.backbone import EncoderBlock, layer_norm_module, linear
from maestro_tpu_torch.baselines.base import BaselineShell, build_baseline_plan
from maestro_tpu_torch.conf.core import BaselineConfig
from maestro_tpu_torch.conf.datasets import DatasetsConfig
from maestro_tpu_torch.models.vit import dense, layer_norm, normal_parameter
from maestro_tpu_torch.ops.patch import patchify_pixels

SATMAE_ARCHS = {
    # "micro" is a test-only size for fast CPU tests (dim must exceed the
    # 3x128 reserved timestamp channels); not a SatMAE release
    "micro": (448, 2, 8),
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
}
TS_DIM = 128  # per-component timestamp embedding width


def sincos_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    """[M] -> [M, dim] (reference satmae.py:454-470)."""
    omega = torch.arange(dim // 2, dtype=torch.float32, device=pos.device) / (dim / 2.0)
    omega = 1.0 / 10000.0**omega
    out = torch.einsum("m,d->md", pos.reshape(-1).float(), omega)
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_2d_grid(dim: int, grid: int) -> np.ndarray:
    """[grid*grid, dim] 2-D sincos (half for y, half for x)."""
    half = dim // 2
    omega = np.arange(half // 2, dtype=np.float64) / (half / 2.0)
    omega = 1.0 / 10000.0**omega
    ys, xs = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")

    def emb(p):
        out = np.einsum("m,d->md", p.ravel().astype(np.float64), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    return np.concatenate([emb(ys), emb(xs)], axis=1).astype(np.float32)


def check_s2_only(datasets: DatasetsConfig, fusion_mode: str, name: str) -> None:
    if fusion_mode != "mod":
        msg = f"{name} requires fusion_mode='mod', got {fusion_mode!r}."
        raise ValueError(msg)
    if list(datasets.dataset.inputs) != ["s2"]:
        msg = (f"{name} consumes only the S2 series; set "
               "datasets.<ds>.filter_inputs=[\"s2\"].")
        raise ValueError(msg)


class SatMAEBaseline(BaselineShell):
    """SatMAE adapter (fusion_mode='mod', S2 time series only)."""

    def __init__(self, plan, head_specs, *, backbone_size: str = "base", keep_norm: bool = True,
                 generator: torch.Generator, device, **shell) -> None:
        dim, depth, heads = SATMAE_ARCHS[backbone_size]
        super().__init__(plan, head_specs, embed_dim=dim, **shell)
        self.keep_norm = keep_norm
        spec = plan.mod_specs["s2"]
        self.cls_token = normal_parameter((1, 1, dim), generator, device, std=0.02)
        self.blocks = nn.ModuleList([EncoderBlock(dim, heads, self.dtype, generator, device)
                                     for _ in range(depth)])
        self.patch_proj = linear(spec.num_channels * spec.patch_size**2, dim, generator, device)
        if keep_norm:
            self.final_norm = layer_norm_module(dim, device)
        self.register_buffer(
            "pos2d", torch.from_numpy(sincos_2d_grid(dim - 3 * TS_DIM, spec.grid)).to(device),
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
        # positions: [2-D sincos (dim - 384) | year | doy slot | hour (3 x 128)]
        dates = batch["s2_dates"].float()  # [B, D, 3]
        ts = torch.cat([sincos_1d(TS_DIM, dates[:, :, i]) for i in range(3)], dim=1)
        ts = ts.reshape(b, d, 1, 3 * TS_DIM).expand(b, d, l, 3 * TS_DIM)
        pos = torch.cat([self.pos2d.expand(b, d, l, dim - 3 * TS_DIM), ts], dim=-1)
        tokens = tokens + pos.reshape(b, d * l, dim).to(self.dtype)
        cls = self.cls_token.to(self.dtype).expand(b, 1, dim)
        tokens = torch.cat([cls, tokens], dim=1)
        for block in self.blocks:
            tokens = block(tokens)
        if self.keep_norm:
            tokens = layer_norm(tokens, self.final_norm, self.dtype)
        return {"s2": tokens[:, 1:]}  # [B, D*L, C], the grouped "mod" layout


def build_satmae(datasets: DatasetsConfig, cfg: BaselineConfig, dtype: torch.dtype, *,
                 generator: torch.Generator, device) -> SatMAEBaseline:
    check_s2_only(datasets, cfg.fusion_mode, "SatMAE")
    plan, head_specs = build_baseline_plan(datasets, "mod", "satmae")
    return SatMAEBaseline(
        plan, head_specs, backbone_size=cfg.model_size, keep_norm=cfg.keep_norm,
        generator=generator, device=device, type_head=cfg.type_head,
        interpolate=cfg.interpolate, seg_chunk_rows=cfg.seg_chunk_rows,
        ref_input=datasets.dataset.ref_input, add_date_enc=cfg.add_date_enc, dtype=dtype,
    )
