"""Baseline foundation-model adapters (DINOv2, DOFA, CROMA, SatMAE, Prithvi).

They run competitor models through the same probe/finetune harness as the
flagship MAE (the JAX package's ``baselines/``; reference
maestro/baselines/).  Weights start from ``generator`` (a seeded random
init), or from a released checkpoint ported by
``maestro_tpu_torch.scripts.port_fm`` and named by ``model.pretrained_path``.
"""

from __future__ import annotations

import torch

from maestro_tpu_torch.conf.core import BaselineConfig
from maestro_tpu_torch.conf.datasets import DatasetsConfig

BASELINE_MODELS = ("dinov2", "dofa", "croma", "satmae", "prithvi")


def build_baseline(
    datasets: DatasetsConfig,
    cfg: BaselineConfig,
    dtype: torch.dtype = torch.bfloat16,
    *,
    device="cuda",
    generator: torch.Generator | None = None,
):
    """Build a baseline adapter by name (``cfg.model``) on ``device``, its
    weights drawn from ``generator`` (default: seed 0)."""
    from maestro_tpu_torch.models.mae import resolve_device

    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    kw = {"generator": generator, "device": device}
    match cfg.model:
        case "dinov2":
            from maestro_tpu_torch.baselines.dinov2 import build_dinov2

            model = build_dinov2(datasets, cfg, dtype, **kw)
        case "dofa":
            from maestro_tpu_torch.baselines.dofa import build_dofa

            model = build_dofa(datasets, cfg, dtype, **kw)
        case "croma":
            from maestro_tpu_torch.baselines.croma import build_croma

            model = build_croma(datasets, cfg, dtype, **kw)
        case "satmae":
            from maestro_tpu_torch.baselines.satmae import build_satmae

            model = build_satmae(datasets, cfg, dtype, **kw)
        case "prithvi":
            from maestro_tpu_torch.baselines.prithvi import build_prithvi

            model = build_prithvi(datasets, cfg, dtype, **kw)
        case _:
            msg = f"Unknown baseline model {cfg.model!r}; expected {BASELINE_MODELS}."
            raise ValueError(msg)
    return model.eval()
