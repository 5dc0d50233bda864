"""Build the experiment's model (MAE or baseline adapter) from configs.

Single construction point mirroring the reference's instantiate-by-config
dispatch (maestro/run_experiment.py:33-52).
"""

from __future__ import annotations

from dataclasses import fields

import torch

from maestro_tpu_torch.baselines import BASELINE_MODELS, build_baseline
from maestro_tpu_torch.conf.core import BaselineConfig, ExperimentConfig
from maestro_tpu_torch.models.mae import build_model


def build_experiment_model(datasets, cfg: ExperimentConfig, dtype=None, *,
                           device="cuda", generator=None):
    """Returns (model, plan, is_baseline) for the experiment config."""
    if dtype is None:
        dtype = (
            torch.bfloat16
            if cfg.trainer.compute_dtype == "bfloat16"
            else torch.float32
        )
    if cfg.model.model in BASELINE_MODELS:
        # the baseline fields of ModelConfig, by name
        bcfg = BaselineConfig(**{f.name: getattr(cfg.model, f.name)
                                 for f in fields(BaselineConfig)})
        model = build_baseline(datasets, bcfg, dtype, device=device, generator=generator)
        return model, model.plan, True
    model, plan = build_model(
        datasets, cfg.mask, cfg.model, dtype=dtype, device=device,
        generator=generator, remat=cfg.trainer.remat,
    )
    return model, plan, False
