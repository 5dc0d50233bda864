"""Build the experiment's model from configs.

Single construction point mirroring the reference's instantiate-by-config
dispatch (maestro/run_experiment.py:33-52).  Only the MAE is ported; the
baseline foundation-model adapters are not.
"""

from __future__ import annotations

import torch

from maestro_tpu_torch.conf.core import ExperimentConfig
from maestro_tpu_torch.models.mae import build_model

BASELINE_MODELS = ("dinov2", "dofa", "croma", "satmae", "prithvi")


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
        msg = (f"baseline adapter {cfg.model.model!r} is not ported yet "
               "(ROADMAP.md queue 1 item 5).")
        raise NotImplementedError(msg)
    model, plan = build_model(
        datasets, cfg.mask, cfg.model, dtype=dtype, device=device,
        generator=generator, remat=cfg.trainer.remat,
    )
    return model, plan, False
