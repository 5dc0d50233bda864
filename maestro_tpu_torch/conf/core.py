"""Optimizer / mask / model / trainer configs read by the ported code.

Field names and defaults follow the JAX package's ``conf/core.py`` (which
mirrors the reference config groups opt.py, mask.py, model.py, trainer.py).
Only the groups and fields that ported code reads are kept: the run and
data-pipeline groups arrive with the slices that consume them.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class OptConfig:
    """AdamW + OneCycle hyper-parameters shared across phases."""

    b1: float = 0.9
    b2: float = 0.99
    wd: float = 0.01
    accumulate_grad_batches: int = 1
    base_lr: float = 3e-5
    epochs: int = 20
    batch_size: int = 32


@dataclass
class OptPretrainConfig(OptConfig):
    base_lr: float = 3e-5
    epochs: int = 20
    batch_size: int = 32


@dataclass
class OptProbeConfig(OptConfig):
    base_lr: float = 1e-5
    epochs: int = 10
    batch_size: int = 32


@dataclass
class OptFinetuneConfig(OptConfig):
    """Finetuning optimizer config.

    ``monitor`` examples: ``treesat_mlc_thresh/weighted_f1_val`` (TreeSatAI),
    ``pastis_seg/average_iou_val`` (PASTIS-HD), ``cosia/average_iou_val``
    (FLAIR).  ``lw_decay`` is the layer-wise learning-rate decay rate
    (``train/optim.py::lw_decay_multipliers``); ``monitor`` and ``patience``
    are read by the runtime, which is not ported yet.
    """

    base_lr: float = 1e-5
    epochs: int = 20
    batch_size: int = 32
    lw_decay: float | None = None
    final_factor: float = 2.0
    monitor: str | None = None
    patience: int | None = 5


@dataclass
class MaskConfig:
    """Random + structured masking probabilities (reference conf/mask.py)."""

    mask_ratio: float = 0.75
    mask_scale: float = 0.0
    mask_mod: float | None = 0.25
    mask_bands: float | None = None
    mask_dates: float | None = 0.25
    mask_loc: float | None = 0.25


@dataclass
class ModelConfig:
    """Model options (reference conf/model.py:8-19).

    ``model`` selects the flagship MAE ("mae") or a baseline FM adapter
    ("dinov2" / "dofa" / "croma" / "satmae" / "prithvi"); only the MAE is
    ported so far.
    """

    interpolate: str = "nearest"
    fusion_mode: str = "group"
    inter_depth: int = 3  # number of shared inter-modality trunk blocks
    model: str = "mae"
    model_size: str = "tiny"
    type_head: str = "attentive"
    use_date_enc: bool = True
    use_ema: bool = True
    # attention head-split overrides (None = arch defaults with 128-dim
    # heads; set the reference splits — encoder 12 x 64 for medium, decoder
    # 16 x 32 — when loading ported reference checkpoints)
    encoder_heads: int | None = None
    encoder_dim_head: int | None = None
    decoder_heads: int | None = None
    decoder_dim_head: int | None = None
    # ref-grid rows per segmentation-head chunk (larger chunks mean fewer,
    # bigger launches but more live memory per chunk)
    seg_chunk_rows: int = 2


@dataclass
class TrainerConfig:
    """Execution config: precision policy, activation recompute and the
    non-finite guard."""

    # compute dtype for matmuls/activations; params stay fp32
    compute_dtype: str = "bfloat16"
    # activation recompute of the transformer blocks (models/vit.py):
    # false | true/"full" | "dots" (save the 2-D products' outputs) | "gelu" |
    # "mlp" (MLPs only)
    remat: bool | str = False
    # drop optimizer updates whose gradients contain inf/nan (the JAX
    # package's optax.apply_if_finite; make_optimizer(skip_nonfinite=...))
    skip_nonfinite: bool = False


@dataclass
class ExperimentConfig:
    """The config groups the ported entry points read."""

    mask: MaskConfig = field(default_factory=MaskConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
