"""Top-level run / optimizer / mask / data / model / trainer configs.

Field names and defaults follow the JAX package's ``conf/core.py`` field for
field (which mirrors the reference config groups run.py, opt.py, mask.py,
data.py, model.py, trainer.py), so one command line drives either package.
Options that only the JAX package can execute (device meshes over more than
one device, FSDP, K steps a dispatch) are kept as fields; the port's runtime
refuses them with ``NotImplementedError`` rather than ignoring them
(``train/runtime.py::check_supported``).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RunConfig:
    """Experiment identity, warm-start (load_*) and resume (fit_*) handles."""

    exp_dir: str = "runs"
    exp_name: str = "maestro"
    exp_uuid: str | None = None
    # warm-start: load weights only (cross-dataset transfer re-binds patch
    # embeds by name_embed; see reference run_experiment.py:66-74)
    load_name: str | None = None
    load_phase: str = "pretrain"
    load_uuid: str | None = None
    load_ckpt_path: str | None = None
    # resume: restore full train state (params + opt + step)
    fit_name: str | None = None
    fit_phase: str = "pretrain"
    fit_uuid: str | None = None
    fit_ckpt_path: str | None = None
    reproducible: bool = True
    seed: int = 42
    logged_images_per_epoch: int = 5
    # evaluate loaded weights on val/test without training; phases are still
    # selected by opt_<phase>.epochs > 0
    eval_only: bool = False
    # optional external experiment tracker, "module.path:factory" (see
    # train/tracking.py)
    tracker: str | None = None


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
    (``train/optim.py::lw_decay_multiplier``); ``monitor`` and ``patience``
    drive checkpoint selection and early stopping (``train/runtime.py``).
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
class DataConfig:
    """Host data-pipeline options."""

    use_transform: bool = True
    random_dates: bool = True
    random_crop: bool = True
    num_workers: int = 12
    prefetch: int = 4
    # "threads" = in-process pool (GIL released in h5py / rasterio / numpy
    # reads); "grain" = worker processes (data/mp_loader.py, the port's
    # counterpart of the JAX package's grain pipeline, under its CLI name);
    # "auto" = processes when num_workers >= 4 and the host has fewer than
    # 2 * num_workers cores, else threads (data/loader.py::resolve_loader)
    loader: str = "auto"


@dataclass
class ModelConfig:
    """Model options (reference conf/model.py:8-19 + baseline fields :22-34).

    ``model`` selects the flagship MAE ("mae") or a baseline FM adapter
    ("dinov2" / "dofa" / "croma" / "satmae" / "prithvi"); the baseline-only
    fields are ignored for the MAE (``models/factory.py`` passes them on as a
    ``BaselineConfig``).
    """

    interpolate: str = "nearest"
    fusion_mode: str = "group"
    inter_depth: int = 3  # number of shared inter-modality trunk blocks
    model: str = "mae"
    model_size: str = "tiny"
    type_head: str = "attentive"
    loss: str = "l1_norm"
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
    # the JAX package's scan unroll factor for those chunks; the port runs
    # the chunks as a Python loop, so the value changes nothing here
    seg_unroll: int = 1
    # baseline adapter options
    freeze: bool = False
    weight_source: str = "imagenat"
    pretrained_path: str | None = None
    keep_norm: bool = True
    add_date_enc: bool = True
    version: str | None = None


@dataclass
class BaselineConfig:
    """Baseline foundation-model adapter options (reference conf/model.py:22-34)."""

    interpolate: str = "nearest"
    fusion_mode: str = "shared"
    model: str = "dinov2"
    model_size: str = "small"
    type_head: str = "attentive"
    freeze: bool = False
    weight_source: str = "imagenat"
    pretrained_path: str | None = None
    keep_norm: bool = True
    add_date_enc: bool = True
    use_ema: bool = True
    version: str | None = None
    seg_chunk_rows: int = 2  # see ModelConfig.seg_chunk_rows
    seg_unroll: int = 1  # see ModelConfig.seg_unroll


@dataclass
class TrainerConfig:
    """Execution config: device layout, precision policy, checkpointing."""

    # process mesh: data-parallel x model(tensor)-parallel; -1 = all remaining
    # (one device a process; parallel/mesh.py)
    mesh_data: int = -1
    mesh_model: int = 1
    # outer pure data-parallel "replica" axis (multi-slice; HSDP under fsdp)
    mesh_replica: int = 1
    # weight / optimizer sharding over the data axis (FSDP2)
    fsdp: bool = False
    # compute dtype for matmuls/activations; params and optimizer state stay fp32
    compute_dtype: str = "bfloat16"
    # dtype float image streams are STAGED to the device in: "auto" casts
    # fp32 rasters to bfloat16 in the probe and finetune phases whenever
    # compute_dtype is bfloat16 (pretrain inputs are the loss targets and stay
    # fp32) | "float32" keeps the raw stream | "bfloat16" casts in every
    # phase.  Integer arrays (labels, dates) are never touched.
    input_dtype: str = "auto"
    # activation recompute of the transformer blocks (models/vit.py):
    # false | true/"full" | "dots" (save the 2-D products' outputs) | "gelu" |
    # "mlp" (MLPs only)
    remat: bool | str = False
    # per-step train-loss scalars to TensorBoard every N optimizer steps (the
    # only per-step host sync of the train loop)
    log_every_steps: int = 50
    # the JAX package donates the train state into its jitted step; the
    # port's steps update the state in place, so the flag changes nothing here
    donate_state: bool = True
    # steps fused per host dispatch (1 = one step per dispatch); > 1 is not
    # ported (CUDA graphs, ROADMAP.md)
    steps_per_dispatch: int = 1
    # non-blocking epoch checkpoints: device->host copy on a side stream,
    # serialization in a background thread (train/checkpoint.py)
    async_checkpoint: bool = True
    # drop optimizer updates whose gradients contain inf/nan instead of
    # poisoning params/moments (the JAX package's optax.apply_if_finite)
    skip_nonfinite: bool = False
    # probe val eval over cached frozen-trunk features: the trunk runs once
    # over the val split, later val epochs are head-only
    # (train/eval_cache.py; single-process runs only).  The first _device_gb
    # stay resident on the device; the rest spills to host RAM up to the
    # total _gb cap.
    probe_eval_cache: bool = True
    probe_eval_cache_gb: float = 8.0
    probe_eval_cache_device_gb: float = 2.0


@dataclass
class ExperimentConfig:
    """The full experiment: the config groups of the reference CLI."""

    run: RunConfig = field(default_factory=RunConfig)
    opt_pretrain: OptPretrainConfig = field(default_factory=OptPretrainConfig)
    opt_probe: OptProbeConfig = field(default_factory=OptProbeConfig)
    opt_finetune: OptFinetuneConfig = field(default_factory=OptFinetuneConfig)
    data: DataConfig = field(default_factory=DataConfig)
    mask: MaskConfig = field(default_factory=MaskConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
