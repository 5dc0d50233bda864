"""Training runtime: epoch loop, eval, checkpointing, phase orchestration.

Replaces the reference's Lightning stack (maestro/train/trainer.py +
run_experiment.py) as the JAX package's ``train/runtime.py`` does: three
explicit phases (pretrain -> probe -> finetune) share one model; each phase
builds its optimizer with phase-dependent freezing, runs its train step in a
plain epoch loop, evaluates with confusion-matrix metrics, EMA-updates once
per epoch, checkpoints every epoch (monitor + early stopping), and tests on
the best checkpoint.

The model is one ``torch.nn.Module`` that holds every parameter from the
start, built from ``run.seed``: the parameters a phase trains are carried
into the next phase in place (the JAX package's strict=False ``_merge_params``
carry-over), and the heads a phase adds keep their seeded initial values
until a phase trains them.  A warm start (``run.load_*``, or a baseline's
``model.pretrained_path`` written by ``scripts/port_fm``) fills, strict=False
by name and shape, the parameters of the first phase that runs
(``phase_params``), as the JAX package's first ``init_params`` does.

Each process drives one device, passed as ``device=`` (default
``"cuda"``).  A multi-process run (``torchrun``; ``parallel.distributed``)
lays the JAX package's mesh over its processes (``trainer.mesh_data``,
``mesh_model``, ``mesh_replica``; ``trainer.fsdp``): each data-parallel rank
loads its shard of every batch (``opt.batch_size`` is per shard, as in the
JAX package), the model is placed on the mesh once its warm start is in
(``parallel.mesh.Parallel``) and wrapped for each phase, the losses and
metric states are those of the global batch, and process 0 alone writes
TensorBoard, ``metrics.jsonl``, images, confusion matrices and checkpoints.
The knobs the port does not run raise ``NotImplementedError``
(``check_supported``).  The train loop keeps a host-side step counter and
reads a device value back only every ``trainer.log_every_steps`` steps and
once at the end of an epoch.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from maestro_tpu_torch.conf.core import ExperimentConfig, OptConfig
from maestro_tpu_torch.conf.datasets import DatasetsConfig
from maestro_tpu_torch.models.mae import resolve_device
from maestro_tpu_torch.parallel.distributed import (
    initialize_distributed,
    is_primary,
    process_count,
)
from maestro_tpu_torch.train import checkpoint as ckpt
from maestro_tpu_torch.train import preempt
from maestro_tpu_torch.train.optim import make_optimizer, param_role, trainable_roles
from maestro_tpu_torch.train.state import TrainState, ema_momentum, ema_update
from maestro_tpu_torch.train.steps import (
    compute_metrics,
    init_metric_states,
    make_pretrain_eval_step,
    make_pretrain_step,
    make_supervised_eval_step,
    make_supervised_step,
)

log = logging.getLogger("maestro_tpu_torch")


@dataclass
class PhaseResult:
    phase: str
    epochs_run: int
    best_epoch: int
    best_monitor: float | None
    val_metrics: dict[str, Any] = field(default_factory=dict)
    test_metrics: dict[str, Any] = field(default_factory=dict)
    history: list[dict] = field(default_factory=list)


def check_supported(cfg: ExperimentConfig) -> None:
    """Refuse, by name and ROADMAP.md item, the options the port does not run
    yet (none is ignored quietly)."""
    t = cfg.trainer
    if t.steps_per_dispatch > 1:
        msg = (f"not ported yet: trainer.steps_per_dispatch={t.steps_per_dispatch} (several "
               "steps a dispatch: CUDA graphs, ROADMAP.md queue 1 item 7)")
        raise NotImplementedError(msg)


def _check_resume_loader(meta: dict, data_cfg) -> None:
    """Refuse to resume an interrupted epoch under another loader than the
    one recorded in its checkpoint.

    The ``batches_done`` fast-forward replays the per-(seed, epoch) sample
    order; both loaders produce the same order, but the recorded choice is
    still enforced so that a later loader (or a version drift) can never
    silently retrain or skip samples (the JAX package's
    ``_check_resume_loader``).
    """
    saved = meta.get("loader")
    if not (meta.get("interrupted") and saved):
        return
    from maestro_tpu_torch.data.loader import resolve_loader

    current = resolve_loader(data_cfg)
    if saved != current:
        msg = (
            f"checkpoint was interrupted under data.loader={saved!r} but "
            f"this run resolves to {current!r}; set data.loader={saved!r} "
            "to resume (the batches_done fast-forward assumes the recorded "
            "loader's sample order)"
        )
        raise ValueError(msg)


_TORCH_SUFFIXES = (".pt", ".pth", ".ckpt", ".bin", ".safetensors")


def _resolve_pretrained_path(path: str, is_baseline: bool) -> str:
    """Validate ``model.pretrained_path`` (a baseline's released-weights warm
    start).

    The reference passes pretrained_path straight into each adapter's torch
    loader (e.g. croma.py:386-436); here the surgery runs once offline
    (``maestro_tpu_torch.scripts.port_fm``) and training reads the checkpoint
    it writes, warm-started strict=False like ``run.load_ckpt_path``.  A path
    that cannot be that checkpoint fails loudly instead of being ignored (the
    JAX package's ``_resolve_pretrained_path``).
    """
    if not is_baseline:
        msg = (
            "model.pretrained_path is consumed by baseline FM adapters; for "
            "flagship MAE checkpoints use run.load_name / run.load_ckpt_path "
            "(a reference .ckpt is ported by python -m "
            "maestro_tpu_torch.scripts.port_checkpoint)."
        )
        raise ValueError(msg)
    p = Path(path)
    if p.suffix.lower() in _TORCH_SUFFIXES:
        msg = (
            f"model.pretrained_path={path!r} looks like a torch checkpoint; "
            "port it first: python -m maestro_tpu_torch.scripts.port_fm --ckpt "
            "<file> --out <dir> model.model=... , then set "
            "model.pretrained_path=<dir>/fm-epoch=0"
        )
        raise ValueError(msg)
    if not (p / "state").exists():
        msg = (
            f"model.pretrained_path={path!r} has no 'state' subdirectory — "
            "expected a checkpoint written by python -m "
            "maestro_tpu_torch.scripts.port_fm"
        )
        raise FileNotFoundError(msg)
    return str(p)


def phase_params(model: torch.nn.Module, phase: str) -> dict[str, torch.nn.Parameter]:
    """The parameters a phase's forward and loss use, by name: pretrain
    everything but the heads, probe and finetune everything but the
    reconstruction side (the parameter tree the JAX package's ``init`` of
    that phase creates)."""
    used = ("backbone", "decoder") if phase == "pretrain" else ("backbone", "head")
    return {n: p for n, p in model.named_parameters() if param_role(n) in used}


class Experiment:
    """One experiment = one model trained through up to three phases."""

    def __init__(
        self,
        cfg: ExperimentConfig,
        datasets: DatasetsConfig,
        workdir: str | Path = "runs/debug",
        *,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        check_supported(cfg)
        self.cfg = cfg
        # the mesh over the processes (none for one process without a group:
        # the JAX package's mesh of one device, where fsdp shards nothing)
        import torch.distributed as dist

        from maestro_tpu_torch.parallel.mesh import make_mesh, mesh_shape

        t = cfg.trainer
        initialize_distributed(self.device)
        if dist.is_initialized():
            self.mesh = make_mesh(t.mesh_data, t.mesh_model, t.mesh_replica, self.device.type)
        else:
            mesh_shape(1, t.mesh_data, t.mesh_model, t.mesh_replica)
            self.mesh = None
        self.parallel = None  # the model on the mesh, after its warm start
        self.datasets = datasets
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)

        from maestro_tpu_torch.models.factory import build_experiment_model

        self.model, self.plan, self.is_baseline = build_experiment_model(
            datasets, cfg, device=self.device,
            generator=torch.Generator().manual_seed(cfg.run.seed),
        )
        self._initialized = False  # the warm start applies at the first phase only
        self._warm_start: str | None = None  # load_* or pretrained_path, weights only
        if cfg.model.pretrained_path:
            self._warm_start = _resolve_pretrained_path(
                cfg.model.pretrained_path, self.is_baseline,
            )
        self._writer = None
        self._saver = None  # lazy AsyncSaver (trainer.async_checkpoint)
        self._trackers = None  # lazy (see train/tracking.py)
        self._staging_phase: str | None = None
        self._last_eval_cache = None

    # ------------------------------------------------------------------
    def _save_ckpt(self, phase: str, epoch: int, state, extra: dict):
        if self.parallel is not None:  # meta.json records the placement it was saved from
            extra = {**extra, "parallel": self.parallel.describe()}
        if self.cfg.trainer.async_checkpoint:
            if self._saver is None:
                self._saver = ckpt.AsyncSaver()
            return self._saver.save(
                self.workdir / "checkpoints", phase, epoch, state, extra=extra,
            )
        return ckpt.save_checkpoint(
            self.workdir / "checkpoints", phase, epoch, state, extra=extra,
        )

    def _ckpt_barrier(self) -> None:
        """Join in-flight async saves (before restore / phase handoff); in a
        parallel run every rank then waits for process 0's write."""
        if self._saver is not None:
            self._saver.wait()
        if self.parallel is not None:
            import torch.distributed as dist

            dist.barrier()

    def batch_shard(self) -> tuple[int, int]:
        """(index, count) of this process's shard of every batch: its rank
        over the mesh's batch axes (tensor-parallel peers read the same
        rows)."""
        if self.mesh is None or self.cfg.run.eval_only:
            return 0, 1
        from maestro_tpu_torch.parallel.mesh import batch_shard_index, num_batch_shards

        return batch_shard_index(self.mesh), num_batch_shards(self.mesh)

    def _place(self, roles) -> Any:
        """The model on the mesh (placed once, after the warm start), wrapped
        for a phase that trains ``roles``; None in an unparallel run."""
        if self.mesh is None:
            return None
        if self.parallel is None:
            from maestro_tpu_torch.parallel.mesh import Parallel

            self.parallel = Parallel(self.model, self.mesh, fsdp=self.cfg.trainer.fsdp)
            log.info("placed on the mesh: %s", self.parallel.describe())
        self.parallel.for_phase(roles)
        return self.parallel

    def close(self, *, trackers: bool = True) -> None:
        """Release the async checkpointer thread and the TB writer;
        ``trackers=False`` keeps external trackers alive across phases (one
        session per run, closed once after the phase loop)."""
        if self._saver is not None:
            self._saver.close()
            self._saver = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if trackers and self._trackers is not None:
            for t in self._trackers:
                try:
                    t.close()
                except Exception:
                    log.exception(
                        "external tracker %s raised in close(); ignoring",
                        type(t).__name__,
                    )
            self._trackers = None

    # ------------------------------------------------------------------
    @property
    def writer(self):
        """TensorBoard writer; a no-op sink on processes other than 0."""
        if self._writer is None:
            from maestro_tpu_torch.utils.tb import NullWriter, SummaryWriter

            self._writer = (SummaryWriter(str(self.workdir / "tb")) if is_primary()
                            else NullWriter())
        return self._writer

    def _log_scalar(self, tag: str, value: float, step: int) -> None:
        self.writer.add_scalar(tag, value, step)

    def _append_jsonl(self, record: dict) -> None:
        """Experiment tracking sink: metrics.jsonl always, plus an optional
        external tracker (run.tracker / $MAESTRO_TRACKER); process 0 only."""
        if not is_primary():
            return
        from maestro_tpu_torch.train.tracking import JsonlTracker, build_trackers

        if self._trackers is None:
            from dataclasses import asdict

            self._trackers = build_trackers(
                self.workdir, asdict(self.cfg), self.cfg.run.tracker,
            )
        # external trackers are best-effort; the jsonl record is not
        failed = []
        for t in self._trackers:
            if isinstance(t, JsonlTracker):
                t.log_record(record)
                continue
            try:
                t.log_record(record)
            except Exception:
                log.exception(
                    "external tracker %s raised in log_record(); disabling "
                    "it for the rest of the run (jsonl/TB sinks continue)",
                    type(t).__name__,
                )
                failed.append(t)
        for t in failed:
            self._trackers.remove(t)

    @torch.no_grad()
    def _log_images(self, phase, epoch, state, np_batch) -> None:
        """Per-epoch image logging (reference train/logger.py ImageLogger):
        up to ``run.logged_images_per_epoch`` samples of one fixed val batch
        (fetched once per phase by fit_phase).  In a parallel run every rank
        enters the forward (a collective under FSDP or tensor parallelism),
        the data-parallel ranks' rows are gathered, and process 0 draws."""
        from maestro_tpu_torch.train.logging import EpochImageLogger

        par = self.parallel
        batch = self._device_batch(np_batch)
        self.model.eval()

        limit = self.cfg.run.logged_images_per_epoch

        def host(tree):  # the first samples, floats as float32 (masks stay bool)
            return {k: (v[:limit] if v.dtype == torch.bool else v[:limit].float())
                    .cpu().numpy() for k, v in tree.items()}

        def global_rows(*trees):  # the data-parallel ranks' rows, in rank order
            if par is None:
                return trees
            parts = par.gather_objects(trees)
            return tuple({k: np.concatenate([p[i][k] for p in parts]) for k in trees[i]}
                         for i in range(len(trees)))

        def image_logger():
            return EpochImageLogger(self.writer, self.datasets.dataset.log_inputs,
                                    self.cfg.run.logged_images_per_epoch)

        if phase == "pretrain":
            from maestro_tpu_torch.train.steps import mask_generator

            rows = {} if par is None else {"mask_rows": par.rows(len(batch["ref_date"]))}
            pixels, masks, targets = self.model(
                batch, "pretrain", generator=mask_generator(self.cfg.run.seed + 1, 0), **rows)
            pixels, masks, targets = global_rows(host(pixels), host(masks), host(targets))
            if not is_primary():
                return
            n_samples = min(limit, len(next(iter(pixels.values()))))
            logger = image_logger()
            for i in range(n_samples):
                logger.log_reconstruction(
                    phase, "val", epoch, targets, pixels, masks, sample=i,
                )
            return
        logits, np_batch = global_rows(host(self.model(batch, phase)),
                                       {k: v[:limit] for k, v in np_batch.items()})
        if not is_primary():
            return
        n_samples = min(limit, len(np_batch[self.datasets.dataset.log_inputs[0]]))
        logger = image_logger()
        for hs in self.model.head_specs:
            if hs.type_target != "segment":
                continue
            for i in range(n_samples):
                image = np_batch[self.datasets.dataset.log_inputs[0]][i, 0]
                logger.log_segmentation(
                    phase, "val", epoch, hs.name, image, logits[hs.name][i, 0],
                    np_batch[hs.name][i, 0, 0], hs.num_classes, hs.missing_val, sample=i,
                )

    def _log_confusion(self, phase, stage, epoch, metric_states) -> None:
        """CM heatmaps to TB + .npy dumps (reference train/logger.py:143-305)."""
        from maestro_tpu_torch.train.logging import (
            confusion_matrix_image,
            dump_confusion_matrix,
        )

        if metric_states is None or not is_primary():
            return
        for hs in self.model.head_specs:
            cm = metric_states[hs.name]["cm"].cpu().numpy()  # C x C, or K x 2 x 2
            dump_confusion_matrix(
                cm,
                self.workdir / "cm" / f"{phase}_{stage}_{hs.name}_epoch{epoch}.npy",
            )
            if cm.ndim == 2:  # mono-label CxC matrix -> heatmap image
                self.writer.add_image(
                    f"{phase}_{hs.name}_{stage}/confusion_matrix",
                    confusion_matrix_image(cm), epoch,
                )

    # ------------------------------------------------------------------
    def init_params(self, phase: str) -> None:
        """Make the model's parameters ready for ``phase``: at the first phase
        of the experiment, the strict=False warm start of the parameters the
        phase uses; later phases carry on the parameters as they are."""
        if self._initialized:
            return
        self._initialized = True
        if self._warm_start:
            unmatched: list = []
            ckpt.load_weights(self._warm_start, phase_params(self.model, phase), unmatched)
            log.info("warm-started weights from %s (%d parameters kept fresh init)",
                     self._warm_start, len(unmatched))

    def _stage_dtype(self, v: torch.Tensor) -> torch.Tensor:
        """The staging dtype of one host array (trainer.input_dtype).

        "auto" stages float32 streams as bf16 for SUPERVISED phases under a
        bf16 compute policy only: there the float streams are images feeding
        a bf16 trunk (labels are integer-valued), so staging in bf16 moves
        the in-step cast to the host and halves the transfer.  Pretrain
        inputs double as the reconstruction TARGETS (patch-group-norm
        statistics), so "auto" leaves them fp32; "bfloat16" forces the cast
        everywhere.
        """
        cfg = self.cfg.trainer
        bf16 = cfg.input_dtype == "bfloat16" or (
            cfg.input_dtype == "auto"
            and cfg.compute_dtype == "bfloat16"
            and self._staging_phase in ("probe", "finetune")
        )
        return torch.bfloat16 if bf16 and v.dtype == torch.float32 else v.dtype

    def _device_batch(self, np_batch: dict) -> dict[str, torch.Tensor]:
        """A loader batch (numpy) as tensors on the device, float streams in
        their staging dtype.  On a CUDA device each array goes through a
        pinned buffer of its own and is copied with ``non_blocking=True``
        (the caching host allocator keeps the buffer until its copy is done)."""
        out = {}
        for k, v in np_batch.items():
            host = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) \
                else torch.as_tensor(v)
            dtype = self._stage_dtype(host)
            if self.device.type == "cuda":
                pinned = torch.empty(host.shape, dtype=dtype, pin_memory=True)
                pinned.copy_(host)
                out[k] = pinned.to(self.device, non_blocking=True)
            else:
                out[k] = host.to(self.device, dtype)
        return out

    # ------------------------------------------------------------------
    def fit_phase(
        self,
        phase: str,
        opt: OptConfig,
        train_loader,
        val_loader=None,
        test_loader=None,
        resume_path: str | None = None,
    ) -> PhaseResult:
        """Train one phase; returns metrics history and best checkpoint info."""
        cfg = self.cfg
        self._staging_phase = phase  # input_dtype="auto" keys off the phase
        monitor = getattr(opt, "monitor", None)
        patience = getattr(opt, "patience", None)
        self.init_params(phase)
        seed = cfg.run.seed + 1  # mask draws (the JAX package's PRNGKey(seed + 1))

        if cfg.run.eval_only:
            return self._eval_only_phase(phase, val_loader, test_loader, seed)

        steps_per_epoch = max(len(train_loader) // opt.accumulate_grad_batches, 1)
        total_steps = steps_per_epoch * opt.epochs
        # frozen baseline backbones train heads only, like probing
        freeze_phase = (
            "probe" if (self.is_baseline and cfg.model.freeze and phase != "pretrain")
            else phase
        )
        # the phase's frozen roles stop requiring gradients before the model
        # is wrapped for it (DDP refuses a parameter that gets no gradient)
        par = self._place(trainable_roles(freeze_phase))
        shards = 1 if par is None else par.dp_size
        tx = make_optimizer(opt, freeze_phase, total_steps, self.model, shards,
                            skip_nonfinite=cfg.trainer.skip_nonfinite)
        state = TrainState.create(self.model, tx, use_ema=cfg.model.use_ema, parallel=par)

        start_epoch, resume_skip = 0, 0
        if resume_path:
            state = ckpt.restore_state(resume_path, state)
            meta = ckpt.load_meta(resume_path)
            _check_resume_loader(meta, cfg.data)
            done = ckpt.checkpoint_epoch(resume_path)
            if done is not None:
                # a regular checkpoint marks a COMPLETED epoch -> continue at
                # the next one; a preemption checkpoint is mid-epoch -> finish
                # that epoch, fast-forwarding past the batches already trained
                start_epoch = done if meta.get("interrupted") else done + 1
                if meta.get("interrupted"):
                    resume_skip = int(meta.get("batches_done", 0))
            start_epoch = min(start_epoch, opt.epochs)
            log.info("resumed %s from %s (step=%d, starting epoch %d%s)",
                     phase, resume_path, state.step, start_epoch,
                     f", skipping {resume_skip} batches" if resume_skip else "")

        if phase == "pretrain":
            train_step = make_pretrain_step(self.model, self.plan, tx, cfg.model.loss,
                                            parallel=par)
            eval_step = make_pretrain_eval_step(self.model, self.plan, cfg.model.loss,
                                                parallel=par)
        else:
            train_step = make_supervised_step(self.model, phase, tx, parallel=par)
            eval_step = make_supervised_eval_step(
                self.model, phase, use_ema=(phase == "finetune"), parallel=par,
            )

        # frozen-trunk phases (probe): _run_eval_epoch pins the val loader to
        # epoch 0, so the val batch stream is identical every epoch and the
        # frozen trunk's features of it are constant — cache them and make
        # later val epochs head-only.  A first-replay guard (recompute batch
        # 0, compare) backstops the invariance assumption.
        eval_cache = None
        if (
            freeze_phase == "probe"
            and cfg.trainer.probe_eval_cache
            and val_loader is not None
            and opt.epochs - start_epoch > 1  # a single eval never re-reads
            and process_count() == 1  # the cache holds one process's batches
            and hasattr(self.model, "encode_for_heads")
        ):
            from maestro_tpu_torch.train.eval_cache import ProbeEvalCache, clamp_device_cap
            from maestro_tpu_torch.train.steps import make_feature_step, make_head_eval_step

            eval_cache = ProbeEvalCache(
                feature_step=make_feature_step(self.model),
                head_step=make_head_eval_step(
                    self.model, phase, use_ema=(phase == "finetune"),
                ),
                label_keys=tuple(hs.name for hs in self.model.head_specs),
                cap_bytes=int(cfg.trainer.probe_eval_cache_gb * 2**30),
                device_cap_bytes=clamp_device_cap(
                    int(cfg.trainer.probe_eval_cache_device_gb * 2**30), self.device,
                ),
            )
        self._last_eval_cache = eval_cache  # observability (tests, chip_smoke.py)

        result = PhaseResult(phase, 0, -1, None)
        best_monitor, best_epoch, best_path, stale = -np.inf, -1, None, 0
        warned_monitor = False
        viz_batch = (
            next(iter(val_loader))
            if val_loader is not None and cfg.run.logged_images_per_epoch > 0
            else None
        )
        val_logs: dict = {}

        for epoch in range(start_epoch, opt.epochs):
            t0 = time.time()
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            epoch_skip = resume_skip if epoch == start_epoch else 0
            if epoch_skip:
                if not (hasattr(train_loader, "skip_batches")
                        and hasattr(train_loader, "set_epoch")):
                    # silently retraining batches_done batches would corrupt
                    # the step count / LR schedule - fail loudly instead
                    msg = (
                        f"resuming an interrupted epoch needs a loader with "
                        f"set_epoch/skip_batches, got {type(train_loader)}"
                    )
                    raise TypeError(msg)
                train_loader.skip_batches = epoch_skip
            train_logs = self._run_train_epoch(phase, state, train_step, train_loader, seed)
            state = train_logs.pop("state")
            batches_done = train_logs.pop("batches_done", 0) + epoch_skip

            if preempt.stop_requested():
                # graceful preemption: persist mid-epoch (before the
                # epoch-level EMA update - the epoch is incomplete) and stop;
                # run.fit_name/fit_phase resumes this epoch at batches_done
                from maestro_tpu_torch.data.loader import resolve_loader

                path = self._save_ckpt(
                    phase, epoch, state,
                    extra={"epoch": epoch, "phase": phase,
                           "interrupted": True,
                           "batches_done": batches_done,
                           # batches_done fast-forward assumes the identical
                           # sample order — the resume must use this loader
                           "loader": resolve_loader(cfg.data)},
                )
                self._ckpt_barrier()  # durable before the process exits
                raise preempt.Preempted(phase, str(path))

            if state.ema is not None:
                state = ema_update(state, ema_momentum(opt.epochs))

            val_logs, val_states = {}, None
            if val_loader is not None:
                val_logs, val_states = self._run_eval_epoch(
                    phase, state, eval_step, val_loader, seed, cache=eval_cache,
                )

            epoch_log = {
                "epoch": epoch,
                "time_s": round(time.time() - t0, 2),
                # state.step counts micro-steps; the schedule advances once per
                # OPTIMIZER step, i.e. every accumulate_grad_batches micro-steps
                "lr": float(tx.schedule(max(
                    state.step // max(opt.accumulate_grad_batches, 1) - 1, 0,
                ))),
                **{f"train/{k}": v for k, v in train_logs.items()},
                **{f"val/{k}": v for k, v in _flat_metrics(val_logs).items()},
            }
            result.history.append(epoch_log)
            for k, v in epoch_log.items():
                if isinstance(v, (int, float)):
                    self._log_scalar(f"{phase}_{k}", v, epoch)
            self._append_jsonl({"phase": phase, **epoch_log})
            log.info("%s epoch %d: %s", phase, epoch, epoch_log)

            if phase != "pretrain":
                self._log_confusion(phase, "val", epoch, val_states)
            if viz_batch is not None:
                try:
                    self._log_images(phase, epoch, state, viz_batch)
                except Exception:  # noqa: BLE001 - viz must never kill training
                    log.exception("image logging failed")

            # checkpoint + monitor
            score = (
                _lookup_monitor(val_logs, monitor, phase) if monitor else None
            )
            if monitor and val_logs and score is None and not warned_monitor:
                # a typo'd monitor would otherwise silently disable early
                # stopping and degrade test-on-best to test-on-last
                warned_monitor = True
                log.warning(
                    "monitor %r matches no val metric (available: %s); every "
                    "epoch counts as best and early stopping is inactive",
                    monitor, sorted(_flat_metrics(val_logs)),
                )
            path = self._save_ckpt(
                phase, epoch, state, extra={"epoch": epoch, "phase": phase},
            )
            if monitor is None or score is None or score > best_monitor:
                best_monitor = score if score is not None else -np.inf
                best_epoch, best_path, stale = epoch, path, 0
            else:
                stale += 1
            if patience is not None and monitor is not None and stale > patience:
                log.info("early stopping %s at epoch %d", phase, epoch)
                break

        result.epochs_run = len(result.history)
        result.best_epoch = best_epoch
        result.best_monitor = None if best_monitor == -np.inf else float(best_monitor)
        if val_loader is not None:
            if result.history:
                # the last loop iteration already evaluated this exact state
                result.val_metrics = _flat_metrics(val_logs)
            else:  # resume-complete: no epochs ran, so no in-loop eval did
                final_val, _ = self._run_eval_epoch(
                    phase, state, eval_step, val_loader, seed,
                )
                result.val_metrics = _flat_metrics(final_val)

        # test on best checkpoint
        self._ckpt_barrier()  # epoch saves must be committed before restore
        if test_loader is not None and best_path is not None:
            state = ckpt.restore_state(best_path, state)
            test_metrics, test_states = self._run_eval_epoch(
                phase, state, eval_step, test_loader, seed,
            )
            result.test_metrics = _flat_metrics(test_metrics)
            if phase != "pretrain":
                self._log_confusion(phase, "test", best_epoch, test_states)
            log.info("%s test: %s", phase, result.test_metrics)
        return result

    # ------------------------------------------------------------------
    def _eval_only_phase(self, phase, val_loader, test_loader, seed) -> PhaseResult:
        """Score loaded weights on val/test without training (run.eval_only)."""
        cfg = self.cfg
        if phase == "pretrain":
            eval_step = make_pretrain_eval_step(self.model, self.plan, cfg.model.loss)
        else:
            eval_step = make_supervised_eval_step(
                self.model, phase, use_ema=(phase == "finetune"),
            )
        # finetune evaluates the EMA weights when the source checkpoint has
        # them (reference evaluates model_ema in finetune val/test)
        ema = None
        if phase == "finetune" and self._warm_start:
            ema = ckpt.load_ema_weights(self._warm_start, self.model)
            if ema is not None:
                log.info("eval_only: using EMA weights from %s", self._warm_start)
        state = TrainState(step=0, model=self.model, tx=None, ema=ema)

        result = PhaseResult(phase, 0, -1, None)
        if val_loader is not None:
            final_val, val_states = self._run_eval_epoch(
                phase, state, eval_step, val_loader, seed,
            )
            result.val_metrics = _flat_metrics(final_val)
            if phase != "pretrain":
                self._log_confusion(phase, "val", 0, val_states)
            log.info("%s eval-only val: %s", phase, result.val_metrics)
        if test_loader is not None:
            test_metrics, test_states = self._run_eval_epoch(
                phase, state, eval_step, test_loader, seed,
            )
            result.test_metrics = _flat_metrics(test_metrics)
            if phase != "pretrain":
                self._log_confusion(phase, "test", 0, test_states)
            log.info("%s eval-only test: %s", phase, result.test_metrics)
        self._append_jsonl({
            "phase": phase, "eval_only": True,
            **{f"val/{k}": v for k, v in (result.val_metrics or {}).items()},
            **{f"test/{k}": v for k, v in (result.test_metrics or {}).items()},
        })
        return result

    # ------------------------------------------------------------------
    def _run_train_epoch(self, phase, state, train_step, loader, seed) -> dict:
        losses = []
        log_every = self.cfg.trainer.log_every_steps
        metric_states = (
            init_metric_states(self.model.head_specs, self.device)
            if phase != "pretrain" else None
        )
        # host-side step counter: the step count never leaves the host, and
        # a device value is read back only every log_every steps
        step_i = state.step
        for np_batch in loader:
            if preempt.stop_requested():
                break
            batch = self._device_batch(np_batch)
            if phase == "pretrain":
                state, logs = train_step(state, batch, seed)
            else:
                state, metric_states, logs = train_step(state, batch, metric_states)
            losses.append(logs)
            step_i += 1
            if log_every > 0 and step_i % log_every == 0:
                key = "loss_rec" if phase == "pretrain" else "loss_pred"
                self._log_scalar(f"{phase}_train/{key}_step", float(logs[key]), step_i)
        out = {k: _host_mean([lg[k] for lg in losses]) for k in (losses[0] if losses else {})}
        if metric_states is not None:
            out.update(_flat_metrics(
                compute_metrics(self.model.head_specs, self._summed(metric_states)),
            ))
        out["state"] = state
        # one loss entry per trained batch: the preemption checkpoint records
        # this so resume fast-forwards the loader past them
        out["batches_done"] = len(losses)
        return out

    def _summed(self, metric_states):
        """The metric states of the global batch: summed over the
        data-parallel ranks (before ``compute_metrics``, and before the
        confusion matrices are written)."""
        return metric_states if self.parallel is None else self.parallel.sum_states(metric_states)

    def _run_eval_epoch(self, phase, state, eval_step, loader, seed, cache=None):
        """Returns (metrics dict, raw metric states or None).

        ``cache`` (frozen-trunk val only): a train.eval_cache.ProbeEvalCache.
        On its first pass this loop computes trunk features per batch, runs
        the heads off them, and stores them; once sealed, later epochs replay
        the cached features head-only without touching the loader.  On the
        FIRST replay the guard recomputes batch 0's features through the
        loader and compares them to the cached entry — a mismatch disables
        the cache with a warning and falls back to full per-epoch eval.

        As in the JAX package (docs/PARITY.md): the pretrain val masks are
        drawn per batch index, the same every epoch; val/test loaders are
        PINNED to epoch 0, so every eval pass draws the identical batch
        stream — which is what makes the feature cache exact.
        """
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(0)  # epoch-invariant eval stream (see above)
        # device scalars are collected and fetched once after the loop
        losses = []
        if phase == "pretrain":
            for i, np_batch in enumerate(loader):
                batch = self._device_batch(np_batch)
                losses.append(eval_step(state, batch, seed, i)["loss_rec"])
            return ({"loss_rec": _host_mean(losses)} if losses else {}), None

        metric_states = init_metric_states(self.model.head_specs, self.device)
        if cache is not None and cache.ready and cache.hit_epochs == 0:
            # first replay only: one extra batch read + feature pass that
            # backstops the epoch-invariance premise
            cache.verify_replay(loader, self._device_batch)
        if cache is not None and cache.ready:
            # head-only replay: the frozen trunk (and the raster reads
            # feeding it) are skipped entirely
            cache.hit_epochs += 1
            for entry in cache.entries:
                feats = cache.features(entry, self.device)
                labels = self._device_batch(entry.labels)
                metric_states, logs = cache.head_step(state, feats, labels, metric_states)
                losses.append(logs["loss_pred"])
        else:
            for np_batch in loader:
                batch = self._device_batch(np_batch)
                if cache is not None and not cache.disabled:
                    feats = cache.feature_step(batch)
                    labels = {k: batch[k] for k in cache.label_keys}
                    metric_states, logs = cache.head_step(state, feats, labels, metric_states)
                    cache.store(feats, {k: np_batch[k] for k in cache.label_keys})
                else:
                    metric_states, logs = eval_step(state, batch, metric_states)
                losses.append(logs["loss_pred"])
            if cache is not None:
                cache.seal()
        metric_states = self._summed(metric_states)
        out: dict[str, Any] = compute_metrics(self.model.head_specs, metric_states)
        out["loss_pred"] = _host_mean(losses) if losses else 0.0
        return out, metric_states


# --------------------------------------------------------------------------
def resolve_run_handles(run) -> None:
    """Name-based checkpoint discovery (reference hydra_utils.py:17-48).

    ``run.load_name/load_phase[/load_uuid]`` resolve to the newest
    ``{phase}-epoch=N`` checkpoint under ``exp_dir/load_name[/load_uuid]``;
    same for ``fit_*``. Explicit ``*_ckpt_path`` values win.
    """
    for kind in ("load", "fit"):
        if getattr(run, f"{kind}_ckpt_path"):
            continue
        name = getattr(run, f"{kind}_name")
        if not name:
            continue
        base = Path(run.exp_dir) / name
        uid = getattr(run, f"{kind}_uuid")
        if uid:
            base = base / uid
        phase = getattr(run, f"{kind}_phase")
        path = ckpt.find_latest_checkpoint(base, phase)
        if path is None:
            msg = (
                f"run.{kind}_name={name!r}: no '{phase}-epoch=*' checkpoint "
                f"found under {base}"
            )
            raise FileNotFoundError(msg)
        setattr(run, f"{kind}_ckpt_path", str(path))
        log.info("resolved run.%s_name=%s -> %s", kind, name, path)


def run_experiment(
    cfg: ExperimentConfig,
    datasets: DatasetsConfig,
    workdir: str | Path | None = None,
    *,
    device="cuda",
) -> dict[str, PhaseResult]:
    """Sequence pretrain -> probe -> finetune (reference run_experiment.py)
    on ``device`` (a CUDA device unless the caller asks for another).  The
    SIGTERM / SIGINT handlers are the run's while it lasts."""
    resolve_device(device)
    handlers = preempt.install_handlers()  # SIGTERM/SIGINT -> checkpoint + clean exit
    try:
        return _run_experiment(cfg, datasets, workdir, device)
    finally:
        preempt.restore_handlers(handlers)


def _run_experiment(cfg, datasets, workdir, device) -> dict[str, PhaseResult]:
    from maestro_tpu_torch.data.loader import pin_loader

    resolve_run_handles(cfg.run)
    pin_loader(cfg.data)  # one loader per run, recorded in checkpoint meta

    workdir = Path(workdir or Path(cfg.run.exp_dir) / cfg.run.exp_name)
    exp = Experiment(cfg, datasets, workdir, device=device)

    # warm start from a previous experiment's weights (applied at first init)
    if cfg.run.load_ckpt_path:
        if exp._warm_start:
            msg = (
                "both run.load_ckpt_path and model.pretrained_path are set; "
                "pick one warm-start source"
            )
            raise ValueError(msg)
        exp._warm_start = cfg.run.load_ckpt_path

    results: dict[str, PhaseResult] = {}
    phase_opts = (
        ("pretrain", cfg.opt_pretrain),
        ("probe", cfg.opt_probe),
        ("finetune", cfg.opt_finetune),
    )
    try:
        _run_phases(cfg, datasets, exp, phase_opts, results)
    finally:
        exp.close()  # external trackers: one session per run
    return results


def _run_phases(cfg, datasets, exp, phase_opts, results) -> None:
    from maestro_tpu_torch.data.loader import make_loaders

    for phase, opt in phase_opts:
        if opt.epochs <= 0:
            continue
        if phase != "pretrain" and not datasets.dataset.targets:
            continue  # pretrain-only datasets (S2-NAIP)
        if phase == "pretrain" and exp.is_baseline:
            continue  # baseline adapters only probe/finetune
        # opt.batch_size is per data-parallel shard; each process loads its shard
        index, count = exp.batch_shard()
        loaders = make_loaders(datasets, cfg.data, phase, opt.batch_size, seed=cfg.run.seed,
                               shard_index=index, shard_count=count)
        resume = (
            cfg.run.fit_ckpt_path
            if cfg.run.fit_ckpt_path and cfg.run.fit_phase == phase
            else None
        )
        try:
            results[phase] = exp.fit_phase(
                phase, opt, loaders["train"], loaders["val"], loaders["test"],
                resume_path=resume,
            )
        except preempt.Preempted as p:
            log.warning(
                "%s — resume with run.fit_name=%s run.fit_phase=%s",
                p, cfg.run.exp_name, phase,
            )
            break
        finally:
            # saver thread + TB writer; re-created lazily per phase.
            # Trackers stay open across phases (closed by run_experiment).
            exp.close(trackers=False)
            for loader in loaders.values():  # the worker processes, if any
                if hasattr(loader, "close"):
                    loader.close()


# --------------------------------------------------------------------------
def _host_mean(values: list[torch.Tensor]) -> float:
    """Mean of device scalars, read back in one transfer (the float64 mean
    of their float32 values, as the JAX runtime takes it)."""
    host = torch.stack([v.detach().float().reshape(()) for v in values]).cpu().numpy()
    return float(np.mean([float(v) for v in host]))


def _flat_metrics(metrics: dict) -> dict[str, float]:
    out = {}
    for k, v in metrics.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                out[f"{k}/{k2}"] = float(v2)
        elif isinstance(v, (int, float)):
            out[k] = float(v)
    return out


def _lookup_monitor(
    val_logs: dict, monitor: str, phase: str | None = None,
) -> float | None:
    """Resolve a monitor name against the val metrics, accepting every
    spelling the reference ecosystem uses: the bare ``target/metric``, the
    reference's documented ``..._val`` form (conf/opt.py:43-45), Lightning's
    phase-prefixed ``{phase}_{monitor}`` (train/trainer.py:94-110), and a
    ``_test`` suffix."""
    flat = _flat_metrics(val_logs)
    name = monitor
    if phase and name.startswith(f"{phase}_"):
        name = name[len(phase) + 1 :]
    candidates = [monitor, name]
    for suffix in ("_val", "_test"):
        if name.endswith(suffix):
            candidates.append(name.removesuffix(suffix))
    for cand in candidates:
        if cand in flat:
            return flat[cand]
    return None
