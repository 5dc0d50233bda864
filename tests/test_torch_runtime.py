"""Slice 7 of the port as a whole: ``maestro_tpu_torch.train.runtime``
(``run_experiment``: pretrain -> probe -> finetune from tiles on disk) and
its CLI ``maestro_tpu_torch.main``, on the CPU.

The parity test runs the JAX package's ``run_experiment`` once (TreeSatAI-TS
fixture, ``micro``, group fusion, one trunk block, fp32; pretrain 1 epoch,
probe 2, finetune 2 with a monitor) and the port's over the same tiles.  The
JAX initial parameters of each phase are recorded around its
``Experiment.init_params`` and carried into the port's model through
``port.from_jax.load_jax_params`` (the leaves a phase adds: everything at
pretrain, the heads at probe); the JAX package's mask draws are recorded
(``jax.debug.callback``, ordered) and replayed through the port's
``ops.masking.draw_masks``.  Every history entry (losses, train and val
metrics, lr), the best epochs and the test metrics must agree.

The rest runs the port alone: warm start by ``run.load_name``, resume by
``run.fit_name`` after a SIGTERM mid-epoch (bit-identical to an
uninterrupted run), ``run.eval_only``, the ``trainer.input_dtype`` staging
matrix (tests/test_input_staging.py's), ``parse_cli`` against the root
``main.py``'s, the knobs that are not ported, the CUDA default of every
entry point, the refusal to resume under another loader, a DINOv2 adapter
through probe and finetune, and the CLI end to end with its files (config,
metrics.jsonl, confusion matrices, TensorBoard events with images).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import struct
import sys
from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import maestro_tpu.conf as JC
import maestro_tpu.models.mae as JM
import maestro_tpu.train.runtime as JR
import maestro_tpu_torch.conf as TC
import maestro_tpu_torch.train.runtime as TR
from maestro_tpu_torch import main as tmain
from maestro_tpu_torch.ops import masking as TMK
from maestro_tpu_torch.scripts import export_model
from maestro_tpu_torch.port.from_jax import load_jax_params
from maestro_tpu_torch.train import checkpoint as ckpt
from maestro_tpu_torch.train import preempt
from maestro_tpu_torch.utils.testing import make_synthetic_batch
from tests.fixtures import REPO_ROOT, write_treesat_fixture

from _torch_port_utils import single_thread_torch  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")

RTOL = 1e-4  # history, test metrics (fp32 on both sides; observed 4e-7)
LR_ABS = 1e-7
LR_F32_ULPS = 4  # the JAX package evaluates the schedule in float32 (observed 2.3 ulps)


@pytest.fixture(scope="module")
def treesat_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("treesat_runtime")
    write_treesat_fixture(root, num_tiles=4)
    return root


def _config(C, root, exp_dir, name, *, pretrain=1, probe=2, finetune=2, images=0, **run):
    datasets = C.DatasetsConfig(root_dir=str(root), name_dataset="treesatai_ts")
    datasets.treesatai_ts.rel_dir = ""
    cfg = C.ExperimentConfig(
        run=C.RunConfig(exp_dir=str(exp_dir), exp_name=name, seed=0,
                        logged_images_per_epoch=images, **run),
        opt_pretrain=C.OptPretrainConfig(epochs=pretrain, batch_size=2),
        opt_probe=C.OptProbeConfig(epochs=probe, batch_size=2),
        opt_finetune=C.OptFinetuneConfig(epochs=finetune, batch_size=2,
                                         monitor="treesat_mlc_thresh/weighted_f1_val"),
        data=C.DataConfig(num_workers=2, loader="threads"),
        model=C.ModelConfig(model_size="micro", fusion_mode="group", inter_depth=1,
                            use_ema=True),
        trainer=C.TrainerConfig(mesh_data=1, compute_dtype="float32"),
    )
    return cfg, datasets


# --------------------------------------------------------------------------
# the JAX package's run, recorded
# --------------------------------------------------------------------------
class JaxRecorder:
    """Records the JAX package's mask draws of every executed pretrain
    forward (ordered callbacks: a structural mask, then each stream's
    shuffle noise) and the parameters each phase's ``init_params`` returns;
    the draws of ``init_params``'s own forward are not kept."""

    def __init__(self, mp: pytest.MonkeyPatch):
        self.draws: list[tuple[dict, dict]] = []
        self.inits: dict[str, dict] = {}
        self._paused = False
        self._stream = 0
        orig_struct, orig_shuffle = JM.structural_mask, JM.shuffle_mask
        orig_init = JR.Experiment.init_params

        def structural_mask(plan, key, batch_size):
            out = orig_struct(plan, key, batch_size)
            self._stream = 0  # index of the next shuffle_mask call (trace time)
            jax.debug.callback(self._on_struct, out, ordered=True)
            return out

        def shuffle_mask(key, x, struct, num_masked):
            noise = jax.random.uniform(key, x.shape[:2])
            jax.debug.callback(partial(self._on_noise, self._stream), noise, ordered=True)
            self._stream += 1
            return orig_shuffle(key, x, struct, num_masked)

        def init_params(exp, phase, batch, seed):
            self._paused = True
            out = orig_init(exp, phase, batch, seed)
            jax.effects_barrier()
            self._paused = False
            self.inits[phase] = jax.tree.map(np.asarray, out)["params"]
            return out

        mp.setattr(JM, "structural_mask", structural_mask)
        mp.setattr(JM, "shuffle_mask", shuffle_mask)
        mp.setattr(JR.Experiment, "init_params", init_params)

    def _on_struct(self, masks):
        if not self._paused:
            self.draws.append(({k: np.asarray(v) for k, v in masks.items()}, {}))

    def _on_noise(self, index, noise):
        if not self._paused:
            self.draws[-1][1][index] = np.asarray(noise)


@pytest.fixture(scope="module")
def jax_run(treesat_root, tmp_path_factory):
    exp_dir = tmp_path_factory.mktemp("jax_runs")
    with pytest.MonkeyPatch.context() as mp:
        rec = JaxRecorder(mp)
        cfg, datasets = _config(JC, treesat_root, exp_dir, "jax")
        results = JR.run_experiment(cfg, datasets, exp_dir / "work")
        jax.effects_barrier()
    return results, rec


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflatten(items) -> dict:
    out: dict = {}
    for path, v in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _carry_jax_inits(mp, rec: JaxRecorder) -> None:
    """The port's init_params, then the JAX leaves the phase adds."""
    seen: set = set()
    orig = TR.Experiment.init_params

    def init_params(exp, phase):
        orig(exp, phase)
        items = [(p, v) for p, v in _flatten(rec.inits[phase]) if p not in seen]
        seen.update(p for p, _ in items)
        if items:
            names = tuple(n for n, _ in exp.model.named_parameters())
            load_jax_params(exp.model, _unflatten(items), missing_ok=names)

    mp.setattr(TR.Experiment, "init_params", init_params)


def _replay_masks(mp, rec: JaxRecorder):
    draws = iter(rec.draws)

    def draw_masks(plan, generator, batch_size):
        struct, noise = next(draws)
        return ({k: torch.from_numpy(np.array(v)) for k, v in struct.items()},
                {n: torch.from_numpy(np.array(noise[i])) for i, n in enumerate(plan.streams)})

    mp.setattr(TMK, "draw_masks", draw_masks)
    return draws


def _close(got: float, want: float, key: str) -> None:
    if key.endswith("lr"):
        err = abs(got - want)
        assert err <= LR_ABS and err <= LR_F32_ULPS * np.spacing(np.float32(want)), \
            (key, got, want)
    else:
        assert abs(got - want) <= RTOL * max(abs(want), 1e-12), (key, got, want)


def test_experiment_matches_jax(jax_run, treesat_root, tmp_path, monkeypatch):
    jres, rec = jax_run
    assert len(rec.draws) > 0 and set(rec.inits) == {"pretrain", "probe", "finetune"}
    _carry_jax_inits(monkeypatch, rec)
    left = _replay_masks(monkeypatch, rec)
    cfg, datasets = _config(TC, treesat_root, tmp_path, "torch")
    tres = TR.run_experiment(cfg, datasets, tmp_path / "work", device="cpu")
    assert next(left, None) is None  # every JAX draw was replayed, in order

    assert list(tres) == list(jres) == ["pretrain", "probe", "finetune"]
    compared = 0
    for phase, want in jres.items():
        got = tres[phase]
        assert (got.epochs_run, got.best_epoch) == (want.epochs_run, want.best_epoch), phase
        assert len(got.history) == len(want.history)
        for eg, ew in zip(got.history, want.history):
            keys = sorted(k for k in ew if k != "time_s")
            assert keys == sorted(k for k in eg if k != "time_s"), phase
            for k in keys:
                _close(eg[k], ew[k], f"{phase} {ew['epoch']} {k}")
                compared += 1
        assert sorted(got.test_metrics) == sorted(want.test_metrics) and want.test_metrics
        for k, v in want.test_metrics.items():
            _close(got.test_metrics[k], v, f"{phase} test {k}")
        if want.best_monitor is not None:
            _close(got.best_monitor, want.best_monitor, f"{phase} best_monitor")
    assert compared > 40


# --------------------------------------------------------------------------
# the port alone
# --------------------------------------------------------------------------
def test_warm_start_by_load_name(treesat_root, tmp_path):
    """load_name resolves to the newest checkpoint of load_phase; the first
    phase's parameters (backbone and heads here) come from it, strict=False,
    and nothing else is read from it."""
    cfg, datasets = _config(TC, treesat_root, tmp_path, "src", pretrain=1, probe=1, finetune=0)
    TR.run_experiment(cfg, datasets, tmp_path / "src", device="cpu")
    src = ckpt.find_latest_checkpoint(tmp_path / "src", "probe")
    saved = torch.load(src / "state" / ckpt.PAYLOAD, weights_only=True)["params"]

    cfg2, _ = _config(TC, treesat_root, tmp_path, "dst", pretrain=0, probe=1, finetune=0,
                      load_name="src", load_phase="probe")
    loaded = {}
    orig = TR.Experiment.init_params

    def spy(exp, phase):
        orig(exp, phase)
        loaded[phase] = {n: p.detach().clone()
                         for n, p in TR.phase_params(exp.model, phase).items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TR.Experiment, "init_params", spy)
        res = TR.run_experiment(cfg2, datasets, tmp_path / "dst", device="cpu")
    assert cfg2.run.load_ckpt_path == str(src)
    assert any(n.startswith("heads.") for n in loaded["probe"])
    for name, value in loaded["probe"].items():
        assert torch.equal(value, saved[name]), name
    assert res["probe"].history and np.isfinite(res["probe"].history[0]["train/loss_pred"])


class _SigtermAfter:
    """A train loader that delivers a real SIGTERM after n batches."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            yield batch
            if i + 1 == self.n:
                os.kill(os.getpid(), signal.SIGTERM)


def test_resume_after_sigterm_is_bit_identical(treesat_root, tmp_path):
    """SIGTERM mid-epoch: a checkpoint marked interrupted with batches_done;
    run.fit_name resumes it (fast-forwarding the loader), and the finished
    phase is bit-identical to an uninterrupted run."""
    from maestro_tpu_torch.data.loader import make_loader

    cfg, datasets = _config(TC, treesat_root, tmp_path, "full", pretrain=2, probe=0, finetune=0)
    full = TR.run_experiment(cfg, datasets, tmp_path / "full", device="cpu")["pretrain"]
    full_state = torch.load(ckpt.find_latest_checkpoint(tmp_path / "full", "pretrain")
                            / "state" / ckpt.PAYLOAD, weights_only=True)

    preempt.reset()
    preempt.install_handlers()
    cfg, datasets = _config(TC, treesat_root, tmp_path, "cut", pretrain=2, probe=0, finetune=0)
    exp = TR.Experiment(cfg, datasets, tmp_path / "cut", device="cpu")
    _, loader = make_loader(datasets, cfg.data, "train", "pretrain", 2, seed=0)
    try:
        with pytest.raises(preempt.Preempted):
            exp.fit_phase("pretrain", cfg.opt_pretrain, _SigtermAfter(loader, 1))
    finally:
        exp.close()
        preempt.reset()
    path = ckpt.find_latest_checkpoint(tmp_path / "cut", "pretrain")
    meta = ckpt.load_meta(path)
    assert meta["interrupted"] is True and meta["epoch"] == 0 and meta["batches_done"] == 1
    assert meta["loader"] == "threads"

    cfg, datasets = _config(TC, treesat_root, tmp_path, "resumed", pretrain=2, probe=0,
                            finetune=0, fit_name="cut", fit_phase="pretrain")
    res = TR.run_experiment(cfg, datasets, tmp_path / "cut", device="cpu")["pretrain"]
    assert [e["epoch"] for e in res.history] == [0, 1]
    assert res.history[1]["train/loss_rec"] == full.history[1]["train/loss_rec"]
    assert res.history[1]["val/loss_rec"] == full.history[1]["val/loss_rec"]
    got = torch.load(ckpt.find_latest_checkpoint(tmp_path / "cut", "pretrain")
                     / "state" / ckpt.PAYLOAD, weights_only=True)
    assert got["step"] == full_state["step"]
    for group in ("params", "ema_params"):
        for n, v in full_state[group].items():
            assert torch.equal(got[group][n], v), (group, n)
    for n, moments in full_state["opt_state"]["moments"].items():
        for k, v in moments.items():
            assert torch.equal(got["opt_state"]["moments"][n][k], v), (n, k)


def test_preempt_handlers_come_back_and_are_restored():
    """The port's SIGTERM/SIGINT handlers are installed again when other code
    in the process has taken the signals since (a stop signal would reach
    that code's handler), and ``restore_handlers`` puts back what they
    replaced, as ``run_experiment`` does at its end."""
    saved = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))

    def other(signum, frame):  # another library's handler
        del signum, frame

    try:
        signal.signal(signal.SIGTERM, other)
        signal.signal(signal.SIGINT, other)
        replaced = preempt.install_handlers()
        assert replaced == (other, other)
        assert signal.getsignal(signal.SIGTERM) is signal.getsignal(signal.SIGINT) \
            is preempt._request_stop
        assert preempt.install_handlers() is None  # already the port's
        signal.signal(signal.SIGTERM, other)  # taken since
        assert preempt.install_handlers() is not None
        assert signal.getsignal(signal.SIGTERM) is preempt._request_stop
        preempt.restore_handlers(replaced)
        assert signal.getsignal(signal.SIGTERM) is signal.getsignal(signal.SIGINT) is other
    finally:
        for sig, handler in zip((signal.SIGTERM, signal.SIGINT), saved):
            signal.signal(sig, signal.SIG_DFL if handler is None else handler)


def test_resume_refuses_other_loader():
    """An interrupted checkpoint records its loader; resuming under another
    one fails loudly (the JAX package's test of the same name)."""
    meta = {"interrupted": True, "batches_done": 7, "loader": "grain"}
    with pytest.raises(ValueError, match="data.loader"):
        TR._check_resume_loader(meta, TC.DataConfig(loader="threads"))
    TR._check_resume_loader(meta, TC.DataConfig(loader="grain"))  # the same: resumes
    # a completed epoch's checkpoint has no fast-forward: any loader resumes it
    TR._check_resume_loader({"loader": "grain"}, TC.DataConfig(loader="threads"))


def test_baseline_probe_and_finetune(treesat_root, tmp_path):
    """A DINOv2 adapter through ``run_experiment`` (tests/
    test_baseline_runtime.py's run): no pretrain phase, then probe and
    finetune with layer-wise LR decay, finite losses and metrics."""
    cfg, datasets = _config(TC, treesat_root, tmp_path, "dinov2", pretrain=1, probe=1,
                            finetune=1)
    ds = datasets.treesatai_ts
    for m in ("s2", "s1_asc", "s1_des"):
        getattr(ds, m).image_size = 28
    ds.aerial.image_size = 224
    ds.__post_init__()
    cfg.model = TC.ModelConfig(model="dinov2", model_size="micro", fusion_mode="shared",
                               use_ema=False)
    cfg.opt_finetune.lw_decay = 0.75
    results = TR.run_experiment(cfg, datasets, tmp_path / "work", device="cpu")
    assert set(results) == {"probe", "finetune"}  # baselines skip pretraining
    wf1 = results["finetune"].val_metrics["treesat_mlc_thresh/weighted_f1"]
    assert 0.0 <= wf1 <= 1.0
    for phase in ("probe", "finetune"):
        assert np.isfinite(results[phase].history[0]["train/loss_pred"])
        assert np.isfinite(results[phase].val_metrics["loss_pred"])


def test_eval_only_scores_a_checkpoint(treesat_root, tmp_path):
    """eval_only scores the loaded weights without training: the probe test
    metrics of a run equal those of an eval-only run over its checkpoint."""
    cfg, datasets = _config(TC, treesat_root, tmp_path, "run", pretrain=0, probe=1, finetune=0)
    ran = TR.run_experiment(cfg, datasets, tmp_path / "run", device="cpu")["probe"]
    cfg2, _ = _config(TC, treesat_root, tmp_path, "ev", pretrain=0, probe=1, finetune=0,
                      load_name="run", load_phase="probe", eval_only=True)
    ev = TR.run_experiment(cfg2, datasets, tmp_path / "ev", device="cpu")["probe"]
    assert ev.epochs_run == 0 and not ev.history
    assert ev.test_metrics == ran.test_metrics
    assert ev.val_metrics == ran.val_metrics
    assert json.loads((tmp_path / "ev" / "metrics.jsonl").read_text().splitlines()[-1])[
        "eval_only"] is True


@pytest.mark.parametrize(
    ("input_dtype", "compute", "phase", "expect_bf16"),
    [
        ("auto", "bfloat16", "finetune", True),
        ("auto", "bfloat16", "probe", True),
        ("auto", "bfloat16", "pretrain", False),  # inputs are loss targets
        ("auto", "float32", "finetune", False),
        ("float32", "bfloat16", "finetune", False),
        ("bfloat16", "bfloat16", "pretrain", True),  # explicit forces it
    ],
)
def test_staging_dtype_matrix(tmp_path, input_dtype, compute, phase, expect_bf16):
    datasets = TC.DatasetsConfig(name_dataset="treesatai_ts")
    cfg = TC.ExperimentConfig(
        run=TC.RunConfig(exp_dir=str(tmp_path), exp_name="stage", seed=0),
        model=TC.ModelConfig(model_size="micro", fusion_mode="group", inter_depth=1,
                             use_ema=False),
        trainer=TC.TrainerConfig(mesh_data=1, compute_dtype=compute, input_dtype=input_dtype),
    )
    exp = TR.Experiment(cfg, datasets, tmp_path / "work", device="cpu")
    exp._staging_phase = phase
    batch = make_synthetic_batch(datasets.dataset, 2)
    out = exp._device_batch(batch)
    floats = ints = 0
    for k, v in batch.items():
        if v.dtype == np.float32:
            floats += 1
            assert out[k].dtype == (torch.bfloat16 if expect_bf16 else torch.float32), k
            np.testing.assert_array_equal(out[k].float().numpy(),
                                          torch.from_numpy(v).to(out[k].dtype).float().numpy())
        else:
            ints += 1
            assert out[k].dtype == torch.from_numpy(v).dtype, k
            np.testing.assert_array_equal(out[k].numpy(), v)
    assert floats > 0 and ints > 0


def test_bf16_staged_probe_trains_finite(treesat_root, tmp_path):
    cfg, datasets = _config(TC, treesat_root, tmp_path, "bf16", pretrain=0, probe=1, finetune=0)
    cfg.trainer.compute_dtype = "bfloat16"
    res = TR.run_experiment(cfg, datasets, tmp_path / "bf16", device="cpu")["probe"]
    assert res.history and all(np.isfinite(v) for v in res.val_metrics.values())


ARGVS = [
    [],
    ["datasets.name_dataset=flair", "model.model_size=medium", "model.fusion_mode=group",
     "opt_finetune.monitor=cosia/average_iou_val", "trainer.remat=dots",
     "opt_probe.epochs=3", "run.seed=7", "data.loader=threads", "trainer.input_dtype=auto"],
    ["datasets.root_dir=/data", "datasets.name_dataset=pastis_hd", "datasets.pastis_hd.fold=2",
     "model.encoder_heads=12", "model.encoder_dim_head=64", "opt_finetune.lw_decay=0.75",
     "opt_finetune.patience=none", "trainer.probe_eval_cache=false",
     "trainer.probe_eval_cache_gb=0.5", "run.load_name=prev", "model.use_ema=False"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["defaults", "flair", "pastis"])
def test_parse_cli_matches_root_main(argv):
    sys.path.insert(0, str(REPO_ROOT))
    try:
        import main as jmain
    finally:
        sys.path.remove(str(REPO_ROOT))
    jcfg, jds = jmain.parse_cli(list(argv))
    tcfg, tds = tmain.parse_cli(list(argv))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tds.root_dir, tds.name_dataset) == (jds.root_dir, jds.name_dataset)
    assert dataclasses.asdict(tds.dataset) == dataclasses.asdict(jds.dataset)
    with pytest.raises(SystemExit):
        tmain.parse_cli(["trainer.no_such_field=1"])


@pytest.mark.parametrize(("override", "error", "match"), [
    # the one knob left unported (CUDA graphs)
    ("trainer.steps_per_dispatch=2", NotImplementedError, r"ROADMAP.md queue 1 item 7"),
    # the mesh over one process: the JAX package's make_mesh errors
    ("trainer.mesh_data=2", ValueError, r"needs 2 devices but only 1"),
    ("trainer.mesh_model=2", ValueError, r"1 devices not divisible into 1 replicas x model axis 2"),
    ("trainer.mesh_replica=2", ValueError, r"1 devices not divisible into 2 replicas"),
    # FSDP over one process shards nothing (the JAX package's data axis of 1)
    ("trainer.fsdp=true", None, None),
    # a launcher's second process without a rendezvous
    ("WORLD_SIZE=2", RuntimeError, r"WORLD_SIZE=2 but no rendezvous: MASTER_ADDR, MASTER_PORT"),
])
def test_unported_knobs_raise(tmp_path, monkeypatch, override, error, match):
    """Only ``trainer.steps_per_dispatch > 1`` is refused as not ported; the
    parallelism knobs run, and refuse only what one process cannot hold."""
    argv = ["model.model_size=micro", "model.inter_depth=1"]
    if override.startswith("WORLD_SIZE="):
        monkeypatch.setenv("WORLD_SIZE", override.split("=")[1])
        monkeypatch.delenv("MASTER_ADDR", raising=False)
        monkeypatch.delenv("MASTER_PORT", raising=False)
    else:
        argv.append(override)
    cfg, datasets = tmain.parse_cli(argv)
    if error is None:
        exp = TR.Experiment(cfg, datasets, tmp_path, device="cpu")
        assert exp.mesh is None and exp.batch_shard() == (0, 1)
        tx_cfg = TC.OptPretrainConfig(epochs=1, batch_size=2)
        batch = make_synthetic_batch(datasets.dataset, 2)
        res = exp.fit_phase("pretrain", tx_cfg, [batch])
        assert res.epochs_run == 1 and np.isfinite(res.history[0]["train/loss_rec"])
        return
    with pytest.raises(error, match=match):
        TR.Experiment(cfg, datasets, tmp_path, device="cpu")


def test_entry_points_default_to_cuda(tmp_path):
    """On a host without CUDA every entry point refuses to run unless asked
    for the CPU."""
    assert not torch.cuda.is_available()
    cfg, datasets = tmain.parse_cli([f"run.exp_dir={tmp_path}", "model.model_size=micro"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.run_experiment(cfg, datasets, tmp_path / "w")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.Experiment(cfg, datasets, tmp_path / "w")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmain.main([f"run.exp_dir={tmp_path}", "model.model_size=micro"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_model.main([str(tmp_path / "model.pt2"), "model.model_size=micro"])
    assert not list(tmp_path.iterdir())  # nothing was written


def _tb_records(path: Path) -> list[bytes]:
    data, off, out = path.read_bytes(), 0, []
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        out.append(data[off + 12: off + 12 + length])
        off += 12 + length + 4
    return out


def test_cli_end_to_end(treesat_root, tmp_path):
    """``maestro_tpu_torch.main.main`` over the fixture: three phases, the
    resolved config, metrics.jsonl, confusion matrices, checkpoints, and
    TensorBoard events holding scalars and images."""
    argv = [f"datasets.root_dir={treesat_root}", "datasets.name_dataset=treesatai_ts",
            "datasets.treesatai_ts.rel_dir=", "model.model_size=micro",
            "model.fusion_mode=group", "model.inter_depth=1", "opt_pretrain.epochs=1",
            "opt_pretrain.batch_size=2", "opt_probe.epochs=1", "opt_probe.batch_size=2",
            "opt_finetune.epochs=1", "opt_finetune.batch_size=2", "data.num_workers=2",
            "trainer.compute_dtype=float32", f"run.exp_dir={tmp_path}", "run.exp_name=cli",
            "run.logged_images_per_epoch=1"]
    results = tmain.main(argv, device="cpu")
    assert list(results) == ["pretrain", "probe", "finetune"]
    (workdir,) = (tmp_path / "cli").iterdir()
    resolved = json.loads((workdir / "config_resolved.json").read_text())
    assert resolved["experiment"]["data"]["loader"] == "threads"
    records = [json.loads(x) for x in (workdir / "metrics.jsonl").read_text().splitlines()]
    assert [r["phase"] for r in records] == ["pretrain", "probe", "finetune"]
    assert np.isfinite(records[0]["train/loss_rec"]) and np.isfinite(records[2]["val/loss_pred"])
    assert len(list((workdir / "cm").glob("*.npy"))) == 4  # probe and finetune, val and test
    for phase in results:
        assert ckpt.find_latest_checkpoint(workdir / "checkpoints", phase) is not None

    from tensorboardX.proto.event_pb2 import Event

    tags = {v.tag: v for f in (workdir / "tb").glob("events.out.tfevents.*")
            for r in _tb_records(f)[1:] for v in Event.FromString(r).summary.value}
    assert "pretrain_train/loss_rec" in tags and "finetune_lr" in tags
    images = [v for t, v in tags.items() if "pretrain_val/aerial_rec" in t]
    assert images and images[0].image.encoded_image_string.startswith(b"\x89PNG")


def test_segmentation_images_are_drawn(tmp_path):
    """The seg head's per-epoch images (prediction and target overlays), the
    target a float32 label raster as the loader emits it.  The JAX package's
    ``_categorical_colors`` raises for every class count (its per-row
    conditions do not broadcast against the RGB choices) and its
    ``seg_overlay`` indexes colors with the float labels, so its runtime
    logs "image logging failed" instead; the port draws them."""
    from maestro_tpu.train import logging as JL
    from maestro_tpu_torch.train import logging as TL
    from maestro_tpu_torch.utils.tb import SummaryWriter

    with pytest.raises(ValueError, match="broadcast"):
        JL._categorical_colors(15)
    with pytest.raises(IndexError):  # the JAX overlay with the colors repaired
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JL, "_categorical_colors", TL._categorical_colors)
            JL.seg_overlay(np.zeros((3, 8, 8)), np.zeros((8, 8), np.float32), 15)
    colors = TL._categorical_colors(15)
    assert colors.shape == (15, 3) and colors.min() >= 0.0 and colors.max() <= 1.0
    assert len({tuple(c) for c in colors.round(4)}) == 15
    rng = np.random.default_rng(0)
    writer = SummaryWriter(str(tmp_path))
    logger = TL.EpochImageLogger(writer, ["aerial"], images_per_epoch=1)
    logger.log_segmentation("finetune", "val", 0, "cosia", rng.random((4, 64, 64)),
                            rng.normal(size=(15, 16, 16)),
                            rng.integers(0, 15, (16, 16)).astype(np.float32), 15, -1)
    writer.close()
    (events,) = tmp_path.glob("events.out.tfevents.*")
    from tensorboardX.proto.event_pb2 import Event

    tags = [v.tag for r in _tb_records(events)[1:] for v in Event.FromString(r).summary.value]
    assert tags == ["finetune_cosia_val/pred_0", "finetune_cosia_val/target_0"]



def test_profiling_utilities(tmp_path):
    """utils/profiling.py: a torch.profiler trace file and the profiler it
    yields (no device time on the CPU), the step timer's warm-up and means
    (host clock on the CPU), and FlopCounterMode's count of one call, whose
    failure is raised."""
    from maestro_tpu_torch.utils.profiling import (StepTimer, compiled_flops,
                                                   device_busy_ms, trace)

    a, b = torch.ones(32, 64), torch.ones(64, 16)
    with trace(tmp_path / "prof") as prof:
        a @ b
    assert list((tmp_path / "prof").glob("trace_*.json"))
    assert any("mm" in e.key for e in prof.key_averages())
    assert device_busy_ms(prof) == 0.0
    timer = StepTimer(warmup=1, device="cpu")
    for _ in range(3):
        timer.start()
        a @ b
        assert timer.stop() >= 0.0
    assert len(timer._times) == 2 and timer.mean_step_s > 0
    assert timer.throughput(8) > 0 and 0 < timer.mfu(1.0, 1e30) < 1
    assert compiled_flops(torch.matmul, a, b) == 2 * 32 * 64 * 16
    with pytest.raises(ZeroDivisionError):
        compiled_flops(lambda: 1 / 0)
