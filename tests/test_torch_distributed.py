"""The port's multi-process layer (``maestro_tpu_torch/parallel/distributed.py``,
the loaders' shards, the runtime and the CLI over several processes).

The two-process run is the port's counterpart of
tests/test_two_process_distributed.py: a probe phase on the TreeSatAI
fixture in two real processes (one gloo group through a ``file://`` store,
``tests/_torch_dist_worker.py``, no JAX there) against one process of the
port, at that test's tolerances (rtol 2e-3 / atol 1e-5): process p reads
``order[p::2]`` with half the batch, so every global batch holds the samples
of the one-process batch, and the probe's losses and metric sums do not
depend on their order.  Process 0 alone writes TensorBoard,
``metrics.jsonl``, ``meta.json`` and checkpoints; both share its run uuid.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch.distributed as dist

from maestro_tpu_torch.data.loader import EOBatchLoader, epoch_batches
from maestro_tpu_torch.parallel import distributed as D
from tests.fixtures import write_treesat_fixture

from _torch_dist_worker import by_job, job, launch, session_shared

LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                 "TORCHELASTIC_RUN_ID")


@pytest.fixture
def no_launcher(monkeypatch):
    for var in LAUNCHER_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_one_process_needs_no_group(no_launcher):
    """Without a launcher, or with ``WORLD_SIZE=1`` and no rendezvous,
    nothing is joined (the JAX package's ``num_processes <= 1`` return); the
    helpers read one process."""
    assert not D.launched()
    assert D.initialize_distributed("cpu") is False
    no_launcher.setenv("WORLD_SIZE", "1")
    assert D.initialize_distributed("cpu") is False and not dist.is_initialized()
    assert (D.process_index(), D.process_count(), D.is_primary()) == (0, 1, True)
    assert D.local_batch_slice(8) == 8
    assert D.broadcast_object({"uuid": "ab"}) == {"uuid": "ab"}


def test_launcher_without_rendezvous_raises(no_launcher):
    no_launcher.setenv("WORLD_SIZE", "3")
    assert D.process_count() == 3
    with pytest.raises(ValueError, match="global batch 8 not divisible by 3 processes"):
        D.local_batch_slice(8)
    with pytest.raises(RuntimeError, match="WORLD_SIZE=3 but no rendezvous: MASTER_ADDR"):
        D.initialize_distributed("cpu")


@pytest.mark.parametrize("env", [
    {"WORLD_SIZE": "1", "MASTER_ADDR": "localhost", "MASTER_PORT": "0"},
    {"TORCHELASTIC_RUN_ID": "none", "MASTER_ADDR": "localhost", "MASTER_PORT": "0"},
], ids=["env", "torchrun"])
def test_launcher_of_one_process_joins_a_group_of_one(no_launcher, env):
    """A launcher's one process (its variables, or torchrun's run id) joins
    a group of one over ``env://``, so the mesh and FSDP are built as for
    several processes."""
    for key, value in env.items():
        no_launcher.setenv(key, value)
    assert D.launched()
    assert D.initialize_distributed("cpu")
    try:
        assert dist.get_world_size() == 1 and D.process_count() == 1 and D.is_primary()
    finally:
        dist.destroy_process_group()


def test_explicit_rendezvous_and_existing_group(tmp_path, no_launcher):
    """An ``init_method`` joins even a group of one, on gloo for the CPU; a
    second call finds the group and does nothing."""
    assert D.initialize_distributed("cpu", init_method=f"file://{tmp_path / 'store'}",
                                    world_size=1, rank=0)
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert D.initialize_distributed("cpu") is False
    finally:
        dist.destroy_process_group()


class _Indices:
    """A dataset whose sample i is its own index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


@pytest.mark.parametrize("count", [2, 3])
def test_loader_shards_are_disjoint_and_cover(count):
    """Process p reads ``order[p::count]``: the shards are disjoint, each has
    the same number of batches, and global batch j holds the samples of the
    one-process batch j of ``count`` times the size."""
    n, b, seed, epoch = 23, 2, 7, 1
    order = np.concatenate(epoch_batches(n, 1, True, False, seed, epoch))
    shards = [epoch_batches(n, b, True, True, seed, epoch, p, count) for p in range(count)]
    assert len({len(s) for s in shards}) == 1
    flat = [np.concatenate(s) for s in shards]
    assert len(set(np.concatenate(flat))) == sum(len(f) for f in flat)
    for p in range(count):
        np.testing.assert_array_equal(flat[p], order[p::count][: len(flat[p])])
    one = epoch_batches(n, count * b, True, True, seed, epoch)
    for j in range(len(shards[0])):
        assert set(np.concatenate([s[j] for s in shards])) == set(one[j])
    loader = EOBatchLoader(_Indices(n), b, num_workers=1, seed=seed, shard_index=count - 1,
                           shard_count=count)
    loader.set_epoch(epoch)
    assert len(loader) == len(shards[-1])
    got = [batch["i"] for batch in loader]
    assert all(np.array_equal(g, w) for g, w in zip(got, shards[-1], strict=True))


def _argv(root, exp_dir, batch, *extra):
    return [
        f"datasets.root_dir={root}", "datasets.name_dataset=treesatai_ts",
        "datasets.treesatai_ts.rel_dir=", "model.model_size=micro", "model.inter_depth=1",
        "data.num_workers=2", "data.loader=threads", "data.use_transform=false",
        "data.random_dates=false", "trainer.compute_dtype=float32",
        "trainer.probe_eval_cache=false", f"run.exp_dir={exp_dir}", "run.exp_name=runs",
        "run.seed=7", "run.logged_images_per_epoch=1",
        f"opt_pretrain.batch_size={batch}", f"opt_probe.batch_size={batch}",
        f"opt_finetune.batch_size={batch}", *extra,
    ]


PROBE = ("opt_pretrain.epochs=0", "opt_probe.epochs=2", "opt_finetune.epochs=0",
         "model.use_ema=false")
FSDP = ("opt_pretrain.epochs=1", "opt_probe.epochs=0", "opt_finetune.epochs=2",
        "model.use_ema=true")
# a launcher's variables for one process (torchrun --nproc_per_node=1 sets
# these); port 0: the store takes a free one
ONE_PROCESS_LAUNCHER = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
                        "MASTER_ADDR": "localhost", "MASTER_PORT": "0"}


def _runs(root) -> dict:
    """The CLI runs of this file, in one launch of 3 processes: the
    two-process probe beside the one-process one, then FSDP under a
    launcher's one process beside the plain run."""
    data = root / "treesat8"
    write_treesat_fixture(data, num_tiles=8)
    d = {name: root / name for name in ("two", "one", "fsdp", "plain")}
    rounds = [
        [job("experiment", (0, 1), "two", argv=_argv(data, d["two"], 1, *PROBE),
             exp_dir=str(d["two"] / "runs")),
         job("experiment", (2,), "one", group=False, argv=_argv(data, d["one"], 2, *PROBE),
             exp_dir=str(d["one"] / "runs"))],
        [job("experiment", (0,), "fsdp", group=False, env=ONE_PROCESS_LAUNCHER,
             argv=_argv(data, d["fsdp"], 2, *FSDP, "trainer.fsdp=true"),
             exp_dir=str(d["fsdp"] / "runs")),
         job("experiment", (1,), "plain", group=False, argv=_argv(data, d["plain"], 2, *FSDP),
             exp_dir=str(d["plain"] / "runs"))],
    ]
    runs = by_job(launch("rounds", 3, root, {"rounds": rounds}, group=False))
    return {"runs": runs, "dirs": d}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The CLI runs of this file, computed once a session."""
    return session_shared(tmp_path_factory, "torch_distributed_cli_runs", _runs)


def _assert_phase_close(got: dict, want: dict, rtol: float, atol: float) -> None:
    assert len(got["history"]) == len(want["history"]) > 0
    for g, w in zip(got["history"], want["history"]):
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        keys = [k for k in w if k.startswith(("train/loss", "val/"))]
        assert keys
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)
    for stage in ("val", "test"):
        assert set(got[stage]) == set(want[stage])
        for k, v in want[stage].items():
            np.testing.assert_allclose(got[stage][k], v, rtol=rtol, atol=atol,
                                       err_msg=f"{stage} {k}")


def test_two_process_probe_matches_one_process(cli_runs):
    two, one = cli_runs["runs"]["two"], cli_runs["runs"]["one"][0]["phases"]
    two_dir, one_dir = cli_runs["dirs"]["two"], cli_runs["dirs"]["one"]
    assert [r["processes"] for r in two] == [2, 2]
    assert not any(r["jax_loaded"] for r in two)
    for r in two:
        _assert_phase_close(r["phases"]["probe"], one["probe"], rtol=2e-3, atol=1e-5)
    # one run directory (process 0's uuid), written by process 0 alone
    assert two[0]["run_dirs"] == two[1]["run_dirs"] and len(two[0]["run_dirs"]) == 1
    work = two_dir / "runs" / two[0]["run_dirs"][0]
    one_work = next((one_dir / "runs").iterdir())
    assert len(list((work / "tb").iterdir())) == 1
    lines = (work / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == len((one_work / "metrics.jsonl").read_text().splitlines())
    assert json.loads(lines[0])["phase"] == "probe"
    assert json.loads((work / "config_resolved.json").read_text())["experiment"]["data"][
        "loader"] == "threads"
    ckpts = sorted(p.name for p in (work / "checkpoints").iterdir())
    assert ckpts == sorted(p.name for p in (one_work / "checkpoints").iterdir())
    meta = json.loads((work / "checkpoints" / ckpts[-1] / "meta.json").read_text())
    assert meta["phase"] == "probe"
    assert meta["parallel"]["mesh"] == {"data": 2, "model": 1}
    assert sorted(p.name for p in (work / "cm").iterdir()) == sorted(
        p.name for p in (one_work / "cm").iterdir())


def test_fsdp_on_one_rank_matches_the_plain_run(cli_runs):
    """``trainer.fsdp=true`` in one process started by a launcher (its
    variables set, as ``torchrun --nproc_per_node=1`` sets them): the run
    joins a group of one, shards the model under FSDP2 (a unit per block and
    head, EMA weights swapped into its shards for finetune eval, checkpoints
    gathered whole, test on the best) and trains as the plain process does;
    its checkpoints record the placement."""
    got = cli_runs["runs"]["fsdp"][0]
    want = cli_runs["runs"]["plain"][0]["phases"]
    assert got["processes"] == 1 and not got["jax_loaded"]
    assert set(got["phases"]) == set(want) == {"pretrain", "finetune"}
    for phase in want:
        _assert_phase_close(got["phases"][phase], want[phase], rtol=1e-5, atol=1e-7)
    work = cli_runs["dirs"]["fsdp"] / "runs" / got["run_dirs"][0]
    metas = [json.loads(p.read_text()) for p in (work / "checkpoints").glob("*/meta.json")]
    assert len(metas) == 3
    for meta in metas:
        placed = meta["parallel"]
        assert placed["mesh"] == {"data": 1, "model": 1} and placed["processes"] == 1
        assert placed["fsdp"] and placed["fsdp_units"] > 2
        assert placed["sharded_parameters"] == placed["parameters"] > 100
    plain = cli_runs["dirs"]["plain"] / "runs" / cli_runs["runs"]["plain"][0]["run_dirs"][0]
    assert all("parallel" not in json.loads(p.read_text())
               for p in (plain / "checkpoints").glob("*/meta.json"))
