"""The port's data pipeline (``maestro_tpu_torch.data``) against the JAX
package's, on the synthetic on-disk fixtures of tests/fixtures.py.

For every dataset fixture (TreeSatAI-TS, PASTIS-HD, FLAIR-HUB as ``.npy``
and as ``.tif`` stacks, S2-NAIP), every phase and every stage, two epochs
with transforms, random dates and random crops: each sample and each loader
batch is bit-identical to the JAX package's (the port reads its tables with
the standard library, the JAX package with pandas).  Then the loader's own
contract: ``set_epoch`` / ``skip_batches``, an epoch that reads each
sample once in its (seed, epoch) order, a worker exception that surfaces, an
early break that leaks no thread, worker processes that outlive an early exit
until ``close()`` and serve a phase's three splits, ``pin_loader`` ("auto" and
"grain" give the worker processes of ``data/mp_loader.py`` on a host with
few cores), and a default loader that loads no JAX, in the parent or in a
worker.  The batch comparisons run under both loaders: the thread pool and
the worker processes.
"""

from __future__ import annotations

import multiprocessing
import threading
import time
from itertools import islice

import numpy as np
import pytest

from maestro_tpu.conf import DataConfig as JDataConfig
from maestro_tpu.conf import DatasetsConfig as JDatasetsConfig
from maestro_tpu.data import datasets as JD
from maestro_tpu.data.loader import make_loader as j_make_loader
from maestro_tpu_torch.conf import DataConfig, DatasetsConfig
from maestro_tpu_torch.data import datasets as TD
from maestro_tpu_torch.data.loader import (
    EOBatchLoader,
    epoch_batches,
    make_loader,
    make_loaders,
    pin_loader,
)
from maestro_tpu_torch.data.mp_loader import ProcessBatchLoader
from tests.fixtures import (
    write_flair_fixture,
    write_pastis_fixture,
    write_s2naip_fixture,
    write_treesat_fixture,
)

FIXTURES = {
    "treesat": ("treesatai_ts", write_treesat_fixture, {"num_tiles": 3}),
    "pastis": ("pastis_hd", write_pastis_fixture, {"num_tiles": 1}),
    "flair_npy": ("flair", write_flair_fixture, {"num_tiles": 2}),
    "flair_tif": ("flair", write_flair_fixture, {"num_tiles": 2, "use_tif": True}),
    "s2naip": ("s2_naip", write_s2naip_fixture, {"num_tiles": 2}),
}
PHASES = ("pretrain", "probe", "finetune")
STAGES = ("train", "val", "test")
BATCH = 2
# samples and batches compared a (stage, epoch): the crop grids repeat tiles
MAX_SAMPLES = 3
MAX_BATCHES = 2


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    out = {}
    for key, (_, write, kwargs) in FIXTURES.items():
        root = tmp_path_factory.mktemp(key)
        write(root, **kwargs)
        out[key] = root
    return out


def _configs(key, root):
    name = FIXTURES[key][0]
    pair = []
    for cls in (JDatasetsConfig, DatasetsConfig):
        cfg = cls(root_dir=str(root), name_dataset=name)
        cfg.dataset.rel_dir = ""
        pair.append(cfg)
    return pair


LOADERS = ("threads", "grain")  # the thread pool and the worker processes


def _data_cfgs(loader="threads"):
    kw = {"use_transform": True, "random_dates": True, "random_crop": True,
          "num_workers": 2}
    return JDataConfig(loader="threads", **kw), DataConfig(loader=loader, **kw)


def _assert_same(got: dict, want: dict, where: str) -> None:
    assert sorted(got) == sorted(want), where
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, f"{where} {k}"
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {k}")


# S2-NAIP is pretrain-only: it has no probe or finetune phase
CASES = [(key, phase) for key in FIXTURES for phase in PHASES
         if key != "s2naip" or phase == "pretrain"]


@pytest.mark.parametrize("loader", LOADERS)
@pytest.mark.parametrize(("key", "phase"), CASES)
def test_samples_and_batches_match_jax(roots, key, phase, loader):
    jcfg, tcfg = _configs(key, roots[key])
    jdata, tdata = _data_cfgs(loader)
    compared = 0
    for stage in STAGES:
        jds, jl = j_make_loader(jcfg, jdata, stage, phase, BATCH, seed=5)
        tds, tl = make_loader(tcfg, tdata, stage, phase, BATCH, seed=5)
        assert isinstance(tl, ProcessBatchLoader if loader == "grain" else EOBatchLoader)
        assert len(tds) == len(jds) and len(tl) == len(jl), stage
        for epoch in (0, 1):
            jds.set_epoch(epoch)
            tds.set_epoch(epoch)
            for i in range(min(len(tds), MAX_SAMPLES)):
                _assert_same(tds[i], jds[i], f"{stage} epoch {epoch} sample {i}")
                compared += 1
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            for n, (tb, jb) in enumerate(zip(islice(tl, MAX_BATCHES), islice(jl, MAX_BATCHES))):
                _assert_same(tb, jb, f"{stage} epoch {epoch} batch {n}")
        if hasattr(tl, "close"):
            tl.close()
    assert compared > 0


@pytest.mark.parametrize("key", ["treesat", "pastis", "flair_npy", "s2naip"])
def test_tables_read_as_pandas_reads_them(roots, key):
    """The stdlib CSV reader gives the rows the JAX package's pandas frames
    hold, in their order (each dataset's id / name lists).  TreeSatAI's
    class fractions agree to 1e-14 (a few ulps): Python's ``float`` rounds the written
    decimal correctly, pandas' default parser can miss by ulps (the
    thresholded labels the samples carry are compared bit for bit above)."""
    jcfg, tcfg = _configs(key, roots[key])
    attr = {"treesat": "aerial_names", "pastis": "image_ids", "flair_npy": "patch_ids",
            "s2naip": "image_ids"}[key]
    jcls, tcls = JD.DATASET_CLASSES[jcfg.name_dataset], TD.DATASET_CLASSES[tcfg.name_dataset]
    for stage in STAGES:
        for phase in ("pretrain", "finetune"):
            jds = jcls(jcfg.dataset, roots[key], stage, ssl_phase=phase)
            tds = tcls(tcfg.dataset, roots[key], stage, ssl_phase=phase)
            assert [str(v) for v in getattr(tds, attr)] == [str(v) for v in getattr(jds, attr)]
            if key == "treesat":
                np.testing.assert_allclose(tds.target_fracs, jds.target_fracs, rtol=1e-14)
                for a, b in zip(tds.aerial_dates, jds.aerial_dates):
                    np.testing.assert_array_equal(a, b)


def _treesat_loader(roots, loader="threads"):
    _, tcfg = _configs("treesat", roots["treesat"])
    _, out = make_loader(tcfg, DataConfig(num_workers=1 if loader == "threads" else 2,
                                          loader=loader), "train", "pretrain", 2, seed=0)
    return out


@pytest.mark.parametrize("loader", LOADERS)
def test_set_epoch_and_skip_batches(roots, loader):
    """Per-epoch order is a pure function of (seed, epoch); skip_batches
    fast-forwards without changing the remaining order, and is consumed;
    the worker processes read what the thread pool reads."""
    a, b = _treesat_loader(roots, loader), _treesat_loader(roots)
    a.set_epoch(3)
    b.set_epoch(3)
    batches_a, batches_b = list(a), list(b)
    assert len(batches_a) >= 2
    for x, y in zip(batches_a, batches_b):
        _assert_same(x, y, "same epoch")
    c = _treesat_loader(roots, loader)
    c.set_epoch(3)
    c.skip_batches = 1
    skipped = list(c)
    assert len(skipped) == len(batches_a) - 1
    _assert_same(skipped[0], batches_a[1], "after skip")
    assert len(list(c)) == len(batches_a)
    c.set_epoch(4)
    assert any(not np.array_equal(x["s2"], y["s2"]) for x, y in zip(list(c), batches_a))
    for loader_ in (a, c):
        if hasattr(loader_, "close"):
            loader_.close()
    assert not multiprocessing.active_children()


class _Indexed:
    def __init__(self, n: int, fail_at: int | None = None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        if idx == self.fail_at:
            msg = "corrupt raster"
            raise OSError(msg)
        return {"idx": np.array([idx], np.int64)}


@pytest.mark.parametrize("epoch", [0, 1])
def test_epoch_reads_each_sample_once(epoch):
    """A shuffled drop_last epoch is the first full batches of the
    (seed, epoch) permutation: no sample twice, none of them skipped."""
    n, batch = 25, 2
    loader = EOBatchLoader(_Indexed(n), batch_size=batch, num_workers=2, seed=7)
    loader.set_epoch(epoch)
    got = [int(i) for b in loader for i in b["idx"][:, 0]]
    assert len(got) == len(loader) * batch == n // batch * batch
    order = np.arange(n)
    np.random.default_rng([7, epoch]).shuffle(order)
    assert got == order[: len(got)].tolist()


def test_worker_exception_surfaces():
    loader = EOBatchLoader(_Indexed(8, fail_at=3), batch_size=4, shuffle=False,
                           num_workers=2, seed=0)
    with pytest.raises(OSError, match="corrupt raster"):
        list(loader)


def test_worker_process_exception_surfaces(tmp_path):
    """A read that fails in a worker process is raised in the consumer,
    chained to the worker's traceback, and the workers are stopped."""
    write_treesat_fixture(tmp_path, num_tiles=3)
    _, tcfg = _configs("treesat", tmp_path)
    dataset, loader = make_loader(tcfg, DataConfig(num_workers=2, loader="grain"), "train",
                                  "finetune", 2, seed=0)
    # the aerial raster of a sample of the first batch is missing (not the
    # first sample's: the parent reads that one to lay out the shared slots)
    (idx,) = [i for i in epoch_batches(len(dataset), 2, True, True, 0, 0)[0] if i != 0][:1]
    (tmp_path / "aerial" / dataset.aerial_names[idx]).unlink()
    with pytest.raises(Exception, match="tile_") as info:
        list(loader)
    assert "_read_into" in str(info.value.__cause__)  # the worker's own traceback
    assert not multiprocessing.active_children()


def test_early_break_leaks_no_thread():
    before = threading.active_count()
    for _ in range(5):
        loader = EOBatchLoader(_Indexed(64), batch_size=2, shuffle=False, num_workers=2,
                               prefetch=1, seed=0)
        for _batch in loader:
            break  # early exit with the prefetch queue full
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


@pytest.mark.parametrize("exit_by", ["break", "preempted"])
def test_early_exit_leaves_no_process(roots, exit_by):
    """An epoch of the worker processes left early (a ``break``, or the
    runtime's ``Preempted`` raised in the loop) keeps the workers: the next
    pass reads its own batches on them, whatever the early one left queued.
    ``close()``, which the runtime calls at a phase's end and on
    ``Preempted``, stops every worker."""
    from maestro_tpu_torch.train.preempt import Preempted

    loader = _treesat_loader(roots, "grain")
    loader.set_epoch(0)
    want = list(loader)
    assert len(want) == len(loader)
    workers = {p.pid for p in multiprocessing.active_children()}
    assert len(workers) == loader.num_workers
    loader.set_epoch(1)
    if exit_by == "break":
        for _batch in loader:
            break
    else:
        with pytest.raises(Preempted):
            for _batch in loader:
                raise Preempted("pretrain", "checkpoint")
    assert {p.pid for p in multiprocessing.active_children()} == workers
    loader.set_epoch(0)
    got = list(loader)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        _assert_same(x, y, "after an early exit")
    loader.close()
    assert not multiprocessing.active_children()


def test_phase_loaders_share_workers(roots):
    """``make_loaders`` gives a phase's train, val and test loaders one set
    of worker processes: read one at a time, a pass left early included,
    each yields what the thread loaders yield."""
    _, tcfg = _configs("treesat", roots["treesat"])
    grain = make_loaders(tcfg, DataConfig(num_workers=2, loader="grain"), "finetune", 2)
    threads = make_loaders(tcfg, DataConfig(num_workers=2, loader="threads"), "finetune", 2)
    assert len({id(lo.group) for lo in grain.values()}) == 1
    _assert_same(next(iter(grain["val"])), next(iter(threads["val"])), "val, read early")
    for stage in ("train", "val", "test", "train"):
        got, want = list(grain[stage]), list(threads[stage])
        assert len(got) == len(want) == len(grain[stage]) > 0
        for x, y in zip(got, want):
            _assert_same(x, y, stage)
        assert len(multiprocessing.active_children()) == 2
    for loader in grain.values():
        loader.close()
    assert not multiprocessing.active_children()


@pytest.mark.parametrize(("loader", "workers", "want"), [
    ("auto", 12, "grain"), ("auto", 2, "threads"), ("threads", 12, "threads"),
    ("grain", 12, "grain"), ("processes", 12, ValueError)])
def test_pin_loader(monkeypatch, loader, workers, want):
    """The choice is resolved and written back.  On a host with fewer cores
    than twice the workers, "auto" takes the worker processes ("grain", as
    the JAX package names its multiprocess pipeline) for a pool of 4 or
    more, the thread pool for a smaller one."""
    monkeypatch.setattr("os.cpu_count", lambda: 8)
    cfg = DataConfig(loader=loader, num_workers=workers)
    if isinstance(want, str):
        assert pin_loader(cfg) == want == cfg.loader
        return
    with pytest.raises(want, match=loader):
        pin_loader(cfg)


_NO_JAX = """
import os, sys
os.cpu_count = lambda: 8
from maestro_tpu_torch.conf import DataConfig, DatasetsConfig
from maestro_tpu_torch.data.loader import make_loader
cfg = DatasetsConfig(root_dir=sys.argv[1], name_dataset="treesatai_ts")
cfg.dataset.rel_dir = ""
_, loader = make_loader(cfg, DataConfig(), "train", "pretrain", 2)
batches = iter(loader)
next(batches)
probe = "sorted(m for m in __import__('sys').modules if m.split('.')[0] in {0})"
roots = ("jax", "grain", "maestro_tpu")
print(type(loader).__name__)
print(eval(probe.format(roots)))
print(loader.group._pool.submit(eval, probe.format(roots)).result())
loader.close()
"""


def test_default_loader_loads_no_jax(roots):
    """The port's loader with its default options (loader "auto", 12
    workers) on an 8-core host reads a batch in worker processes without
    importing JAX, grain or the JAX package, in the parent or in a worker."""
    import subprocess
    import sys

    from pathlib import Path

    out = subprocess.run([sys.executable, "-c", _NO_JAX, str(roots["treesat"])],
                         capture_output=True, text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip().splitlines()[-3:] == ["ProcessBatchLoader", "[]", "[]"]
