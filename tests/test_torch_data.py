"""The port's data pipeline (``maestro_tpu_torch.data``) against the JAX
package's, on the synthetic on-disk fixtures of tests/fixtures.py.

For every dataset fixture (TreeSatAI-TS, PASTIS-HD, FLAIR-HUB as ``.npy``
and as ``.tif`` stacks, S2-NAIP), every phase and every stage, two epochs
with transforms, random dates and random crops: each sample and each loader
batch is bit-identical to the JAX package's (the port reads its tables with
the standard library, the JAX package with pandas).  Then the loader's own
contract: ``set_epoch`` / ``skip_batches``, an epoch that reads each
sample once in its (seed, epoch) order, a worker exception that surfaces, an
early break that leaks no thread, ``pin_loader`` (``data.loader=grain``
raises: grain imports JAX), and a default loader that loads no JAX.
"""

from __future__ import annotations

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
from maestro_tpu_torch.data.loader import EOBatchLoader, make_loader, pin_loader
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


def _data_cfgs():
    kw = {"use_transform": True, "random_dates": True, "random_crop": True,
          "num_workers": 2, "loader": "threads"}
    return JDataConfig(**kw), DataConfig(**kw)


def _assert_same(got: dict, want: dict, where: str) -> None:
    assert sorted(got) == sorted(want), where
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, f"{where} {k}"
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {k}")


# S2-NAIP is pretrain-only: it has no probe or finetune phase
CASES = [(key, phase) for key in FIXTURES for phase in PHASES
         if key != "s2naip" or phase == "pretrain"]


@pytest.mark.parametrize(("key", "phase"), CASES)
def test_samples_and_batches_match_jax(roots, key, phase):
    jcfg, tcfg = _configs(key, roots[key])
    jdata, tdata = _data_cfgs()
    compared = 0
    for stage in STAGES:
        jds, jl = j_make_loader(jcfg, jdata, stage, phase, BATCH, seed=5)
        tds, tl = make_loader(tcfg, tdata, stage, phase, BATCH, seed=5)
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


def _treesat_loader(roots, **kw):
    _, tcfg = _configs("treesat", roots["treesat"])
    _, loader = make_loader(tcfg, DataConfig(num_workers=1, loader="threads"), "train",
                            "pretrain", 2, seed=0, **kw)
    return loader


def test_set_epoch_and_skip_batches(roots):
    """Per-epoch order is a pure function of (seed, epoch); skip_batches
    fast-forwards without changing the remaining order, and is consumed."""
    a, b = _treesat_loader(roots), _treesat_loader(roots)
    a.set_epoch(3)
    b.set_epoch(3)
    batches_a, batches_b = list(a), list(b)
    assert len(batches_a) >= 2
    for x, y in zip(batches_a, batches_b):
        _assert_same(x, y, "same epoch")
    c = _treesat_loader(roots)
    c.set_epoch(3)
    c.skip_batches = 1
    skipped = list(c)
    assert len(skipped) == len(batches_a) - 1
    _assert_same(skipped[0], batches_a[1], "after skip")
    assert len(list(c)) == len(batches_a)
    c.set_epoch(4)
    assert any(not np.array_equal(x["s2"], y["s2"]) for x, y in zip(list(c), batches_a))


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


@pytest.mark.parametrize(("loader", "want"), [
    ("auto", "threads"), ("threads", "threads"),
    ("grain", NotImplementedError), ("processes", ValueError)])
def test_pin_loader(monkeypatch, loader, want):
    """The choice is resolved and written back.  "auto" is the thread pool
    even on a host with fewer cores than twice the default 12 workers (where
    the JAX package picks grain); "grain" raises, naming its ROADMAP item."""
    monkeypatch.setattr("os.cpu_count", lambda: 8)
    cfg = DataConfig(loader=loader)
    if isinstance(want, str):
        assert pin_loader(cfg) == want == cfg.loader
        return
    with pytest.raises(want, match="ROADMAP.md queue 1 item 9" if loader == "grain" else loader):
        pin_loader(cfg)


_NO_JAX = """
import os, sys
os.cpu_count = lambda: 8
from maestro_tpu_torch.conf import DataConfig, DatasetsConfig
from maestro_tpu_torch.data.loader import make_loader
cfg = DatasetsConfig(root_dir=sys.argv[1], name_dataset="treesatai_ts")
cfg.dataset.rel_dir = ""
_, loader = make_loader(cfg, DataConfig(), "train", "pretrain", 2)
next(iter(loader))
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "grain", "maestro_tpu")))
"""


def test_default_loader_loads_no_jax(roots):
    """The port's loader with its default options (loader "auto", 12
    workers) on an 8-core host reads a batch without importing JAX, grain or
    the JAX package."""
    import subprocess
    import sys

    from pathlib import Path

    out = subprocess.run([sys.executable, "-c", _NO_JAX, str(roots["treesat"])],
                         capture_output=True, text=True, timeout=120, check=True,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip().splitlines()[-1] == "[]"
