"""The port's probe val feature cache (``maestro_tpu_torch.train.eval_cache``),
the MAE cases of tests/test_probe_eval_cache.py, on the CPU.

The probe trunk is frozen and the runtime pins val loaders to epoch 0, so
val trunk features are computed once and later val epochs run head-only.
These tests show that later epochs really skip the loader and the trunk,
that a cached run's val metrics equal an uncached run's epoch for epoch (on
one device the split forward runs the same operations, so they are equal
bit for bit), the host spill tier, the cap that disables the cache, no
cache when the trunk trains, and the first-replay guard disabling the cache
on a val stream that is not epoch-invariant.
"""

from __future__ import annotations

import numpy as np
import pytest

from maestro_tpu_torch.conf import (
    DataConfig,
    DatasetsConfig,
    ExperimentConfig,
    MaskConfig,
    ModelConfig,
    OptFinetuneConfig,
    OptProbeConfig,
    RunConfig,
    TrainerConfig,
)
from maestro_tpu_torch.data.datasets import PASTISHDDataset, TreeSatAITSDataset
from maestro_tpu_torch.data.loader import EOBatchLoader
from maestro_tpu_torch.train.runtime import Experiment
from tests.fixtures import write_pastis_fixture, write_treesat_fixture

from _torch_port_utils import single_thread_torch  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread_torch")


class Subset:
    """Fixed-length view that wraps around the dataset and forwards
    ``set_epoch``, so the loader's epoch reaches the per-(seed, epoch, idx)
    rng of the real dataset."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n

    def __getitem__(self, i):
        return self.ds[i % len(self.ds)]

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.ds.set_epoch(epoch)


class OpaqueLoader:
    """Counts ``iter()`` calls (full passes and the guard's one-batch peek).
    It has no ``set_epoch``: the runtime cannot pin it, so the inner loader
    auto-advances its epoch and the val stream varies."""

    def __init__(self, loader):
        self.loader = loader
        self.iterations = 0

    def __iter__(self):
        self.iterations += 1
        return iter(self.loader)

    def __len__(self):
        return len(self.loader)


class CountingLoader(OpaqueLoader):
    """The same, forwarding ``set_epoch`` as a real loader does."""

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)


@pytest.fixture(scope="module")
def treesat_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("treesat_cache")
    write_treesat_fixture(root, num_tiles=2)
    return root


@pytest.fixture(scope="module")
def pastis_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("pastis_cache")
    write_pastis_fixture(root, num_tiles=1)
    return root


def _cfg(tmp_path, name, *, cache: bool, epochs: int = 3):
    return ExperimentConfig(
        run=RunConfig(exp_dir=str(tmp_path), exp_name=name, seed=0,
                      logged_images_per_epoch=0),
        opt_probe=OptProbeConfig(epochs=epochs, batch_size=2),
        data=DataConfig(num_workers=2),
        mask=MaskConfig(),
        model=ModelConfig(model_size="micro", fusion_mode="group", inter_depth=1,
                          use_ema=False),
        trainer=TrainerConfig(mesh_data=1, compute_dtype="float32", probe_eval_cache=cache,
                              async_checkpoint=False),
    )


def _experiment(root, tmp_path, name, ds_name, cfg):
    datasets = DatasetsConfig(root_dir=str(root), name_dataset=ds_name)
    datasets.dataset.rel_dir = ""
    return Experiment(cfg, datasets, tmp_path / name, device="cpu"), datasets


def _loaders(ds, n_train=4, n_val=4, val_wrapper=CountingLoader):
    train = EOBatchLoader(Subset(ds, n_train), batch_size=2, num_workers=2, seed=0)
    val = val_wrapper(EOBatchLoader(Subset(ds, n_val), batch_size=2, num_workers=2, seed=0))
    return train, val


def _run_probe(root, tmp_path, name, dataset_cls, ds_name, *, cache, epochs=3, n_val=4,
               val_wrapper=CountingLoader, **trainer):
    cfg = _cfg(tmp_path, name, cache=cache, epochs=epochs)
    for k, v in trainer.items():
        setattr(cfg.trainer, k, v)
    exp, datasets = _experiment(root, tmp_path, name, ds_name, cfg)
    ds = dataset_cls(datasets.dataset, root, "train", ssl_phase="probe")
    train, val = _loaders(ds, n_val=n_val, val_wrapper=val_wrapper)
    result = exp.fit_phase("probe", cfg.opt_probe, train, val, None)
    return result, val, exp._last_eval_cache


def _assert_val_equal(res_a, res_b) -> None:
    assert len(res_a.history) == len(res_b.history)
    for ea, eb in zip(res_a.history, res_b.history):
        keys = [k for k in eb if k.startswith("val/")]
        assert keys and sorted(keys) == sorted(k for k in ea if k.startswith("val/"))
        for k in keys:
            assert ea[k] == eb[k], (ea["epoch"], k, ea[k], eb[k])


def test_cache_skips_loader_and_matches_uncached(treesat_root, tmp_path):
    res_c, val_c, cache = _run_probe(treesat_root, tmp_path, "cached", TreeSatAITSDataset,
                                     "treesatai_ts", cache=True)
    res_u, val_u, no_cache = _run_probe(treesat_root, tmp_path, "uncached",
                                        TreeSatAITSDataset, "treesatai_ts", cache=False)
    assert no_cache is None
    assert cache is not None and cache.ready and not cache.disabled
    assert cache.hit_epochs == 2  # epochs 1..2 replayed head-only
    assert len(cache.entries) == len(val_c)
    assert all(e.on_device for e in cache.entries) and cache.device_nbytes > 0
    # epoch-0 full pass + the first-replay guard's batch-0 peek
    assert val_c.iterations == 2 and val_u.iterations == 3
    _assert_val_equal(res_c, res_u)


def test_cache_through_chunked_seg_head(pastis_root, tmp_path):
    res_c, _, cache = _run_probe(pastis_root, tmp_path, "seg_cached", PASTISHDDataset,
                                 "pastis_hd", cache=True, epochs=2)
    res_u, _, _ = _run_probe(pastis_root, tmp_path, "seg_uncached", PASTISHDDataset,
                             "pastis_hd", cache=False, epochs=2)
    assert cache is not None and cache.hit_epochs == 1
    assert np.isfinite(res_c.val_metrics["pastis_seg/average_iou"])
    _assert_val_equal(res_c, res_u)


def test_host_spill_tier(treesat_root, tmp_path):
    """A device budget of 0 puts every batch in the host tier; replay still
    skips the loader and matches the device tier's metrics."""
    res_s, val, cache = _run_probe(treesat_root, tmp_path, "spill", TreeSatAITSDataset,
                                   "treesatai_ts", cache=True, epochs=2,
                                   probe_eval_cache_device_gb=0.0)
    res_d, _, _ = _run_probe(treesat_root, tmp_path, "dev", TreeSatAITSDataset,
                             "treesatai_ts", cache=True, epochs=2)
    assert cache is not None and cache.ready and cache.hit_epochs == 1
    assert cache.entries and all(not e.on_device for e in cache.entries)
    assert cache.device_nbytes == 0
    assert val.iterations == 2  # epoch-0 pass + guard peek
    _assert_val_equal(res_s, res_d)


def test_no_cache_when_trunk_trains(treesat_root, tmp_path):
    """MAE finetune updates the trunk every step: the gate stays off."""
    cfg = _cfg(tmp_path, "ft_nocache", cache=True, epochs=2)
    exp, datasets = _experiment(treesat_root, tmp_path, "ft_nocache", "treesatai_ts", cfg)
    ds = TreeSatAITSDataset(datasets.dataset, treesat_root, "train", ssl_phase="finetune")
    train, val = _loaders(ds)
    exp.fit_phase("finetune", OptFinetuneConfig(epochs=2, batch_size=2), train, val, None)
    assert exp._last_eval_cache is None
    assert val.iterations == 2


def test_cache_cap_disables_and_falls_back(treesat_root, tmp_path):
    res, val, cache = _run_probe(treesat_root, tmp_path, "capped", TreeSatAITSDataset,
                                 "treesatai_ts", cache=True, epochs=2,
                                 probe_eval_cache_gb=1e-9)  # below one batch
    assert cache is not None and cache.disabled and not cache.ready
    assert not cache.entries
    assert val.iterations == 2  # fell back to per-epoch eval
    assert res.val_metrics


def test_parity_on_nondivisible_real_loader(treesat_root, tmp_path):
    """5 val samples at batch 2 (drop_last varies the dropped remainder per
    epoch) over a dataset whose s2 date count is not a multiple of num_dates
    (the t0 window re-rolls per epoch): with the epoch-0 pin the cached and
    uncached runs see one stream and match epoch for epoch."""
    res_c, val_c, cache = _run_probe(treesat_root, tmp_path, "nd_cached", TreeSatAITSDataset,
                                     "treesatai_ts", cache=True, n_val=5)
    res_u, val_u, _ = _run_probe(treesat_root, tmp_path, "nd_uncached", TreeSatAITSDataset,
                                 "treesatai_ts", cache=False, n_val=5)
    assert cache is not None and cache.ready and cache.hit_epochs == 2
    assert val_c.iterations == 2 and val_u.iterations == 3
    assert len(res_c.history) == 3
    _assert_val_equal(res_c, res_u)


def test_replay_guard_disables_on_noninvariant_loader(treesat_root, tmp_path):
    """A val loader without set_epoch cannot be pinned, so its stream varies
    by epoch: the guard catches the feature mismatch, disables the cache,
    and eval falls back to full passes."""
    res, val, cache = _run_probe(treesat_root, tmp_path, "guarded", TreeSatAITSDataset,
                                 "treesatai_ts", cache=True, n_val=5, val_wrapper=OpaqueLoader)
    assert cache is not None
    assert cache.disabled and not cache.ready
    assert cache.hit_epochs == 0 and not cache.entries
    assert val.iterations == 4  # epoch-0 pass + guard peek + full evals of epochs 1..2
    assert all(np.isfinite(v) for v in res.val_metrics.values())
