"""Host batch loaders: parallel sample reads + numpy collation + prefetch.

Replace the reference's torch DataLoader (12 worker processes, reference
maestro/train/data.py).  ``EOBatchLoader`` reads in a thread pool (raster
decoding is numpy and releases the GIL inside h5py/imageio/numpy reads);
``mp_loader.ProcessBatchLoader`` reads in worker processes.  Both yield the
same batches in the same order (``epoch_batches``); ``resolve_loader`` picks
one as the JAX package does.  All splits iterate shuffled with drop_last
(reference data.py:38-44).  In a multi-process run each process reads its
shard of the sample order, ``order[shard_index::shard_count]``, so the
shards are disjoint and the global batch b holds the samples of one
process's batch b of ``shard_count`` times the size (reference: Lightning's
DistributedSampler).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def collate(samples: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


def epoch_batches(n: int, batch_size: int, shuffle: bool, drop_last: bool, seed: int,
                  epoch: int, shard_index: int = 0, shard_count: int = 1) -> list[np.ndarray]:
    """The sample indices of each batch of one epoch: a pure function of
    (seed, epoch), so a restarted process reproduces it (the mid-epoch
    resume) and both loaders read the same batches; a process reads its
    shard of the order (``n // shard_count`` samples, the same count on
    every process)."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng([seed, epoch]).shuffle(order)
    n = n // shard_count
    order = order[shard_index::shard_count][:n]
    nb = n // batch_size if drop_last else (n + batch_size - 1) // batch_size
    return [order[i * batch_size : (i + 1) * batch_size] for i in range(nb)]


class EOBatchLoader:
    """Iterable over collated numpy batches with background prefetch."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self.shard_index, self.shard_count = shard_index, shard_count
        # per-epoch order is a pure function of (seed, epoch) so a restarted
        # process reproduces it exactly (mid-epoch preemption resume); the
        # runtime drives set_epoch, standalone use auto-increments per pass
        self.epoch = 0
        self.skip_batches = 0  # consumed by the next __iter__ (fast-forward)
        self._auto_epoch = True

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._auto_epoch = False

    def __len__(self) -> int:
        n = len(self.dataset) // self.shard_count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)  # per-(epoch, idx) sample rng
        batches = epoch_batches(len(self.dataset), self.batch_size, self.shuffle,
                                self.drop_last, self.seed, self.epoch,
                                self.shard_index, self.shard_count)
        if self.skip_batches:
            batches = batches[self.skip_batches :]  # no decode for skipped
            self.skip_batches = 0
        if self._auto_epoch:
            self.epoch += 1
        out: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Blocking put that gives up once the consumer is gone — a
            producer parked in ``Queue.put`` on a full prefetch queue would
            otherwise leak its thread (and the pool) on early break."""
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.2)
                except queue.Full:
                    continue
                return True
            return False

        def produce() -> None:
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        batch = collate(
                            list(pool.map(self.dataset.__getitem__, idxs)),
                        )
                        if not put(batch):
                            return
                put(None)
            except BaseException as exc:  # noqa: BLE001 - a decode error must
                put(exc)  # reach the consumer, not hang it on out.get()

        worker = threading.Thread(target=produce, daemon=True)
        worker.start()
        try:
            while True:
                batch = out.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()


LOADERS = ("threads", "grain")


def resolve_loader(data_cfg) -> str:
    """Resolve ``data_cfg.loader``; "auto" picks what can feed the device, as
    the JAX package's ``resolve_loader`` does.

    The thread pool is held by the GIL on decode-heavy pipelines (PERF.md,
    the experiment phase's loader alone), so "auto" selects the worker
    processes ("grain", ``mp_loader.ProcessBatchLoader``) when the host is
    core-starved relative to the configured worker count, and only for
    production-sized pools (small test pools keep the cheap in-process
    loader).
    """
    if data_cfg.loader == "auto":
        cores = os.cpu_count() or 1
        if data_cfg.num_workers >= 4 and cores < 2 * data_cfg.num_workers:
            return "grain"
        return "threads"
    if data_cfg.loader not in LOADERS:
        msg = f"unknown data.loader={data_cfg.loader!r} (auto, threads or grain)"
        raise ValueError(msg)
    return data_cfg.loader


def pin_loader(data_cfg) -> str:
    """Resolve ``data_cfg.loader`` once for the run and write the concrete
    value back, so ``config_resolved.json`` and checkpoint meta record it (an
    interrupted run must resume under the same loader; fit_phase refuses
    otherwise).  ``resolve_loader`` reads the host's core count, so in a
    multi-process run process 0's choice is broadcast and every process
    uses the same pipeline."""
    from maestro_tpu_torch.parallel.distributed import broadcast_object

    data_cfg.loader = broadcast_object(resolve_loader(data_cfg))
    return data_cfg.loader


def make_loader(
    datasets_cfg,
    data_cfg,
    stage: str,
    ssl_phase: str,
    batch_size: int,
    seed: int = 0,
    group=None,
    shard_index: int = 0,
    shard_count: int = 1,
):
    """Build (dataset, loader) for one (stage, phase), mirroring SSLDataModule.

    ``data_cfg.loader`` selects the thread pool ("threads"), the worker
    processes ("grain") or "auto" (``resolve_loader``).  ``group``: an
    ``mp_loader.WorkerGroup`` whose workers the process loader shares.
    ``batch_size`` is the per-process batch; (``shard_index``,
    ``shard_count``) the process's shard of the sample order.
    """
    from maestro_tpu_torch.data.datasets import DATASET_CLASSES

    ds_cls = DATASET_CLASSES[datasets_cfg.name_dataset]
    root = (
        f"{datasets_cfg.root_dir}/{datasets_cfg.dataset.rel_dir}"
        if datasets_cfg.dataset.rel_dir
        else datasets_cfg.root_dir
    )
    dataset = ds_cls(
        datasets_cfg.dataset,
        root,
        stage,
        use_transform=data_cfg.use_transform and stage == "train",
        random_dates=data_cfg.random_dates,
        random_crop=data_cfg.random_crop,
        ssl_phase=ssl_phase,
        seed=seed,
    )
    kwargs = {"batch_size": batch_size, "shuffle": True, "drop_last": True,
              "num_workers": data_cfg.num_workers, "prefetch": data_cfg.prefetch, "seed": seed,
              "shard_index": shard_index, "shard_count": shard_count}
    if resolve_loader(data_cfg) == "grain":
        from maestro_tpu_torch.data.mp_loader import ProcessBatchLoader

        return dataset, ProcessBatchLoader(dataset, group=group, **kwargs)
    return dataset, EOBatchLoader(dataset, **kwargs)


def make_loaders(datasets_cfg, data_cfg, ssl_phase: str, batch_size: int,
                 seed: int = 0, shard_index: int = 0, shard_count: int = 1) -> dict:
    """The train, val and test loaders of one phase; the worker processes
    ("grain") are one ``WorkerGroup`` for the three, which the runtime reads
    one at a time."""
    group = None
    if resolve_loader(data_cfg) == "grain":
        from maestro_tpu_torch.data.mp_loader import WorkerGroup

        group = WorkerGroup(data_cfg.num_workers, data_cfg.prefetch)
    return {stage: make_loader(datasets_cfg, data_cfg, stage, ssl_phase, batch_size, seed,
                               group=group, shard_index=shard_index,
                               shard_count=shard_count)[1]
            for stage in ("train", "val", "test")}
