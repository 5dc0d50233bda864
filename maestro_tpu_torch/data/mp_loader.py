"""Host batch loader over worker processes.

The port's counterpart of the JAX package's ``data/grain_loader.py``: it
reads samples in worker processes, so decoding and cropping run beside the
training loop instead of under its GIL, and it yields the same collated
numpy batches in the same order as ``loader.EOBatchLoader`` for the same
(seed, epoch): the ``np.random.default_rng([seed, epoch])`` shuffle, cut to
whole batches.  It keeps grain's CLI name (``data.loader=grain``, and
``"auto"`` on a host with few cores), so that one command line drives both
packages; grain itself imports JAX, which the port never loads.

Design (``ProcessBatchLoader`` over a ``WorkerGroup``):

* **Start method.** Workers are forked from a ``forkserver``: the parent
  may hold a CUDA context, the checkpoint writer thread and, under the tests,
  XLA's threads, and forking a process that holds threads can deadlock.  The
  server is a fresh interpreter that imports this module once
  (``set_forkserver_preload``), and torch too when the parent has imported
  it: every worker imports the parent's ``__main__`` module again, as
  multiprocessing prepares a child (so a script that starts the loader
  guards its entry point with ``if __name__ == "__main__"``), and a script
  that imports torch would otherwise pay that import in each worker.
* **Every batch spread over all workers, through shared memory.**  A task is
  a part of a batch, ``ceil(batch_size / num_workers)`` samples, so the first
  batch of a pass waits for a part, not for one worker to read a whole
  batch.  The parent makes a ring of batch-sized slots of shared memory
  (``multiprocessing.heap.BufferWrapper``, the memory under ``RawArray``
  without its zero fill), laid out from one sample of each loader that it
  reads itself; a worker writes its samples into a slot in place and returns
  nothing, and the parent copies the finished batch out before it reuses the
  slot.  Pickling samples through the pool's result pipe instead read 16
  samples/s with eight workers on an 8-core H100 host, below eight threads'
  23; ``torch.utils.data.DataLoader`` (a batch a worker, collated into shared
  memory) ran the CLI at 20 batches a pass 13 % slower than this pool in its
  earlier form (a pool a loader), and 36 % slower with its batches in parts
  (PERF.md §6).
* **One group of persistent workers a phase.**  The train, val and test
  loaders of a phase, which the runtime reads one at a time, share one
  ``WorkerGroup`` (``loader.make_loaders``): one pool, one ring of slots, one
  start a phase.  The workers start at the first batch and stay across
  epochs and loaders; each unpickles the datasets and the slots once.  A
  task carries its loader and its epoch, and the worker sets that dataset's
  epoch before it reads (a persistent worker's copy never sees the parent's
  ``set_epoch``).
* **Order and memory.**  At most ``prefetch + 1`` batches (and no more
  than an epoch holds) are in flight, one a slot, and they are yielded in
  their order.
* **A pass left early keeps the workers.**  A ``break``, or a partial read
  (the runtime's image batch, the eval cache's replay check), cancels the
  pass's tasks that have not started; the next pass waits for the ones that
  have before it reuses their slots.  ``close()`` stops the workers: the
  runtime calls it at each phase's end, on ``Preempted`` too.
* **Errors.**  An exception in a worker is raised in the consumer, chained
  to the worker's traceback, and stops the workers; a worker that dies
  raises ``BrokenProcessPool``.
"""

from __future__ import annotations

import multiprocessing
import sys
from collections import deque
from concurrent.futures import ProcessPoolExecutor, wait
from multiprocessing.heap import BufferWrapper

import numpy as np

from maestro_tpu_torch.data.loader import epoch_batches

# a worker's state, set once by _init_worker
_datasets: list = []
_slots: list = []
_layouts: list = []


def _padded(nbytes: int) -> int:
    return -(-nbytes // 64) * 64


def _sample_layout(sample: dict[str, np.ndarray], batch_size: int) -> dict:
    """Key -> (shape, dtype, byte offset) in a batch slot: each key's
    ``batch_size`` samples side by side, the keys one after another."""
    layout, offset = {}, 0
    for key, value in sample.items():
        value = np.asarray(value)
        layout[key] = (value.shape, value.dtype.str, offset)
        offset += _padded(batch_size * value.nbytes)
    return layout


def _slot_bytes(layout: dict, batch_size: int) -> int:
    return max((off + _padded(batch_size * int(np.prod(shape)) * np.dtype(dt).itemsize)
                for shape, dt, off in layout.values()), default=0)


def _views(buf, layout: dict, batch_size: int) -> dict[str, np.ndarray]:
    """Each key's ``[batch_size, ...]`` array in a slot's buffer."""
    out = {}
    for key, (shape, dt, off) in layout.items():
        count = batch_size * int(np.prod(shape))
        out[key] = np.frombuffer(buf, dtype=dt, count=count, offset=off).reshape(
            (batch_size, *shape))
    return out


def _init_worker(datasets: list, slots: list[BufferWrapper], layouts: list) -> None:
    global _datasets, _slots, _layouts
    _datasets, _layouts = datasets, layouts
    _slots = [slot.create_memoryview() for slot in slots]


def _read_into(member: int, epoch: int, indices: np.ndarray, slot: int, position: int,
               batch_size: int) -> None:
    """Write the samples ``indices`` of loader ``member``'s dataset at
    ``epoch`` into ``slot``, from batch position ``position`` on."""
    dataset = _datasets[member]
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)  # the per-(epoch, idx) sample rng
    views = _views(_slots[slot], _layouts[member], batch_size)
    for i, idx in enumerate(indices):
        sample = dataset[int(idx)]
        if sample.keys() != views.keys():
            msg = f"sample {int(idx)} has keys {sorted(sample)}, the first one {sorted(views)}"
            raise ValueError(msg)
        for key, value in sample.items():
            views[key][position + i] = value  # raises where a shape differs


class WorkerGroup:
    """One pool of worker processes and one ring of slots, shared by loaders
    that are read one at a time (a phase's train, val and test)."""

    def __init__(self, num_workers: int, prefetch: int = 2) -> None:
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.members: list[ProcessBatchLoader] = []
        self._pool: ProcessPoolExecutor | None = None
        self._slots: list[BufferWrapper] = []
        self._layouts: list[dict] = []
        self._pending: deque = deque()  # (slot, samples, futures) of each batch in flight
        self._owner = None  # the pass that submitted them

    def join(self, member: ProcessBatchLoader) -> int:
        if self._pool is not None:
            msg = "a loader joined a worker group after its workers started"
            raise RuntimeError(msg)
        self.members.append(member)
        return len(self.members) - 1

    def _start(self) -> ProcessPoolExecutor:
        if self._pool is None:
            ctx = multiprocessing.get_context("forkserver")
            ctx.set_forkserver_preload([__name__] + [m for m in ("torch",)
                                                     if m in sys.modules])
            self._layouts = [_sample_layout(m.dataset[0], m.batch_size) if len(m.dataset)
                             else {} for m in self.members]
            size = max(_slot_bytes(lay, m.batch_size)
                       for lay, m in zip(self._layouts, self.members))
            # never more slots than the longest epoch has batches
            slots = min(self.prefetch + 1, max(max(len(m) for m in self.members), 1))
            self._slots = [BufferWrapper(max(size, 1)) for _ in range(slots)]
            self._pool = ProcessPoolExecutor(
                self.num_workers, mp_context=ctx, initializer=_init_worker,
                initargs=([m.dataset for m in self.members], self._slots, self._layouts),
            )
        return self._pool

    def _settle(self) -> None:
        """Wait for the tasks an earlier pass left running (their slots are
        about to be reused); their results, errors included, are dropped."""
        futures = [f for _, _, fs in self._pending for f in fs]
        for f in futures:
            f.cancel()
        wait(futures)
        self._pending.clear()

    def run(self, member: int, epoch: int, batches: list[np.ndarray]):
        """Yield the collated batches of one pass of loader ``member``."""
        batch_size = self.members[member].batch_size
        split = -(-batch_size // self.num_workers)  # samples a task
        todo = iter(batches)
        token = object()
        pending = self._pending

        def submit(idxs, slot: int) -> None:
            pending.append((slot, len(idxs), [
                pool.submit(_read_into, member, epoch, idxs[i : i + split], slot, i, batch_size)
                for i in range(0, len(idxs), split)]))

        try:
            pool = self._start()
            layout = self._layouts[member]
            self._settle()
            self._owner = token
            for slot, idxs in zip(range(len(self._slots)), todo):
                submit(idxs, slot)
            while pending:
                slot, n, futures = pending.popleft()
                for f in futures:
                    f.result()
                if self._owner is not token:
                    msg = "two passes of one worker group overlapped"
                    raise RuntimeError(msg)
                views = _views(self._slots[slot].create_memoryview(), layout, batch_size)
                batch = {k: v[:n].copy() for k, v in views.items()}  # the slot is reused
                nxt = next(todo, None)
                if nxt is not None:
                    submit(nxt, slot)
                yield batch
        except GeneratorExit:
            if self._owner is token:  # left early: the workers stay for the next pass
                for _, _, futures in pending:
                    for f in futures:
                        f.cancel()
            raise
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stop the worker processes and free the slots (the next pass starts
        new ones)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool, self._slots, self._owner = None, [], None
            self._pending.clear()

    def __del__(self) -> None:
        if getattr(self, "_pool", None) is not None:
            self.close()


class ProcessBatchLoader:
    """Iterable over collated numpy batches read by worker processes (the
    interface of ``loader.EOBatchLoader``); loaders built with one ``group``
    share its workers."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
        group: WorkerGroup | None = None,
        shard_index: int = 0,
        shard_count: int = 1,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard_index, self.shard_count = shard_index, shard_count
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.skip_batches = 0  # consumed by the next __iter__ (fast-forward)
        self._auto_epoch = True
        self.group = group if group is not None else WorkerGroup(num_workers, prefetch)
        self.num_workers = self.group.num_workers
        self._member = self.group.join(self)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._auto_epoch = False

    def __len__(self) -> int:
        n = len(self.dataset) // self.shard_count
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def close(self) -> None:
        """Stop the group's worker processes."""
        self.group.close()

    def __iter__(self):
        epoch = self.epoch
        batches = epoch_batches(len(self.dataset), self.batch_size, self.shuffle,
                                self.drop_last, self.seed, epoch,
                                self.shard_index, self.shard_count)
        if self.skip_batches:
            batches = batches[self.skip_batches :]  # no read for skipped
            self.skip_batches = 0
        if self._auto_epoch:
            self.epoch += 1
        if not batches:
            return iter(())
        return self.group.run(self._member, epoch, batches)
