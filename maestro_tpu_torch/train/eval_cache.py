"""Frozen-trunk val feature cache: device-resident tier + host spill.

In the probe phase the entire trunk — patch embeds, per-group encoders and
the shared inter trunk — is frozen (train/optim.py trains the 'head' role
only) and the runtime PINS val/test loaders to epoch 0
(``Experiment._run_eval_epoch`` calls ``set_epoch(0)`` before every eval
pass — without the pin, loaders auto-advance their epoch, which reshuffles
the drop_last remainder and re-rolls the per-(seed, epoch, idx) date-window
offsets, so val batches would NOT be epoch-constant).  With the pin, the
trunk features of every val batch are identical across epochs.  The first
val eval therefore computes them once through ``make_feature_step``; every
later val eval re-runs only the heads via ``make_head_eval_step`` — the
trunk forward, and the raster reads behind it, are skipped entirely.
``verify_replay`` backstops the invariance assumption at runtime: on the
first replay epoch it recomputes batch 0's features through the real
loader and disables the cache (falling back to full eval) on mismatch.

Two storage tiers:

- **device tier** (first ``trainer.probe_eval_cache_device_gb``): the
  feature tensors the feature step just produced are kept alive on the
  device — no copy in either direction.
- **host spill** (up to ``trainer.probe_eval_cache_gb`` total): batches
  past the device budget are copied to host RAM (pinned when the features
  are on a CUDA device, in the features' dtype: bf16 under a bf16 compute
  policy) with ``non_blocking=True`` and copied back the same way on replay.

Guard rails:

- crossing the TOTAL cap disables the cache for the phase (entries
  dropped, one warning) rather than growing without bound on a large val
  split;
- single-process only (the runtime gates on one process): a multi-process
  val split is not held by one process;
- frozen-trunk phases only: probe.  An unfrozen finetune updates the trunk
  every step, so its features are never reusable.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

log = logging.getLogger(__name__)


def clamp_device_cap(cap_bytes: int, device="cuda") -> int:
    """Clamp the device-resident tier to at most half the device memory that
    is free now (``torch.cuda.mem_get_info``): training activations are not
    resident when the cache is built, so only half of the free headroom is
    claimed; batches past the clamped tier spill to host, which is always
    correct.  A non-CUDA device keeps the configured cap."""
    device = torch.device(device)
    if device.type != "cuda":
        return cap_bytes
    free, _total = torch.cuda.mem_get_info(device)
    clamped = max(0, min(cap_bytes, free // 2))
    if clamped < cap_bytes:
        log.info(
            "val feature cache: device tier clamped %.2f -> %.2f GiB "
            "(half of free device memory); overflow spills to host",
            cap_bytes / 2**30, clamped / 2**30,
        )
    return clamped


def _to_host(x: torch.Tensor) -> torch.Tensor:
    if x.device.type != "cuda":
        return x.detach().clone()
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    return host


@dataclass
class CacheEntry:
    feats: dict[str, torch.Tensor]  # device tensors (on_device) or host copies
    labels: dict[str, np.ndarray]  # host label arrays (small)
    on_device: bool


@dataclass
class ProbeEvalCache:
    """Per-batch feature store + the two steps that use it.

    Lifecycle inside ``Experiment._run_eval_epoch``: while ``not ready``,
    the val loop runs ``feature_step`` + ``head_step`` per batch and calls
    ``store``; once the epoch completes, ``seal`` flips ``ready`` and later
    epochs iterate ``entries`` without touching the loader.
    """

    feature_step: Callable  # (batch) -> encoded (device)
    head_step: Callable     # (state, encoded, labels, metrics) -> ...
    label_keys: tuple[str, ...]
    cap_bytes: int
    device_cap_bytes: int = 0
    entries: list[CacheEntry] = field(default_factory=list)
    nbytes: int = 0
    device_nbytes: int = 0
    ready: bool = False
    disabled: bool = False
    # observability: how many head-only evals ran off the cache
    hit_epochs: int = 0

    def store(self, encoded: dict[str, torch.Tensor], np_labels: dict) -> None:
        """Stash one val batch: keep on the device under the device budget,
        else copy to host."""
        if self.disabled:
            return
        feat_bytes = sum(x.numel() * x.element_size() for x in encoded.values())
        labels = {k: np.asarray(v) for k, v in np_labels.items()}
        self.nbytes += feat_bytes + sum(v.nbytes for v in labels.values())
        if self.nbytes > self.cap_bytes:
            self.disabled = True
            self.entries.clear()
            self.device_nbytes = 0
            log.warning(
                "frozen-trunk val feature cache exceeded its %.1f GiB cap - "
                "disabled for this phase (trainer.probe_eval_cache_gb "
                "raises it)", self.cap_bytes / 2**30,
            )
            return
        on_device = self.device_nbytes + feat_bytes <= self.device_cap_bytes
        if on_device:
            self.device_nbytes += feat_bytes
            feats = encoded  # keep the live device tensors - no copy at all
        else:
            feats = {k: _to_host(v) for k, v in encoded.items()}
        self.entries.append(CacheEntry(feats, labels, on_device))

    def features(self, entry: CacheEntry, device) -> dict[str, torch.Tensor]:
        """An entry's features on ``device`` (host-spilled ones copied back)."""
        if entry.on_device:
            return entry.feats
        return {k: v.to(device, non_blocking=True) for k, v in entry.feats.items()}

    def seal(self) -> None:
        """First full val pass done: later epochs replay from the cache."""
        if not self.disabled:
            self.ready = True
            spilled = sum(1 for e in self.entries if not e.on_device)
            if spilled:
                log.info(
                    "val feature cache: %d/%d batches device-resident "
                    "(%.2f GiB), %d spilled to host (%.2f GiB total)",
                    len(self.entries) - spilled, len(self.entries),
                    self.device_nbytes / 2**30, spilled,
                    self.nbytes / 2**30,
                )

    def verify_replay(self, loader, device_batch_fn) -> bool:
        """One-shot invariance guard, run before the FIRST cached replay.

        Recomputes the features of the val loader's batch 0 and compares
        them to the cached entry.  The runtime pins the loader to epoch 0,
        so a mismatch means the premise is broken anyway (a wrapper that
        drops ``set_epoch``, or sample randomness outside the epoch rng) —
        the cache is disabled and later epochs fall back to full eval.
        Cost: one batch read + one feature pass, once per phase.
        """
        if self.disabled or not self.ready or not self.entries:
            return not self.disabled
        np_batch = next(iter(loader), None)
        if np_batch is None:  # empty loader: nothing to compare
            return True
        fresh = self.feature_step(device_batch_fn(np_batch))
        cached = self.entries[0].feats
        ok = sorted(fresh) == sorted(cached) and all(
            fresh[k].shape == cached[k].shape
            # identical params + identical batch through the same forward
            # reproduce bitwise on one device; the band only absorbs
            # nondeterministic reductions
            and np.allclose(
                fresh[k].float().cpu().numpy(), cached[k].float().cpu().numpy(),
                rtol=1e-3, atol=1e-4,
            )
            for k in fresh
        )
        if not ok:
            self.disabled = True
            self.ready = False
            self.entries.clear()
            self.device_nbytes = 0
            log.warning(
                "val feature cache replay guard: batch-0 features changed "
                "between epochs (val stream is not epoch-invariant here) - "
                "cache disabled, falling back to full per-epoch eval",
            )
        return ok

