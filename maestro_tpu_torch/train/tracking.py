"""Pluggable experiment-tracker hook.

The reference wires ClearML directly into its orchestrator
(reference maestro/run_experiment.py:41-64: Task.init + config
connect + TB auto-capture).  We deliberately do not depend on a SaaS
client; the built-in sinks are a ``metrics.jsonl`` file and the TB event
writer (utils/tb.py).  This module makes that substitution explicit and
reversible: any external tracker (ClearML, W&B, MLflow, ...) can be
plugged in without adding a repo dependency, via

  * config: ``run.tracker = "my_pkg.my_mod:make_tracker"``, or
  * env:    ``MAESTRO_TRACKER=my_pkg.my_mod:make_tracker``

where ``make_tracker(workdir: Path, config: dict) -> Tracker`` returns any
object implementing the ``Tracker`` protocol below.  In a multi-process
run only process 0 constructs the trackers and writes records (the runtime
gates on ``parallel.distributed.is_primary()``; the reference's rank-0
ClearML task).
"""

from __future__ import annotations

import importlib
import json
import logging
from pathlib import Path
from typing import Protocol, runtime_checkable

log = logging.getLogger(__name__)


@runtime_checkable
class Tracker(Protocol):
    """Minimal surface an external experiment tracker must implement."""

    def log_record(self, record: dict) -> None:
        """One structured row per (phase, epoch) — losses, metrics, lr."""

    def close(self) -> None: ...


class JsonlTracker:
    """Default sink: append-only ``metrics.jsonl`` in the run workdir."""

    def __init__(self, workdir: Path):
        self.path = Path(workdir) / "metrics.jsonl"

    def log_record(self, record: dict) -> None:
        with self.path.open("a") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def close(self) -> None: ...


def load_tracker(spec: str, workdir: Path, config: dict) -> Tracker | None:
    """Resolve ``module.path:factory`` and instantiate it.

    Failures are logged and swallowed: a broken tracker integration must
    never take down a multi-day training run (the jsonl/TB sinks still
    record everything).
    """
    try:
        mod_name, _, attr = spec.partition(":")
        if not attr:
            raise ValueError(
                f"tracker spec {spec!r} must be 'module.path:factory'"
            )
        factory = getattr(importlib.import_module(mod_name), attr)
        tracker = factory(workdir=workdir, config=config)
        if not isinstance(tracker, Tracker):
            raise TypeError(
                f"{spec} returned {type(tracker).__name__}, which does not "
                "implement log_record()/close()"
            )
        return tracker
    except Exception:
        log.exception("external tracker %r failed to load; continuing "
                      "with jsonl/TB sinks only", spec)
        return None


def build_trackers(workdir: Path, config: dict, spec: str | None) -> list:
    """The runtime's tracker set: jsonl always, plus an optional external."""
    import os

    trackers: list = [JsonlTracker(workdir)]
    spec = spec or os.environ.get("MAESTRO_TRACKER")
    if spec:
        ext = load_tracker(spec, workdir, config)
        if ext is not None:
            trackers.append(ext)
    return trackers
