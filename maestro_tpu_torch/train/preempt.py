"""Graceful-preemption handling for long training runs.

The reference has no failure-recovery surface: a preempted Lightning job
dies mid-epoch and loses everything since the last epoch checkpoint boundary.
Cluster schedulers preempt jobs by delivering SIGTERM with a grace window, so
the runtime installs a handler that requests a clean stop: the epoch loop finishes the in-flight
step, saves a full-state checkpoint tagged with the current epoch, and exits.
``run.fit_name=<exp> run.fit_phase=<phase>`` then resumes from it via the
standard name-based discovery (train/checkpoint.py).
"""

from __future__ import annotations

import logging
import signal
import threading

log = logging.getLogger("maestro_tpu_torch")

_stop = threading.Event()
_installed = False


def install_handlers() -> None:
    """Idempotently route SIGTERM/SIGINT to a stop request.

    Only valid from the main thread (Python restricts ``signal.signal``);
    callers on worker threads get the no-op fallback of never stopping early.
    """
    global _installed  # noqa: PLW0603
    if _installed:
        return
    if threading.current_thread() is not threading.main_thread():
        return

    def _request_stop(signum, frame):  # noqa: ANN001, ARG001
        if _stop.is_set():  # second signal: give up gracefulness
            raise KeyboardInterrupt
        log.warning(
            "received %s: finishing the current step, checkpointing, and "
            "exiting (resume with run.fit_name/fit_phase)",
            signal.Signals(signum).name,
        )
        _stop.set()

    signal.signal(signal.SIGTERM, _request_stop)
    signal.signal(signal.SIGINT, _request_stop)
    _installed = True


def stop_requested() -> bool:
    return _stop.is_set()


def reset() -> None:
    """Clear a pending stop request (tests; consecutive experiments)."""
    _stop.clear()


class Preempted(RuntimeError):  # noqa: N818 - a signal, not an error
    """Raised after the preemption checkpoint is written."""

    def __init__(self, phase: str, checkpoint_path: str) -> None:
        super().__init__(
            f"preempted during {phase}; state saved to {checkpoint_path}",
        )
        self.phase = phase
        self.checkpoint_path = checkpoint_path
