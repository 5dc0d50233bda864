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


def _request_stop(signum, frame):  # noqa: ANN001, ARG001
    if _stop.is_set():  # second signal: give up gracefulness
        raise KeyboardInterrupt
    log.warning(
        "received %s: finishing the current step, checkpointing, and "
        "exiting (resume with run.fit_name/fit_phase)",
        signal.Signals(signum).name,
    )
    _stop.set()


def install_handlers():
    """Route SIGTERM/SIGINT to a stop request; returns the handlers it
    replaced, for ``restore_handlers`` (None when it changed nothing).

    Idempotent, and installed again when other code in the process has taken
    the signals since (a handler it replaced would otherwise get this run's
    stop signal).  Only valid from the main thread (Python restricts
    ``signal.signal``); callers on worker threads get the no-op fallback of
    never stopping early.
    """
    if threading.current_thread() is not threading.main_thread():
        return None
    if signal.getsignal(signal.SIGTERM) is _request_stop:
        return None
    previous = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    signal.signal(signal.SIGTERM, _request_stop)
    signal.signal(signal.SIGINT, _request_stop)
    return previous


def restore_handlers(previous) -> None:
    """Put back the handlers ``install_handlers`` replaced (a run leaves
    none of its own behind)."""
    if previous is None:
        return
    for sig, handler in zip((signal.SIGTERM, signal.SIGINT), previous):
        signal.signal(sig, signal.SIG_DFL if handler is None else handler)


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
