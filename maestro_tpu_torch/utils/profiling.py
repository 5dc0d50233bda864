"""Profiling and timing utilities.

``trace`` profiles a block with ``torch.profiler`` (optionally writing a
Chrome trace that TensorBoard's profiler plugin or Perfetto can read) and
``device_busy_ms`` sums the device time it saw; ``StepTimer`` times steps
with CUDA events (host clock on the CPU) to substantiate throughput and MFU
numbers; ``compiled_flops`` counts the FLOPs of one call with
``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str | Path | None = None):
    """Profile the block with ``torch.profiler`` and yield the profiler: the
    device's activity on a CUDA host (the host's operators are left out:
    tracing them slows the host the trace should show), the CPU's operators
    elsewhere.  With a ``logdir``, write one Chrome trace file there."""
    cuda = torch.profiler.ProfilerActivity.CUDA
    activities = [cuda if torch.cuda.is_available() else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        logdir = Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(logdir / f"trace_{int(time.time())}.json"))


def device_busy_ms(prof) -> float:
    """Milliseconds the device spent in kernels and copies under a finished
    ``trace``: the device events' own time (the host operators' rows repeat
    their kernels' time, and so do the device spans of user annotations)."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)) / 1e3


@dataclass
class StepTimer:
    """Step timing with warmup; feeds throughput/MFU reporting.

    On a CUDA device each step is bracketed by CUDA events on the current
    stream, so the time is the device's; ``stop`` waits for the end event.
    Elsewhere the host clock is read around the step."""

    warmup: int = 3
    device: str | torch.device = "cuda"
    _times: list[float] = field(default_factory=list)
    _start: object | None = None
    _steps_seen: int = 0

    def _on_cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def start(self) -> None:
        if self._on_cuda():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def stop(self, result=None) -> float | None:
        """Stop the step timer; the step's seconds (after its work ends)."""
        if self._start is None:
            return None
        if self._on_cuda():
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._start
        self._steps_seen += 1
        if self._steps_seen > self.warmup:
            self._times.append(dt)
        self._start = None
        return dt

    @property
    def mean_step_s(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def throughput(self, items_per_step: int) -> float:
        dt = self.mean_step_s
        return items_per_step / dt if dt else 0.0

    def mfu(self, flops_per_step: float, peak_flops: float) -> float:
        dt = self.mean_step_s
        return flops_per_step / dt / peak_flops if dt else 0.0


def compiled_flops(fn, *args) -> float:
    """FLOPs of one call ``fn(*args)`` by ``FlopCounterMode``: the aten
    operators it counts (the port's own CUDA kernels are not among them)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())
