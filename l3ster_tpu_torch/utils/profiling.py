"""Profiling and tracing instrumentation (PyTorch port of ``l3ster_tpu.utils.profiling``).

Analog of the reference's compile-time-optional Caliper annotations
(``util/Caliper.hpp:4-13``): named phase regions wall-clocked into a
process-wide accumulator, shown as ``torch.profiler`` ranges when tracing.
Phase fences (``torch.cuda.synchronize`` on the devices of the tensors named)
replace the reference's per-phase MPI barriers, so wall time is
attributable.

Enable with ``L3STER_TPU_PROFILE=1``: every instrumented phase accumulates
(count, total wall s), regions fence the tensors they are given and open a
``torch.profiler.record_function`` range, and a table prints to stderr at
process exit.  Programmatic access: :func:`profile_report`,
:func:`profile_reset`.  :func:`start_trace`/:func:`stop_trace` capture a
``torch.profiler`` trace (CPU and, on a card, CUDA activity) and write it
as a Chrome trace file into a directory.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import sys
import time

import torch

__all__ = [
    "profile_region",
    "profile_enabled",
    "profile_report",
    "profile_reset",
    "phase_fence",
    "start_trace",
    "stop_trace",
    "Timer",
]

_PROFILE = os.environ.get("L3STER_TPU_PROFILE", "0") not in ("0", "", "false")

# name -> [count, total_seconds]; insertion-ordered = first-seen order
_ACC: dict[str, list] = {}
_TRACE: dict = {}


def profile_enabled() -> bool:
    return _PROFILE


def _record(name: str, dt: float) -> None:
    slot = _ACC.get(name)
    if slot is None:
        _ACC[name] = [1, dt]
    else:
        slot[0] += 1
        slot[1] += dt


@contextlib.contextmanager
def profile_region(name: str, *fence_tensors):
    """Named phase region.  Wall-clock accounting is always on (call sites
    are per phase, never per iteration); with ``L3STER_TPU_PROFILE=1`` the
    region also fences the given tensors on exit (device time is charged to
    the phase that queued it) and opens a ``torch.profiler`` range."""
    if not _PROFILE:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _record(name, time.perf_counter() - t0)
        return
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            phase_fence(*fence_tensors)
            _record(name, time.perf_counter() - t0)


def profile_report(reset: bool = False) -> str:
    """Per-phase table: count, total, mean, sorted by total descending."""
    rows = sorted(_ACC.items(), key=lambda kv: -kv[1][1])
    lines = [f"{'phase':44s} {'count':>7s} {'total s':>10s} {'mean ms':>10s}"]
    for name, (n, tot) in rows:
        lines.append(f"{name:44s} {n:7d} {tot:10.3f} {tot / n * 1e3:10.2f}")
    if reset:
        profile_reset()
    return "\n".join(lines)


def profile_reset() -> None:
    _ACC.clear()


if _PROFILE:

    @atexit.register
    def _dump_profile():  # pragma: no cover - runs at interpreter exit
        if _ACC:
            print("== l3ster_tpu_torch phase profile ==", file=sys.stderr)
            print(profile_report(), file=sys.stderr)


def phase_fence(*tensors) -> None:
    """Wait for the work queued on the CUDA devices of the given tensors."""
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


def start_trace(log_dir: str) -> None:
    """Start a ``torch.profiler`` capture (CPU, and CUDA when available)."""
    if _TRACE:
        raise RuntimeError("a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _TRACE.update(prof=prof, log_dir=log_dir)


def stop_trace() -> str:
    """Stop the capture and write it as ``<log_dir>/trace.json``; returns the path."""
    if not _TRACE:
        raise RuntimeError("no trace is running")
    prof, log_dir = _TRACE.pop("prof"), _TRACE.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


class Timer:
    """Wall-clock phase timer with device fencing."""

    def __init__(self):
        self.laps: dict[str, float] = {}
        self._t0 = time.perf_counter()

    def lap(self, name: str, *fence_tensors) -> float:
        phase_fence(*fence_tensors)
        now = time.perf_counter()
        dt = now - self._t0
        self.laps[name] = self.laps.get(name, 0.0) + dt
        self._t0 = now
        return dt

    def report(self) -> str:
        total = sum(self.laps.values())
        lines = [f"{k:30s} {v * 1e3:10.2f} ms" for k, v in self.laps.items()]
        lines.append(f"{'total':30s} {total * 1e3:10.2f} ms")
        return "\n".join(lines)
