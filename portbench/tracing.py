"""Reduction of a ``torch.profiler`` trace to device time, idle gaps and kernel times.

The measured window is profiled with CUDA activity alone: recording every
host operation as well slows a host-paced cell's window by some 70%, which
would make the idle share read the profiler.  Device activity (kernels,
copies, sets; annotation ranges left out) is merged into busy intervals
over the traced window, the span of all recorded events; each idle gap
between them is named by the CUDA runtime call the host was in at its
middle, or "host outside CUDA calls" (Python and the framework's dispatch).
"""

from __future__ import annotations

import threading
from collections import defaultdict

import numpy as np

TOP = 10  # entries of each breakdown list
NAMED_GAPS = 50000  # longest gaps named one by one


def events(prof):
    import torch

    out_dev, out_cpu, other = [], [], []
    main = threading.get_native_id()
    for e in prof.profiler.kineto_results.events():
        s, t = e.start_ns(), e.end_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():  # ranges, not work
                out_dev.append((s, t, e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CPU and e.start_thread_id() == main:
            out_cpu.append((s, t, e.name()))
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            other.append((s, t, e.name()))
    return out_dev, (out_cpu or other)  # the main thread's, unless its ids are not native ones


def union(dev, lo: int, hi: int) -> np.ndarray:
    """Merged busy intervals (k, 2) of the device events, clipped to [lo, hi]."""
    if not dev:
        return np.zeros((0, 2), dtype=np.int64)
    iv = np.array([(max(s, lo), min(t, hi)) for s, t, _ in dev if t > lo and s < hi], dtype=np.int64)
    if not len(iv):
        return np.zeros((0, 2), dtype=np.int64)
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    idx = np.nonzero(new)[0]
    stops = ends[np.concatenate([idx[1:] - 1, [len(iv) - 1]])]
    return np.stack([starts, stops], axis=1)


def _gap_names(gaps: np.ndarray, cpu) -> list[str]:
    """The innermost host event (a CUDA runtime call) running at each gap's
    middle, else "host outside CUDA calls"."""
    cpu = sorted(cpu)
    starts = np.array([s for s, _, _ in cpu], dtype=np.int64)
    names = []
    for lo, hi in gaps:
        m = (lo + hi) // 2
        i = int(np.searchsorted(starts, m, side="right")) - 1
        name = "host outside CUDA calls"
        for step in range(64):  # runtime calls do not nest deeply
            if i - step < 0:
                break
            s, t, n = cpu[i - step]
            if t >= m:
                name = n
                break
        names.append(name)
    return names


def reduce_trace(prof) -> dict:
    """busy_s and window_s (the span of all recorded events), the device
    operations that took most time and the longest idle gaps by what the
    host was doing, each as [name, seconds]."""
    dev, cpu = events(prof)
    if not dev:
        raise RuntimeError("the trace holds no device activity")
    lo = min(s for s, _, _ in dev + cpu)
    hi = max(t for _, t, _ in dev + cpu)
    busy = union(dev, lo, hi)
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum())
    by_kernel = defaultdict(int)
    for s, t, n in dev:
        by_kernel[n[:120]] += t - s
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    longest = gaps[np.argsort(gaps[:, 1] - gaps[:, 0])[::-1][:NAMED_GAPS]]
    by_gap = defaultdict(int)
    for (g0, g1), n in zip(longest, _gap_names(longest, cpu)):
        by_gap[n[:120]] += int(g1 - g0)
    top = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": busy_ns / 1e9, "window_s": (hi - lo) / 1e9, "device_ops": top(by_kernel),
            "idle_gaps": top(by_gap)}
