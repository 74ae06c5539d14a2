"""What the benchmark reads around the program: fenced host spans, CUDA-event
spans of the denoiser, and one profiled unit of work under ``torch.profiler``
(device kernels by name, the busy and idle share of the window, and the
host activity in each idle gap)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch

from .roofline import kernel_class


class Spans:
    """Host spans fenced by ``torch.cuda.synchronize()`` (off: no fences, no
    record), kept in memory by name."""

    def __init__(self, on: bool, device):
        self.on, self.device = on, torch.device(device)
        self.ms: Dict[str, List[float]] = defaultdict(list)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.ms[name].append(1e3 * (time.perf_counter() - t0))

    def wrap(self, fn, name: str):
        def wrapped(*a, **kw):
            with self(name):
                return fn(*a, **kw)
        return wrapped


def profile(work, device) -> dict:
    """``work()`` twice under ``torch.profiler``: first with the device's
    activity alone (kernel ms by name, the device's busy and window
    seconds), then with the host's operations too, whose recording slows the
    host, to attribute each idle gap of the device to the host operation
    that last began before the gap ended."""
    from torch.profiler import ProfilerActivity

    cuda = torch.device(device).type == "cuda"
    if not cuda:
        return _read(_trace(work, device, [ProfilerActivity.CPU]))
    out = _read(_trace(work, device, [ProfilerActivity.CUDA]))
    host = _read(_trace(work, device, [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    out["gaps"] = host["gaps"]
    return out


def _trace(work, device, activities):
    from torch.profiler import profile as tprofile, record_function

    with tprofile(activities=activities) as prof:
        t0 = time.perf_counter()
        with record_function("mvbench.window"):
            work()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    return prof, wall


def _read(traced) -> dict:
    prof, wall = traced
    dev_iv, cpu_ev, window = [], [], None
    kernel_ms: Dict[str, float] = defaultdict(float)
    cuda_type = torch.autograd.DeviceType.CUDA
    # the raw events: building the profiler's event tree would cost minutes
    for e in prof.profiler.kineto_results.events():
        name, t0 = e.name(), e.start_ns() / 1e3
        t1 = t0 + e.duration_ns() / 1e3
        on_device = e.device_type() == cuda_type
        if on_device and e.is_user_annotation():
            continue  # a host range drawn on the device's row, not device work
        if on_device:
            kernel_ms[name] += (t1 - t0) / 1e3
            dev_iv.append((t0, t1))
        elif name == "mvbench.window":
            window = (t0, t1)
        elif not name.startswith(("cu", "Activity Buffer", "mvbench.")):
            cpu_ev.append((t0, name))
    if not dev_iv:
        return {"kernel_ms": dict(kernel_ms), "busy_s": 0.0, "window_s": wall, "gaps": [],
                "device_ops": []}
    if window is None:  # traced without the host: the device's own span, within the wall
        first, last = min(t for t, _ in dev_iv), max(t for _, t in dev_iv)
        window = (last - wall * 1e6, last) if (last - first) < wall * 1e6 else (first, last)
    iv = np.array(sorted(dev_iv), dtype=np.float64)
    iv = iv[(iv[:, 1] > window[0]) & (iv[:, 0] < window[1])]
    iv = np.clip(iv, window[0], window[1])
    # merge overlapping device intervals
    ends = np.maximum.accumulate(iv[:, 1])
    starts_new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    m_start = iv[starts_new, 0]
    m_end = np.append(ends[np.flatnonzero(starts_new)[1:] - 1], ends[-1])
    busy_us = float((m_end - m_start).sum())
    gap_s = np.concatenate([[window[0]], m_end])
    gap_e = np.concatenate([m_start, [window[1]]])
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    cpu_ev.sort()
    c_start = np.array([t for t, _ in cpu_ev], dtype=np.float64)
    names = [n for _, n in cpu_ev]
    idx = np.searchsorted(c_start, gap_e, side="right") - 1
    by_host: Dict[str, float] = defaultdict(float)
    for i, s, e in zip(idx, gap_s, gap_e):
        by_host[names[i] if i >= 0 else "before the first host operation"] += (e - s) / 1e6
    by_class: Dict[str, float] = defaultdict(float)
    for name, ms in kernel_ms.items():
        by_class[kernel_class(name)] += ms / 1e3
    top = lambda d: [[k, float(v)] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"kernel_ms": dict(kernel_ms), "busy_s": busy_us / 1e6,
            "window_s": (window[1] - window[0]) / 1e6, "gaps": top(by_host),
            "device_ops": top(by_class)}
