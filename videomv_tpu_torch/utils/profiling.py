"""Profiling and timing helpers.

Port of ``videomv_tpu/utils/profiling.py``: a ``torch.profiler`` trace
context that writes a Chrome / Perfetto trace of host and device activity, a
timing helper fenced by ``torch.cuda.synchronize()``, and the device memory
counters. (``time_chained``, the JAX package's workaround for a device
fence that returned early, has no counterpart: CUDA's synchronisation does
not return early.)
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Callable, Dict, Iterator, Optional

import torch

__all__ = ["device_memory_stats", "time_fn", "trace"]


@contextlib.contextmanager
def trace(log_dir: str = "workspace/traces") -> Iterator[str]:
    """Capture a trace of ``with trace(): run_step()``: the host's operators
    and, on a card, its kernels, written to ``<log_dir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 5, **kwargs
            ) -> Dict[str, float]:
    """Wall seconds of ``fn(*args, **kwargs)``, each call fenced by
    ``torch.cuda.synchronize()`` on a card: p50, mean, min and max over
    ``iters`` calls after ``warmup``."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    return {"p50_s": statistics.median(times), "mean_s": statistics.mean(times),
            "min_s": min(times), "max_s": max(times), "iters": iters}


def device_memory_stats(device: Optional[torch.device] = None) -> Dict[str, float]:
    """The card's memory in use, its peak and its size, in GiB (zeros
    without a card)."""
    if not torch.cuda.is_available():
        return {"bytes_in_use_gb": 0.0, "peak_bytes_in_use_gb": 0.0, "bytes_limit_gb": 0.0}
    gb = 1024 ** 3
    return {"bytes_in_use_gb": torch.cuda.memory_allocated(device) / gb,
            "peak_bytes_in_use_gb": torch.cuda.max_memory_allocated(device) / gb,
            "bytes_limit_gb": torch.cuda.get_device_properties(device or 0).total_memory / gb}
