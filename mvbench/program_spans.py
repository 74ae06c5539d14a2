"""What the per-layer metrics named ``*_dev_ms.serve`` read: the spans that
the program records itself (``videomv_tpu_torch.utils.profiling``), in the
first request whose record it holds. Under ``--trace 1`` that is the first
profiled pass of a request, the one with the device's activity alone: the
warm-up and the window run with no profiler, so the program records nothing
there. A span's device milliseconds are the time between its two CUDA events
on the stream. A program that records no such spans gives these metrics
nothing to read (``None``), and nothing here raises for it."""

from __future__ import annotations

from typing import Callable, List, Optional


def first_request() -> Optional[dict]:
    try:
        from videomv_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "requests", None)
    records = read() if read is not None else []
    return records[0] if records else None


def dev_ms(match: Callable[[dict], bool]) -> List[float]:
    """The device ms of each span of the first request that ``match`` takes."""
    rec = first_request()
    return [s["dev_ms"] for s in rec["spans"] if match(s)] if rec is not None else []


def named(name: str) -> Callable[[dict], bool]:
    return lambda s: s["name"] == name


def mean(ms: List[float]) -> Optional[float]:
    return sum(ms) / len(ms) if ms else None
