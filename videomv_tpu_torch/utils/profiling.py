"""Profiling, tracing and the program's counters.

Port of ``videomv_tpu/utils/profiling.py``: a ``torch.profiler`` trace
context that writes a Chrome / Perfetto trace of host and device activity,
and the device memory counters. (``time_chained``, the JAX package's
workaround for a device fence that returned early, has no counterpart: CUDA's
synchronisation does not return early.)

Beside them, the program's own record of where a request's time goes:

- ``span(name, **attrs)`` marks a place where work happens. While tracing
  is off it tests one flag and does nothing else. While tracing is on it
  opens a ``torch.profiler.record_function`` range of its name, so that the
  span sits on the profiler's clock beside the kernels it launched; inside
  a request it also records its host start and end (``perf_counter_ns``),
  its parent span, the request's id and, on a CUDA device, a start and an
  end ``torch.cuda.Event`` on the current stream, taken from a pool. Nothing
  synchronises. On the CPU a span's device time is its host time.
- ``request(name, device)`` opens the root span of one request. When it
  closes, the request's record (its spans, the counters' deltas over its
  time, its id) goes into a deque of the last ``KEEP`` requests, which ``requests()``
  returns: the events are read there, after one ``synchronize()``.
- ``count(name, n=1, shape=None)`` is the counter registry. Host counts are
  always on (the kernels' launch counters are among them). A count that the
  device holds (a tensor) is kept only while tracing, in the open request's
  record, and is read with it. ``snapshot`` / ``counts_since`` take what a
  piece of work counted, and ``add_counts`` counts it again where that work
  is replayed without its host code (a CUDA graph).
- ``idle_by_span(prof)`` charges each idle gap of the device in a finished
  ``torch.profiler`` run to the innermost span open on the host when the
  kernel that ends the gap was launched.

Tracing is on while a ``torch.profiler`` records, or after ``enable()``.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional

import torch

__all__ = ["KEEP", "Event", "active", "add_counts", "clear", "count", "counts",
           "counts_by_shape", "counts_since", "device_memory_stats", "enable", "idle_by_span",
           "request", "requests", "reset_counts", "snapshot", "span", "summarize", "trace"]

KEEP = 64  # requests the deque holds
OUTSIDE = "(no span)"  # where idle_by_span puts a gap that no span was open for

_ENABLED = False
_COUNTS: Dict[str, int] = defaultdict(int)
_BY_SHAPE: Dict[str, Dict[tuple, int]] = defaultdict(lambda: defaultdict(int))
_REQUESTS: deque = deque(maxlen=KEEP)
_EVENTS: List[torch.cuda.Event] = []  # timing events no record holds
_NAMES: set = set()  # every span name opened while tracing
_IDS = itertools.count(1)
_LOCAL = threading.local()  # .rec: the record of this thread's open request
_LOCK = threading.Lock()  # the counters and the deque, which every thread shares
_profiler_enabled = torch._C._autograd._profiler_enabled


@contextlib.contextmanager
def trace(log_dir: str = "workspace/traces") -> Iterator[torch.profiler.profile]:
    """Capture a trace of ``with trace() as prof: run_step()``: the host's
    operators, the program's spans and, on a card, its kernels, written to
    ``<log_dir>/trace.json``. ``prof`` is the finished run once the block
    has closed (``idle_by_span(prof)``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device: Optional[torch.device] = None) -> Dict[str, float]:
    """The card's memory in use, its peak and its size, in GiB (zeros
    without a card)."""
    if not torch.cuda.is_available():
        return {"bytes_in_use_gb": 0.0, "peak_bytes_in_use_gb": 0.0, "bytes_limit_gb": 0.0}
    gb = 1024 ** 3
    return {"bytes_in_use_gb": torch.cuda.memory_allocated(device) / gb,
            "peak_bytes_in_use_gb": torch.cuda.max_memory_allocated(device) / gb,
            "bytes_limit_gb": torch.cuda.get_device_properties(device or 0).total_memory / gb}


# ------------------------------------------------------------------ counters

def count(name: str, n=1, shape: Optional[tuple] = None) -> None:
    """Add ``n`` to the counter ``name`` (and to its entry for ``shape``).
    A tensor ``n`` is a count the device holds: it is kept, unread, in the
    open request's record while tracing and dropped otherwise."""
    if isinstance(n, torch.Tensor):
        rec = getattr(_LOCAL, "rec", None)
        if rec is not None:
            rec.tensors[name].append(n.detach())
        return
    with _LOCK:
        _COUNTS[name] += n
        if shape is not None:
            _BY_SHAPE[name][shape] += n


def counts() -> Dict[str, int]:
    """Every host counter's total since its last reset."""
    with _LOCK:
        return dict(_COUNTS)


def counts_by_shape(name: str) -> Dict[tuple, int]:
    """The counter ``name`` split by the shapes it was counted with."""
    with _LOCK:
        return dict(_BY_SHAPE.get(name, {}))


def reset_counts(names: Optional[Iterable[str]] = None) -> None:
    """Zero the named counters (all of them without ``names``)."""
    with _LOCK:
        for name in list(_COUNTS) if names is None else names:
            _COUNTS.pop(name, None)
            _BY_SHAPE.pop(name, None)


def snapshot() -> Dict[tuple, int]:
    """Every host count, keyed ``(name, None)`` for a counter's total and
    ``(name, shape)`` for its count of one shape (``counts_since``)."""
    with _LOCK:
        out = {(k, None): v for k, v in _COUNTS.items()}
        out.update(((k, s), v) for k, by in _BY_SHAPE.items() for s, v in by.items())
    return out


def counts_since(before: Dict[tuple, int]) -> Dict[tuple, int]:
    """The host counts made since ``before = snapshot()``, keyed as it is;
    ``add_counts`` adds them again (work whose launches are replayed)."""
    return {k: v - before.get(k, 0) for k, v in snapshot().items() if v != before.get(k, 0)}


def add_counts(delta: Dict[tuple, int]) -> None:
    """Add ``counts_since``'s counts to the counters, totals and shapes."""
    with _LOCK:
        for (name, shape), n in delta.items():
            if shape is None:
                _COUNTS[name] += n
            else:
                _BY_SHAPE[name][shape] += n


# --------------------------------------------------------------------- spans

def enable(on: bool = True) -> None:
    """Trace every request from now on (``False``: only while a
    ``torch.profiler`` records)."""
    global _ENABLED
    _ENABLED = bool(on)


def active() -> bool:
    """Whether spans record: after ``enable()`` or while a profiler runs."""
    return _ENABLED or _profiler_enabled()


def _event() -> torch.cuda.Event:
    try:
        return _EVENTS.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


class _Record:
    """One request's spans and counts while it runs, then its record."""

    def __init__(self, name: str, device):
        self.id, self.name = next(_IDS), name
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.cuda = self.device.type == "cuda"
        self.spans: List[dict] = []
        self.stack: List[int] = []  # the open spans, outermost first
        self.tensors: Dict[str, list] = defaultdict(list)
        self.before = counts()
        self.counts: Dict[str, int] = {}
        self.resolved = False

    def open(self, name: str, attrs: dict) -> None:
        s = {"name": name, "parent": self.stack[-1] if self.stack else -1, "request": self.id,
             "attrs": attrs, "start_ns": time.perf_counter_ns()}
        if self.cuda:
            s["_events"] = (_event(), _event())
            s["_events"][0].record(torch.cuda.current_stream(self.device))
        self.stack.append(len(self.spans))
        self.spans.append(s)

    def close(self) -> None:
        s = self.spans[self.stack.pop()]
        if self.cuda:
            s["_events"][1].record(torch.cuda.current_stream(self.device))
        s["end_ns"] = time.perf_counter_ns()

    def finish(self) -> None:
        self.counts = {k: v - self.before.get(k, 0) for k, v in counts().items()
                       if v != self.before.get(k, 0)}
        del self.before

    def release(self) -> None:
        """Give the events back to the pool (the record is read or gone)."""
        for s in self.spans:
            _EVENTS.extend(s.pop("_events", ()))

    def resolve(self) -> dict:
        if not self.resolved:
            for s in self.spans:
                s["host_ms"] = (s["end_ns"] - s["start_ns"]) / 1e6
                ev = s.get("_events")
                s["dev_ms"] = ev[0].elapsed_time(ev[1]) if ev else s["host_ms"]
            self.release()
            for name, ts in self.tensors.items():
                self.counts[name] = self.counts.get(name, 0) + sum(int(t.sum()) for t in ts)
            self.tensors.clear()
            self.resolved = True
        return {"id": self.id, "name": self.name, "device": str(self.device),
                "spans": self.spans, "counts": self.counts}


class _Span:
    __slots__ = ("name", "attrs", "_range", "_rec")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        _NAMES.add(self.name)
        self._range = torch.autograd.profiler.record_function(self.name)
        self._range.__enter__()
        self._rec = getattr(_LOCAL, "rec", None)
        if self._rec is not None:
            self._rec.open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.close()
        self._range.__exit__(*exc)
        return False


class _Request(_Span):
    __slots__ = ("device",)

    def __init__(self, name: str, device):
        super().__init__(name, {})
        self.device = device

    def __enter__(self):
        _LOCAL.rec = _Record(self.name, self.device)
        count("requests")
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        rec, _LOCAL.rec = self._rec, None
        rec.finish()
        with _LOCK:
            if len(_REQUESTS) == _REQUESTS.maxlen:
                _REQUESTS[0].release()
            _REQUESTS.append(rec)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager around the work of ``name`` (module docstring)."""
    if not (_ENABLED or _profiler_enabled()):
        return _OFF
    return _Span(name, attrs)


def request(name: str = "pipeline.request", device=None):
    """The root span of one request on ``device`` (module docstring). Counts
    ``requests``. Inside an open request it is a plain span."""
    if not (_ENABLED or _profiler_enabled()):
        count("requests")
        return _OFF
    if getattr(_LOCAL, "rec", None) is not None:
        return _Span(name, {})
    return _Request(name, device)


def requests() -> List[dict]:
    """The records of the last ``KEEP`` traced requests, oldest first:
    ``{"id", "name", "device", "spans", "counts"}``. Each span is ``{"name",
    "parent"`` (its parent's index in ``spans``, -1 for the root)``,
    "request", "attrs", "start_ns", "end_ns", "host_ms", "dev_ms"}``; the
    counts are the request's deltas, the device's counts included. Reading
    them synchronises each CUDA device once."""
    with _LOCK:
        recs = list(_REQUESTS)
    for dev in {r.device for r in recs if r.cuda and not r.resolved}:
        torch.cuda.synchronize(dev)
    return [r.resolve() for r in recs]


def clear() -> None:
    """Drop every kept record."""
    with _LOCK:
        while _REQUESTS:
            _REQUESTS.popleft().release()


def summarize(record: dict) -> Dict[str, dict]:
    """A record's spans by name: ``{"n", "host_ms", "dev_ms"}`` summed."""
    out: Dict[str, dict] = {}
    for s in record["spans"]:
        d = out.setdefault(s["name"], {"n": 0, "host_ms": 0.0, "dev_ms": 0.0})
        d["n"] += 1
        d["host_ms"] += s["host_ms"]
        d["dev_ms"] += s["dev_ms"]
    return out


# ------------------------------------------------------------- idle by span

class Event(NamedTuple):
    """One event of a profiler run, in microseconds on the profiler's clock:
    a device activity (``on_device``), a host range of ``record_function``
    (``annotation``), or another host event; ``correlation`` links a CUDA
    launch on the host to the activity it launched (0: none)."""
    name: str
    start_us: float
    end_us: float
    on_device: bool
    annotation: bool
    correlation: int


def _events(prof) -> List[Event]:
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    # the raw events: building the profiler's event tree would cost minutes
    for e in prof.profiler.kineto_results.events():
        t0 = e.start_ns() / 1e3
        out.append(Event(e.name(), t0, t0 + e.duration_ns() / 1e3, e.device_type() == cuda,
                         e.is_user_annotation(), e.correlation_id()))
    return out


def _innermost(spans: List[tuple]):
    """``spans`` [(start, end, name)] → (times, names): the innermost span
    open from ``times[i]`` until ``times[i + 1]`` is ``names[i]`` (the one
    that began last, of two that began together the one that ends first;
    ``OUTSIDE`` where none is open)."""
    edges = sorted({t for s in spans for t in s[:2]})
    by_start = sorted(spans)
    names, open_, j = [], [], 0
    for t in edges:
        while j < len(by_start) and by_start[j][0] <= t:
            open_.append(by_start[j])
            j += 1
        open_ = [s for s in open_ if s[1] > t]
        names.append(max(open_, key=lambda s: (s[0], -s[1]))[2] if open_ else OUTSIDE)
    return edges, names


def idle_by_span(prof, names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Seconds the device was idle, by the span that held the host: each gap
    between device activities, within the extent of the spans, goes to the
    innermost span open when the activity that ends the gap was launched (its
    CUDA launch on the host, found by correlation id; where there is none, at
    the gap's end). The gap after the last activity goes to the span open at
    its end. ``prof``: a finished ``torch.profiler`` run, or a list of
    ``Event``; ``names``: the span names to read (default: every name this
    process has opened while tracing). Largest first; empty without device
    activity."""
    events = list(prof) if isinstance(prof, (list, tuple)) else _events(prof)
    names = set(_NAMES if names is None else names)
    work = sorted((e.start_us, e.end_us, e.correlation) for e in events
                  if e.on_device and not e.annotation)
    spans = [(e.start_us, e.end_us, e.name) for e in events
             if not e.on_device and e.annotation and e.name in names]
    if not work:
        return {}
    launched = {e.correlation: e.start_us for e in events
                if not e.on_device and not e.annotation and e.correlation
                and e.name.startswith("cu")}
    lo = min(s[0] for s in spans) if spans else work[0][0]
    hi = max(s[1] for s in spans) if spans else max(w[1] for w in work)
    edges, span_names = _innermost(spans)

    def held(t):
        i = bisect.bisect_right(edges, t) - 1
        return span_names[i] if i >= 0 else OUTSIDE

    idle: Dict[str, float] = defaultdict(float)
    free = lo  # the device is idle from here until the next activity starts
    for start, end, corr in work:
        if end <= lo:
            continue
        if start >= hi:
            break
        if start > free:
            idle[held(launched.get(corr, start))] += (start - free) / 1e6
        free = max(free, end)
    if hi > free:
        idle[held(hi - 1e-3)] += (hi - free) / 1e6
    return dict(sorted(idle.items(), key=lambda kv: -kv[1]))
