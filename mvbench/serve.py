"""The serving driver: one client sends the cell's requests back to back
(a closed loop) through the program's own entry, for ``--seconds``; the
request in flight when the time is up finishes and counts.

``request_s`` is the window's time over its whole requests. ``peak_mem_gib``
is ``max_memory_allocated`` over the window. ``setup_s`` ends once one whole
request at the cell's shapes has run. After the window the peak is read,
the program is freed, and the family's check judges the requests that its
watch recorded.

The window is the same for every family. What a family decides comes from
its module ``mvbench/families/<family>.py`` (``videomv.py`` is the VideoMV
families' shared part), which provides:

- ``Program(config, mix, device)``: the system under test, built as its
  entry serves the mix. ``shapes()`` gives ``{model: [(name, shape)]}`` of
  its weights; ``load(state_dicts)`` takes the seed's weights of those
  shapes; ``request(item)`` serves one request of the mix's pool
  (``traffic.serve_requests``) and returns its answer; ``finite(answer)``
  says whether the answer is finite (a request that raises, or whose
  answer is not, counts as failed); ``swap(models)`` puts the control's
  models in the place of its own (``mvbench/calibrate.py``).
- ``Watch(program, config, mix, seed, spans, trace)``: what the benchmark
  records of the program and how the record is judged. The window sets
  ``on`` while the requests it records run (the warm-up and the window),
  calls ``begin(j)`` and ``end()`` around request j (``None``: the warm-up),
  takes ``readings()`` into a traced window's readings, calls ``close()``
  before it frees the program, and ``check(state_dicts, items, outputs,
  device)`` returns the numbers compared, ``{name: reading}``, each held
  to ``mvbench/limits/<cell>.json``, and the detail.
- ``work(config, mix)``: ``{"flops", "calls"}`` of one request, read by
  ``mvbench/run.py`` in a traced run for the per-layer readers.
- ``control(config, state_dicts, device)``: the control's models, for
  ``swap`` (``mvbench/calibrate.py``).

With ``--trace 1`` the window's spans are on (the family's watch opens
them around the layers it names); then one whole request runs under
``torch.profiler``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .traffic import serve_requests
from .tracing import Spans, profile

GIB = float(1 << 30)


def run(cell: dict, config: dict, mix: dict, mix_dir: str, family, seed: int, seconds: float,
        trace: bool, device, started: float, make_weights, swap_models=None) -> dict:
    """One run of a serving cell; returns the result's fields and, with
    ``trace``, the readings the per-layer metrics take. ``make_weights(shapes)``
    gives the seed's state dicts for the program's models; the program loads
    them and the benchmark keeps no copy on the device while the program
    runs. ``swap_models`` (the control) puts other modules in the place of
    the program's."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    marks = {"start_to_run": time.time() - started}
    program = family.Program(config, mix, device)
    shapes = program.shapes()
    program.load(make_weights(shapes))
    gc.collect()
    marks["program_built"] = time.time() - started
    if swap_models is not None:
        program.swap(swap_models)
    items = serve_requests(mix, mix_dir, seed)
    spans = Spans(trace, device)
    k = int(mix["check"]["requests"])
    watch = family.Watch(program, config, mix, seed, spans, trace)

    # set-up ends with one whole request at the cell's shapes, recorded so
    # that the watch's host buffers are made before the window
    spans.on, watch.on = False, True
    watch.begin(None)
    program.request(items[0])
    watch.end()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started
    marks["warmed"] = setup_s

    spans.on = trace
    outputs, failed, n, ends = [], 0, 0, []
    t0 = time.perf_counter()
    while True:
        item = items[n % len(items)]
        watch.begin(n)
        n += 1
        try:
            out = program.request(item)
            ok = program.finite(out)
        except Exception as exc:  # a request that raises counts as failed; the loop goes on
            print(f"request {n - 1} raised: {exc!r}", flush=True)
            out, ok = None, False
        watch.end()
        failed += not ok
        outputs.append(out)
        ends.append(time.perf_counter() - t0)
        if time.perf_counter() - t0 >= seconds and n >= k:
            break
    window_s = time.perf_counter() - t0
    watch.on = False
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    res = {"attempted": n, "failed": failed, "request_s": window_s / n,
           "each_s": list(np.diff([0.0] + ends)),
           "peak_mem_gib": peak / GIB, "setup_s": setup_s, "memory_peak_bytes": peak,
           "setup_marks": marks}

    if trace:
        spans.on = False
        res["readings"] = {"spans": {k: list(v) for k, v in spans.ms.items()},
                           "request_s": window_s / n, "requests": n, **watch.readings()}
        item = items[n % len(items)]
        from videomv_tpu_torch import ops

        ops.reset_launch_counts()
        res["profile"] = profile(lambda: program.request(item), device)
        print(f"mvbench: the program's kernel launches in the two profiled passes of a request: "
              f"{ops.launch_counts()}; by shape: {ops.launch_counts_by_shape()}", flush=True)
    watch.close()
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t1 = time.perf_counter()
    res["readings_check"], res["check_detail"] = watch.check(
        make_weights(shapes), [items[j % len(items)] for j in range(n)], outputs, device)
    res["check_s"] = time.perf_counter() - t1
    return res
