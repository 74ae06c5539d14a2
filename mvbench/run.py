"""Run one cell of the benchmark once.

    python3 -m mvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell; the harness
finds everything else by name: the configuration's file, the traffic mix
``mvbench/traffic/<traffic>.json``, its driver ``mvbench/<kind>.py``, the
configuration's family ``mvbench/families/<family>.py``, the limits of the
cell's check ``mvbench/limits/<cell>.json`` and each per-layer metric's
reader ``mvbench/metrics/<metric>.py``. The last line of standard output is
the result, one JSON object; the numbers the check compared, each beside its
limit, end standard error and the result.

Of the configuration this file reads only ``family``. The family module
decides the rest: the program and how it serves a request, what the
benchmark records of it, the check against the plain reference, and the
work of one unit, ``work(config, mix)`` → ``{"flops", "calls"}``, which a
traced run hands to the per-layer readers as ``r["work"]``. A serving
family provides what ``mvbench/serve.py``'s docstring lists. A mix of
another kind (a training step) brings its driver ``mvbench/<kind>.py``,
whose ``run`` returns the same fields as ``serve.run``.

A new cell is added as files and appended entries only, with no file
edited: its configuration under ``configs/``, its mix under ``traffic/``
(unless it reuses one), its limits under ``limits/``, a reader under
``metrics/`` for each new per-layer metric, its reference under
``reference/`` and its family module (unless its family exists); then an
entry appended to ``configs``, ``workloads`` and ``per_layer`` of
``BENCHMARK.json``, and its name appended to the ``workloads`` list of each
end-to-end metric and per-layer metric it reports (``request_s`` for a
serving cell).

It needs as many CUDA devices as the cell asks for, and exits with an error
and no result without them. After the window it checks that no module of
JAX or of the JAX package was loaded in this process.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "mvbench")
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "videomv_tpu"})


def process_start() -> float:
    """The wall time at which this process started (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``videomv_tpu_torch`` is not ``videomv_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_reader(name: str):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"mvbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_spec(bench: dict, workload: str):
    """The cell, its configuration, its traffic mix, its metrics and limits."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT, conf["file"])
    mix = load_json(BENCH_DIR, "traffic", cell["traffic"] + ".json")
    limits = load_json(BENCH_DIR, "limits", workload + ".json")

    def mine(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    per_layer = [m for m in bench["per_layer"] if mine(m)]
    return cell, config, mix, limits, e2e, per_layer


def main(argv: Optional[list] = None, allow_cpu: bool = False) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the build and kernel caches stay inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "mvbench", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "mvbench", "triton")

    bench = load_json(ROOT, "BENCHMARK.json")
    cell, config, mix, limits, e2e, per_layer = cell_spec(bench, args.workload)

    import torch

    imported = time.time() - started
    chips = int(cell["chips"])
    if not allow_cpu and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"mvbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")

    from . import weights

    family = importlib.import_module(f"mvbench.families.{config['family']}")
    driver = importlib.import_module(f"mvbench.{mix['kind']}")
    make_weights = weights.maker(args.seed, device, config)

    res = driver.run(cell, config, mix, os.path.join(BENCH_DIR, "traffic"), family, args.seed,
                     args.seconds, bool(args.trace), device, started, make_weights)
    res["setup_marks"]["torch_imported"] = imported

    print(f"mvbench: {args.workload} seed {args.seed}: setup_s {res['setup_s']:.3f}, "
          f"{res['attempted']} requests at {res['request_s']:.4f} s, peak "
          f"{res['peak_mem_gib']:.3f} GiB (each {[round(float(x), 3) for x in res['each_s']]}), "
          f"set-up marks {res['setup_marks']}, "
          f"check {res['check_s']:.1f} s, readings "
          f"{res['readings_check']}", file=sys.stderr, flush=True)
    checks = {k: {"value": v, "limit": float(limits[k])}
              for k, v in res["readings_check"].items()}
    correct = res["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips, "memory_peak_bytes": int(res["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": {}, "device": dev}
    if not args.trace:
        for m in e2e:
            result["metrics"][m["name"]] = {"value": float(res[m["name"]]), "unit": m["unit"]}
    else:
        prof = res["profile"]
        dev["busy_s"], dev["window_s"] = float(prof["busy_s"]), float(prof["window_s"])
        r = dict(res["readings"], profile=prof, cell=args.workload, work=family.work(config, mix))
        for m in per_layer:
            value = load_reader(m["name"])(r)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["gaps"]}
        print(f"mvbench: profiled request, kernel ms by name (top 15): " + json.dumps(
            sorted(prof["kernel_ms"].items(), key=lambda kv: -kv[1])[:15]), flush=True)
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        print(f"mvbench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
