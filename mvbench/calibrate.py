"""The readings from which a serving cell's limits are set.

    python3 -m mvbench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out <file.json>]

For each seed of ``--seeds``, the program as the cell runs it; for each of
``--control-seeds``, the control that the configuration's family gives
(``control``; for the VideoMV families the reference computed in fp8, one
precision below the configuration's bf16) put in the program's place. Each
is a short window at the cell's own load (the requests the check samples),
then the check, all in this process. Prints one JSON line per seed and
writes them all to ``--out``. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

from .run import BENCH_DIR, ROOT, cell_spec, load_json


def main(argv=None, allow_cpu: bool = False) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    from . import weights

    bench = load_json(ROOT, "BENCHMARK.json")
    cell, config, mix, limits, _, _ = cell_spec(bench, args.workload)
    if not allow_cpu and not torch.cuda.is_available():
        print("mvbench.calibrate needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    family = importlib.import_module(f"mvbench.families.{config['family']}")
    driver = importlib.import_module(f"mvbench.{mix['kind']}")
    with torch.device("meta"):
        shapes = family.Program(config, mix, "meta").shapes()
    rows = []
    runs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        make_weights = weights.maker(seed, device, config)
        swap = family.control(config, make_weights(shapes), device) if control else None
        t0 = time.time()
        res = driver.run(cell, config, mix, os.path.join(BENCH_DIR, "traffic"), family, seed,
                         0.0, False, device, time.time(), make_weights, swap_models=swap)
        row = {"seed": seed, "control": control, "readings": res["readings_check"],
               "detail": res["check_detail"],
               "failed": res["failed"], "attempted": res["attempted"],
               "request_s": res["request_s"], "seconds": time.time() - t0,
               "limits": limits}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del swap
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
