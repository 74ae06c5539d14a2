"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric added as new files and entries to a copy of the benchmark
run on the CPU with no file edited, and so does a configuration of a model
family that is not VideoMV's (``new_family/``). Every name and unit of
``BENCHMARK.json`` keeps to the allowed characters, every name finds its
files, and each per-layer metric's ``moves`` is reported by every cell it
lists. In a directory without the program the harness prints no result."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from mvbench.tests import cpu_run

REPO = cpu_run.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# the tiny cell's limits, between its program's readings on the CPU and the
# control's (test_mvbench_control.py)
TINY_LIMITS = {"cond": 0.02, "step": 0.2, "frames": 0.02, "lgm_in": 0.03, "lgm": 0.1,
               "refine": 0.08, "missing": 0}


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_files_keep_to_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics] + [c["name"] for c in b["configs"]] + \
        [w["name"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(REPO, c["file"]))
    for w in b["workloads"]:
        assert os.path.isfile(os.path.join(REPO, "mvbench", "traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(REPO, "mvbench", "limits", w["name"] + ".json"))
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(REPO, "mvbench", "metrics", m["name"] + ".py"))


def test_every_listed_cell_reports_what_its_metrics_move():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for m in b["per_layer"]:
        for w in m.get("workloads", cells):
            assert w in cells and w in e2e[m["moves"]], (m["name"], w)
    for w in cells:  # setup_s, one more end-to-end metric and one per-layer metric each
        assert sum(w in s for s in e2e.values()) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])


DUMMY_METRIC = '''"""Requests the traced window finished (a test's metric)."""


def read(r):
    return float(r["requests"])
'''


def test_a_configuration_mix_and_metric_added_as_files_run_on_the_cpu(tmp_path):
    root = cpu_run.make_copy(str(tmp_path / "copy"))
    cfg = cpu_run.tiny_config("tiny")
    with open(os.path.join(root, "mvbench", "traffic", "prompt_refined.json")) as f:
        mix = json.load(f)
    mix.update(pool=3, check={"requests": 2, "steps": 2})
    with open(os.path.join(root, "mvbench", "traffic", "tiny_prompts.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "mvbench", "metrics", "test.requests.serve.py"), "w") as f:
        f.write(DUMMY_METRIC)
    metric = {"name": "test.requests.serve", "unit": "requests", "better": "higher",
              "source": "host_clock", "layer": "pipeline", "moves": "request_s",
              "workloads": ["tiny.serve"]}
    cpu_run.add_cell(root, "tiny.serve", cfg, "tiny_prompts", TINY_LIMITS, [metric],
                     like="t2v.serve_refined")
    before = {p: open(os.path.join(REPO, p), "rb").read() for p in ("BENCHMARK.json",)}
    args = ["--workload", "tiny.serve", "--seed", str(2 ** 33 + 5), "--seconds", "1"]
    res = cpu_run.result_of(cpu_run.run_harness(root, os.path.join(
        root, "mvbench", "configs", "tiny.json"), args + ["--trace", "0"]))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {"request_s", "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(TINY_LIMITS)
    traced = cpu_run.result_of(cpu_run.run_harness(root, os.path.join(
        root, "mvbench", "configs", "tiny.json"), args + ["--trace", "1"]))
    assert traced["metrics"]["test.requests.serve"]["value"] >= 2
    assert "refine.step_ms.serve" in traced["metrics"]
    assert {p: open(os.path.join(REPO, p), "rb").read() for p in before} == before


NEW_FAMILY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "new_family")
# one request of the tiny Euler family: 4 steps of its denoiser (an embedding
# of 33 → 32 and convolutions 4 → 32 → 32 → 4, 3×3 at 16²), 2·MAC each
TINY_EULER_MFLOP = 4 * 2 * (33 * 32 + 256 * 9 * (4 * 32 + 32 * 32 + 32 * 4)) / 1e6
NEW_FAMILY_FAULTS = {
    "none": "",
    "step_returns_its_state": """
import mvbench.families.tiny_euler as f
f.euler_step = lambda x, d, s0, s1: x
""",
}


def _add_new_family(root):
    """The tiny Euler family's files copied in as new files under the
    directories of the same names; its entries appended to ``BENCHMARK.json``."""
    for sub in sorted(os.listdir(NEW_FAMILY)):
        for name in sorted(os.listdir(os.path.join(NEW_FAMILY, sub))):
            if name == "__pycache__":
                continue
            dst = os.path.join(root, "mvbench", sub, name)
            assert not os.path.exists(dst), dst
            shutil.copy(os.path.join(NEW_FAMILY, sub, name), dst)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_euler", "source": "https://arxiv.org/abs/2206.00364",
                             "file": "mvbench/configs/tiny_euler.json", "reduced": [],
                             "why": "a tiny denoiser under a 4-step Euler sampler (a test's)"})
    bench["workloads"].append({"name": "tiny_euler.serve", "config": "tiny_euler",
                               "traffic": "tiny_noise", "chips": 1,
                               "why": "one client, closed loop, no refine (a test's cell)"})
    next(m for m in bench["end_to_end"] if m["name"] == "request_s")["workloads"].append(
        "tiny_euler.serve")
    bench["per_layer"].append({"name": "tiny_euler.work_mflop.serve", "unit": "MFLOP",
                               "better": "lower", "source": "program_counter",
                               "layer": "models", "moves": "request_s",
                               "workloads": ["tiny_euler.serve"]})
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)


@pytest.fixture(scope="module")
def new_family_copy(tmp_path_factory):
    root = cpu_run.make_copy(str(tmp_path_factory.mktemp("new_family")))
    _add_new_family(root)
    return root


@pytest.mark.parametrize("fault", sorted(NEW_FAMILY_FAULTS))
def test_a_new_model_family_added_as_files_runs_and_its_check_fails_a_fault(new_family_copy,
                                                                           fault):
    args = ["--workload", "tiny_euler.serve", "--seed", str(2 ** 33 + 11), "--seconds", "0.5"]
    res = cpu_run.result_of(cpu_run.run_harness(new_family_copy, None, args + ["--trace", "0"],
                                                faults=NEW_FAMILY_FAULTS[fault]))
    if fault != "none":
        assert res["correct"] is False, res["checks"]
        return
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2, res["checks"]
    assert set(res["metrics"]) == {"request_s", "peak_mem_gib", "setup_s"}
    assert set(res["checks"]) == {"start", "step", "missing"}
    traced = cpu_run.result_of(cpu_run.run_harness(new_family_copy, None,
                                                   args + ["--trace", "1"]))
    assert traced["correct"]
    assert traced["metrics"]["tiny_euler.work_mflop.serve"]["value"] == TINY_EULER_MFLOP


def test_without_the_program_the_harness_prints_no_result(tmp_path):
    root = cpu_run.make_copy(str(tmp_path / "bare"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "mvbench.run", "--workload",
                           "t2v.serve_plain", "--seed", "1", "--seconds", "1"], cwd=root,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.gpu
def test_a_plain_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, "-m", "mvbench.run", "--workload", "t2v.serve_plain",
                           "--seed", "77", "--seconds", "5"], cwd=REPO, capture_output=True,
                          text=True, timeout=1200)
    assert cpu_run.result_of(proc)["correct"]
