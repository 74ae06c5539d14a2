"""Helpers of the benchmark's CPU tests: a tiny T2V configuration of the
served geometry (8 views at 32², 10 DDIM steps, the refine at two of them),
the port's pipeline made to build its models at those sizes, and a run of
the harness from a copy of the benchmark's files, on the CPU.

The copy holds ``BENCHMARK.json`` and ``mvbench/`` only; the port is
imported from this repository."""

from __future__ import annotations

import copy
import functools
import json
import os
import shutil
import subprocess
import sys
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_MODELS = {
    "vae": {"ch": 32, "ch_mult": [1, 1, 1, 2], "num_res_blocks": 1, "z_channels": 4},
    "clip": {"vocab_size": 49408, "context_length": 77, "width": 64, "heads": 2, "layers": 3,
             "embed_dim": 64},
    "lgm": {"input_size": 32, "down_channels": [32, 64], "down_attention": [False, True],
            "mid_attention": True, "up_channels": [64, 32], "up_attention": [True, False],
            "splat_size": 32},
}


def tiny_config(name: str = "tiny") -> dict:
    """The shipped T2V configuration with every size cut for the CPU."""
    with open(os.path.join(REPO, "mvbench", "configs", "t2v.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["name"] = name
    cfg["models"] = copy.deepcopy(TINY_MODELS)
    p = cfg["pipeline"]
    p["UNet"].update(dim=64, context_dim=64, dim_mult=[1, 2], num_heads=2, head_dim=32,
                     num_res_blocks=1)
    p.update(max_frames=8, resolution=[32, 32], ddim_timesteps=10, gs_input_size=32,
             gs_render_size=32, gs_refine_views=[0, 2, 4, 6], gs_refine_steps=[3, 6])
    return cfg


def patch_port(models: dict) -> None:
    """Make the port's pipelines build their text tower, VAE and LGM at the
    sizes of ``models`` (the CLI builds the published sizes)."""
    from videomv_tpu_torch.inference import pipeline
    from videomv_tpu_torch.models import AutoencoderKL, CLIPTextTower
    from videomv_tpu_torch.models.lgm import LGM, LGMOptions

    clip = {k: v for k, v in models["clip"].items() if k != "visual"}
    vae = {k: v for k, v in models["vae"].items()}
    lgm = dict(models["lgm"])
    pipeline.CLIPTextTower = functools.partial(CLIPTextTower, **clip)
    pipeline.AutoencoderKL = functools.partial(AutoencoderKL, **vae)
    opt = dict(lgm, output_size=lgm["input_size"], num_views=8, num_input_views=4)
    opt = {k: tuple(v) if isinstance(v, list) else v for k, v in opt.items()}
    pipeline.LGM = lambda _opt: LGM(LGMOptions(**opt))


def make_copy(dst: str) -> str:
    """``BENCHMARK.json`` and ``mvbench/`` copied under ``dst``."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "mvbench"), os.path.join(dst, "mvbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


BOOT = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.append({repo!r})
{patch}
{faults}
from mvbench.run import main
sys.exit(main({argv!r}, allow_cpu=True))
"""
PATCH = """
cfg = json.load(open({cfg!r}))
from mvbench.tests.cpu_run import patch_port
patch_port(cfg["models"])
"""


def run_harness(root: str, config_file: Optional[str], argv: list, faults: str = "",
                timeout: float = 600) -> subprocess.CompletedProcess:
    """The harness of the copy at ``root`` in a fresh process on the CPU,
    with the port built at the sizes of ``config_file`` (``None``: a family
    that does not run the port's pipelines) and the Python in ``faults`` run
    first (to break the timed path)."""
    patch = PATCH.format(cfg=config_file) if config_file is not None else ""
    code = BOOT.format(root=root, repo=REPO, patch=patch, faults=faults, argv=argv)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="4")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)


def add_cell(root: str, name: str, config: dict, traffic: str, limits: dict,
             metrics: list = (), like: str = "t2v.serve_refined") -> None:
    """A configuration and a cell added to the copy at ``root`` as new files
    and entries; the cell reports the metrics that cell ``like`` reports."""
    rel = f"mvbench/configs/{config['name']}.json"
    with open(os.path.join(root, rel), "w") as f:
        json.dump(config, f)
    with open(os.path.join(root, "mvbench", "limits", name + ".json"), "w") as f:
        json.dump(limits, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": config["name"], "source": config["source"], "file": rel,
                             "reduced": [], "why": "tiny CPU configuration of the tests"})
    bench["workloads"].append({"name": name, "config": config["name"], "traffic": traffic,
                               "chips": 1, "why": "tiny CPU cell of the tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    bench["per_layer"].extend(metrics)
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)


def result_of(proc: subprocess.CompletedProcess) -> dict:
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"harness exited {proc.returncode}\nstdout:\n{proc.stdout[-4000:]}"
                             f"\nstderr:\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])
