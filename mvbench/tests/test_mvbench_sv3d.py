"""The ``sv3d`` family on the CPU at a tiny size: a copy of the benchmark with
a tiny ``sv3d_p`` configuration (5 frames at 64², a 2-level VideoUNet of 32
channels, small CLIP and VAE towers, 4 Euler steps) and an orbit mix, run
through the harness; its check passes with the program as it is and fails at
least one limit with each planted fault: the guidance dropped (the cond
rows' output taken for every frame), σ off by one step (each step's network
call at the next step's σ), the temporal stack skipped (every
``time_stack`` returning its input)."""

import copy
import json
import os

import pytest

from mvbench.tests import cpu_run

REPO = cpu_run.REPO
# the tiny cell's limits: on the CPU (bf16, seed 4294967311) the program reads
# cond 0.0154, step 0.0340, frames 0.0052; the planted faults read step 0.585
# (guidance dropped), 20.6 (σ off by one step), 0.845 (temporal stack skipped)
TINY_LIMITS = {"cond": 0.03, "step": 0.15, "frames": 0.02, "missing": 0}


def tiny_sv3d() -> dict:
    with open(os.path.join(REPO, "mvbench", "configs", "sv3d_p.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    cfg["name"] = "tiny_sv3d"
    cfg["models"] = {
        "vae": {"ch": 32, "ch_mult": [1, 1, 1, 2], "num_res_blocks": 1, "z_channels": 4},
        "clip_visual": {"image_size": 224, "patch_size": 56, "width": 64, "heads": 2,
                        "layers": 2, "embed_dim": 64}}
    p = cfg["pipeline"]
    p.update(resolution=[64, 64], decoding_t=3)
    p["Sampler"]["num_steps"] = 4
    p["VideoUNet"].update(model_channels=32, num_res_blocks=1, attention_resolutions=[1, 2],
                          channel_mult=[1, 2], num_head_channels=16, context_dim=64,
                          num_frames=5)
    return cfg


FAULTS = {
    "guidance dropped": """
from videomv_tpu_torch.diffusion import edm
def _no_guidance(self, x, sigma, context, concat, y):
    c_skip, c_out, c_in, c_noise = edm.v_scaling(float(sigma))
    t = x.shape[0]
    import torch
    xin = torch.cat([(x * c_in).repeat(2, 1, 1, 1), concat.float()], dim=1)
    out = self.network(xin, torch.full((2 * t,), c_noise), context, y).float()
    return c_skip * x + c_out * out[:t]
edm.GuidedDenoiser.forward = _no_guidance
""",
    "sigma off by one step": """
from videomv_tpu_torch.diffusion import edm
_loop = edm.euler_sample_loop
def _late(denoise, noise, sigmas):
    nxt = dict(zip(sigmas[:-1], sigmas[1:-1] + [sigmas[-2]]))
    return _loop(lambda x, s: denoise(x, nxt[s]), noise, sigmas)
edm.euler_sample_loop = _late
from videomv_tpu_torch.inference import sv3d
sv3d.euler_sample_loop = _late
""",
    "temporal stack skipped": """
from videomv_tpu_torch.models import unet_sv3d
unet_sv3d.TemporalResBlock.forward = lambda self, x, emb: x
unet_sv3d.VideoTransformerBlock.forward = lambda self, x, context: x
""",
}


def _setup(tmp_path):
    root = cpu_run.make_copy(str(tmp_path / "copy"))
    cfg = tiny_sv3d()
    with open(os.path.join(root, "mvbench", "traffic", "image_orbit.json")) as f:
        mix = json.load(f)
    mix.update(image_size=64, pool=3, check={"requests": 2, "steps": 3})
    with open(os.path.join(root, "mvbench", "traffic", "tiny_orbit.json"), "w") as f:
        json.dump(mix, f)
    cpu_run.add_cell(root, "tiny_sv3d.serve", cfg, "tiny_orbit", TINY_LIMITS,
                     like="sv3d_p.serve_orbit")
    return root


def _run(root, tmp_path, monkeypatch, faults=""):
    os.makedirs(tmp_path / "tmp", exist_ok=True)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    proc = cpu_run.run_harness(root, None, ["--workload", "tiny_sv3d.serve", "--seed",
                                            "4294967311", "--seconds", "0", "--trace", "0"],
                               faults=faults)
    return cpu_run.result_of(proc), proc


def test_tiny_sv3d_cell_is_correct_on_the_cpu(tmp_path, monkeypatch):
    res, proc = _run(_setup(tmp_path), tmp_path, monkeypatch)
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert res["correct"], (checks, proc.stderr[-3000:])
    assert checks["missing"] == 0
    assert res["attempted"] >= 2 and res["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_planted_fault_fails_a_limit(tmp_path, monkeypatch, fault):
    res, proc = _run(_setup(tmp_path), tmp_path, monkeypatch, FAULTS[fault])
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert not res["correct"], (fault, checks)
    print(fault, checks)
