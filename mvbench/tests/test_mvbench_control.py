"""The check fails what it has to fail, at a size a CPU test can hold (the
tiny configuration of ``cpu_run``): the control (the reference in fp8, one
precision below the configuration's bf16, in the program's place) reads
above every limit of a gap where the program reads below them; and each fault a
serving cell can have, planted in the timed path, turns ``correct`` false:
a denoising step that returns its state unchanged, half of the CFG batch
left out with the mean of the rest in its place, the refine's output
computed and then dropped by the sampler, and an answer (the views) altered
where it is produced. The cells run on one chip, so there is no
exchange between chips to leave out."""

import json
import os
import subprocess
import sys

import pytest

from mvbench.tests import cpu_run
from mvbench.tests.test_mvbench_harness import TINY_LIMITS

CALIBRATE = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.append({repo!r})
cfg = json.load(open({cfg!r}))
from mvbench.tests.cpu_run import patch_port
patch_port(cfg["models"])
from mvbench.calibrate import main
sys.exit(main({argv!r}, allow_cpu=True))
"""


@pytest.fixture(scope="module")
def tiny_copy(tmp_path_factory):
    root = cpu_run.make_copy(str(tmp_path_factory.mktemp("copy")))
    cpu_run.add_cell(root, "tiny.serve_refined", cpu_run.tiny_config("tiny"), "prompt_refined",
                     TINY_LIMITS)
    return root, os.path.join(root, "mvbench", "configs", "tiny.json")


def test_the_control_fails_every_limit_the_program_passes(tiny_copy):
    root, cfg = tiny_copy
    argv = ["--workload", "tiny.serve_refined", "--seeds", "31", "--control-seeds", "32"]
    code = CALIBRATE.format(root=root, repo=cpu_run.REPO, cfg=cfg, argv=argv)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=900, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    program, control = (next(r["readings"] for r in rows if r["control"] == c)
                        for c in (False, True))
    assert set(program) == set(control) == set(TINY_LIMITS)
    gaps = set(TINY_LIMITS) - {"missing"}
    assert all(program[k] <= TINY_LIMITS[k] < control[k] for k in gaps), (program, control)
    assert program["missing"] == control["missing"] == 0


FAULTS = {
    "step_returns_its_state": """
import videomv_tpu_torch.diffusion.samplers as s
s._ddim_update = lambda diffusion, x0, xt, t, stride, eta, noise: xt
""",
    "half_the_batch_left_out": """
import torch
from videomv_tpu_torch.models.unet_t2v import UNetSD_T2VBase
_fwd = UNetSD_T2VBase.forward
def half(self, x, t, y=None, camera_data=None, **kw):
    n = max(x.shape[0] // 2, 1)
    out = _fwd(self, x[:n], t[:n], y=y[:n], camera_data=camera_data[:n], **kw)
    rest = out.mean(dim=0, keepdim=True).expand(x.shape[0] - n, *out.shape[1:])
    return torch.cat([out, rest])
UNetSD_T2VBase.forward = half
""",
    "refine_output_dropped": """
import torch
import videomv_tpu_torch.diffusion.samplers as s
_x0 = s._pred_x0
def dropped(diffusion, out, xt, t, clamp, percentile, prediction_is_x0):
    if prediction_is_x0:  # the refine's x0: computed, then x0 estimated from x_t alone
        return _x0(diffusion, torch.zeros_like(out), xt, t, clamp, percentile, False)
    return _x0(diffusion, out, xt, t, clamp, percentile, prediction_is_x0)
s._pred_x0 = dropped
""",
    "answer_altered": """
from videomv_tpu_torch.inference.pipeline import T2VPipeline
_dec = T2VPipeline._decode_latents
def altered(self, latents):
    frames = _dec(self, latents).clone()
    frames[:, 0] = 255 - frames[:, 0]
    return frames
T2VPipeline._decode_latents = altered
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(tiny_copy, fault):
    root, cfg = tiny_copy
    argv = ["--workload", "tiny.serve_refined", "--seed", str(2 ** 32 + 17), "--seconds", "0.5"]
    res = cpu_run.result_of(cpu_run.run_harness(root, cfg, argv, faults=FAULTS[fault]))
    assert res["correct"] is False, res["checks"]
