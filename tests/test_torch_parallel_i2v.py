"""The port's frame-parallel I2V sampler over gloo ranks on the CPU
(``parallel.mesh.spawn``), fp32, against the port on one process and JAX
``_build_sampler_i2v`` on one device: configs/i2vgen_xl_infer_tiny.yaml at
32², 6 views, 3 DDIM steps, guidance 6.0, the set-up of
``test_torch_i2v.py`` (small VAE and LGM, seeded weights, numpy noise and
conditioning), plain and with the ``shared`` refine at step 2, at sp = 2 and
sp = 3. The I2V UNet mixes frames in its temporal blocks and in its concat
plane (built whole on every rank). The refine stage is also held alone,
well-conditioned, behind a denoiser that mixes no frames and rounds nothing
(``HalfDenoiser``; test_torch_parallel_serve.py says why)."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from test_torch_i2v import (
    ORDER,
    REFINE_OPTS,
    SMALL_VAE,
    TINY_CFG,
    _conditioning,
    _pipelines,
    _small_lgm,
)
from test_torch_parallel_serve import HalfDenoiser
from torch_port_helpers import rel_err, set_torch_threads
from videomv_tpu_torch.parallel import spawn

set_torch_threads()

OPTS = [*REFINE_OPTS, "max_frames", "6"]
STEPS = 3
# against one rank: the temporal blocks' sums and norms over the ranks
RANK_TOL = 2e-4
# against JAX: the tolerance of test_torch_i2v.py
JAX_TOL = 1e-3
# the refined sample: its render's alpha cut makes it ill-conditioned
# (test_torch_parallel_serve.py::test_refined_sample_is_ill_conditioned)
REFINED_TOL = 5e-3
DEADLINE_S = 300
JOBS = [{"kind": "i2v", "refine": False}, {"kind": "i2v", "refine": True},
        {"kind": "i2v", "refine": True, "stub": True}]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jp, tp = _pipelines(OPTS, with_lgm=True, seed=90)
    f, (h, w) = jp.max_frames, jp.latent_hw
    c = _conditioning(np.random.default_rng(9), f, h, w)
    models = {name: {k: v.detach().numpy() for k, v in m.state_dict().items()}
              for name, m in tp.models.items() if name != "clip"}
    inputs = {"noise1": c["noise"], "y": c["y"], "zero_y": c["zero_y"], "local": c["local"],
              "img": c["img"], "zero_img": c["zero_img"]}
    args = (TINY_CFG, OPTS, models, SMALL_VAE, _small_lgm(32), inputs, JOBS, STEPS)
    tmp = tmp_path_factory.mktemp("rdv")
    with ThreadPoolExecutor(3) as pool:  # the ranks run while JAX compiles
        futures = {n: pool.submit(spawn, ranks.serve, n, init_file=str(tmp / f"w{n}"),
                                  deadline_s=DEADLINE_S, args=args) for n in (1, 2, 3)}
        cams = [np.asarray(a) for a in jp._get_cameras(15.0, 2.0)]
        want = {}
        unet = jp.unet
        for refine, stub in ((False, False), (True, False), ("stub", True)):
            jp.unet = HalfDenoiser() if stub else unet
            sample = jp._build_sampler_i2v(steps=STEPS, guide_scale=6.0, with_refine=bool(refine))
            want[refine] = np.asarray(sample(jp._params, *(c[k] for k in ORDER[:3]), cams[0],
                                             *(c[k] for k in ORDER[4:]), *cams[1:],
                                             jax.random.PRNGKey(0)))
        jp.unet = unet
        got = {n: f.result() for n, f in futures.items()}
    return got, want


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("refine", [False, True])
def test_frame_parallel_i2v(runs, sp, refine):
    got, want = runs
    lat = [r[int(refine)] for r in got[sp]]
    assert lat[0].shape == (1, 4, 6, 4, 4) and np.isfinite(lat[0]).all()
    assert all(np.array_equal(x, lat[0]) for x in lat[1:])
    assert rel_err(lat[0], got[1][0][int(refine)]) <= (REFINED_TOL if refine else RANK_TOL)
    assert rel_err(lat[0], want[refine]) <= (REFINED_TOL if refine else JAX_TOL)


@pytest.mark.parametrize("sp", [2, 3])
def test_frame_parallel_i2v_refine_stage(runs, sp):
    """The refined I2V request behind HalfDenoiser: the refine stage alone,
    against one rank to RANK_TOL."""
    got, want = runs
    lat = [r[2] for r in got[sp]]
    assert lat[0].shape == (1, 4, 6, 4, 4) and np.isfinite(lat[0]).all()
    assert all(np.array_equal(x, lat[0]) for x in lat[1:])
    assert rel_err(lat[0], got[1][0][2]) <= RANK_TOL
    # the port on one rank already departs from JAX here by about 1.2e-3 (the
    # two decode the canonical views with other roundings, and the render's
    # alpha cut turns that into a jump): held to REFINED_TOL, open in ROADMAP
    assert rel_err(lat[0], want["stub"]) <= REFINED_TOL
    assert rel_err(got[1][0][2], got[1][0][1]) > 1e-2  # not the UNet's sample
