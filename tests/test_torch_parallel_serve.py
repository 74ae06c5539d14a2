"""The port's multi-rank T2V serving over gloo ranks on the CPU
(``parallel.mesh.spawn``), fp32, against the port on one process and the
JAX pipeline's sampler program on one device (``_build_sampler``), with the
same seeded weights, numpy noise and text encodings.

configs/t2v_infer_tiny.yaml at 32², 6 views, 3 DDIM steps, CFG 9.0, small VAE
and LGM, the Gaussian-splat refine (`shared` uncond, the shipped serving mode) at
step 2 over views 0-3:

- ``generate(frame_parallel=True)``, plain and refined, at sp = 2, sp = 3
  (the deepest level's 2 × 2 tokens split 2 / 1 / 1) and sp = 3 with a
  fourth rank outside the mesh (6 frames over 4 ranks), and over an
  ``('sp', 'tp')`` mesh of 2 × 2 (``serving_tp: 2``; kernel 1 on the local
  heads; the pipeline then refuses every request that is not
  frame-parallel); the refine's render is view-sharded;
- ``generate_batch`` of 3 prompts, ``force_batched`` and ``data_parallel``
  (padded to 4 over 2 ranks, the refine's render batch-local).

The refined sample is ill-conditioned (``test_refined_sample_is_ill_conditioned``),
so the refine stage is also held alone, well-conditioned: with the UNet
replaced by a denoiser that mixes no frames and rounds nothing
(``HalfDenoiser``, eps = x_t / 2, in the port and in JAX), every placement
reaches the refine with the same bits, and the refined frame-parallel and
data-parallel samples are held to RANK_TOL against one rank and JAX_TOL
against JAX.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from torch_port_helpers import flatten_tree, rel_err, seeded_like, set_torch_threads
from videomv_tpu.config import load_inference_config as jload_inference_config
from videomv_tpu.inference.pipeline import T2VPipeline as JPipeline
from videomv_tpu.models.autoencoder import AutoencoderKL as JVAE
from videomv_tpu.models.lgm import LGM as JLGM
from videomv_tpu.models.lgm import LGMOptions as JLGMOptions
from videomv_tpu_torch.parallel import spawn
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "t2v_infer_tiny.yaml")
OPTS = ["sampling_dtype", "float32", "resolution", "[32, 32]", "max_frames", "6",
        "UNet.use_lgm_refine", "True", "gs_refine_uncond", "shared", "gs_refine_steps", "[2]",
        "gs_refine_views", "[0, 1, 2, 3]", "gs_input_size", "32", "gs_render_size", "32"]
SMALL_VAE = dict(ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=1)
LGM_KW = dict(input_size=32, down_channels=(32, 64), down_attention=(False, True),
              mid_attention=True, up_channels=(64, 32), up_attention=(True, False),
              splat_size=32, output_size=32, num_views=8, num_input_views=4)
STEPS = 3
# against one rank: the same fp32 arithmetic, the temporal blocks' sums and
# norms taken over the ranks in another order
RANK_TOL = 2e-4
# against JAX: the tolerance of test_torch_pipeline.py
JAX_TOL = 1e-3
# the refined sample against either: a relative change of 1e-7 in the noise
# moves these refined latents by about 1.1e-3 and the plain ones by 5e-6
# (test_refined_sample_is_ill_conditioned): the render's alpha cut at 1/255 is
# discontinuous in the seeded LGM's Gaussians, so any change of rounding (sums
# over ranks, a decode of fewer views) reaches the latents at that size
REFINED_TOL = 5e-3
DEADLINE_S = 300

FP = [{"kind": "generate", "refine": False}, {"kind": "generate", "refine": True}]
TP = [dict(j, serving_tp=2) for j in FP] + [{"kind": "refused", "serving_tp": 2}]
BATCH = [{"kind": "batch", "refine": False, "dp": False, "forced": True},
         {"kind": "batch", "refine": False, "dp": True, "forced": False},
         {"kind": "batch", "refine": True, "dp": True, "forced": False}]
# the refine stage behind HalfDenoiser: one refined request, the refined
# data-parallel batch, and the forced batch it is held against on one rank
STUB = [{"kind": "generate", "refine": True, "stub": True},
        {"kind": "batch", "refine": True, "dp": True, "forced": False, "stub": True}]
STUB_ONE = [STUB[0], {"kind": "batch", "refine": True, "dp": False, "forced": True, "stub": True}]


class HalfDenoiser:
    """JAX twin of ``torch_parallel_ranks.HalfDenoiser``: eps = x_t / 2."""

    @staticmethod
    def apply(variables, x, t, **kw):
        return 0.5 * x


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jp = JPipeline(jload_inference_config(TINY_CFG, opts=OPTS))
    jp.vae, jp.lgm = JVAE(**SMALL_VAE), JLGM(opt=JLGMOptions(**LGM_KW))
    f, (h, w) = jp.max_frames, jp.latent_hw
    key = jax.random.PRNGKey(0)
    jp._params = {
        "unet": seeded_like(jax.eval_shape(lambda: jp.unet.init(
            key, jnp.zeros((1, 4, f, h, w)), jnp.zeros((1,), jnp.int32),
            y=jnp.zeros((1, 77, 1024)), camera_data=jnp.zeros((1, f, 16)))), seed=81),
        "vae": seeded_like(jax.eval_shape(lambda: jp.vae.init(
            key, jnp.zeros((1, 3, 32, 32)))), seed=82),
        "lgm": seeded_like(jax.eval_shape(lambda: jp.lgm.init(
            key, jnp.zeros((1, 4, 9, 32, 32)))), seed=83),
    }
    rs = np.random.default_rng(19)
    inputs = {"noise1": rs.standard_normal((1, 4, f, h, w)).astype(np.float32),
              "noise3": rs.standard_normal((3, 4, f, h, w)).astype(np.float32),
              "y": rs.standard_normal((3, 77, 1024)).astype(np.float32),
              "zero_y": rs.standard_normal((1, 77, 1024)).astype(np.float32)}
    # the refined request again from noise changed by 1e-7 (relative)
    inputs["nudged"] = inputs["noise1"] * np.float32(1 + 1e-7)
    one = ranks.pipeline(TINY_CFG, OPTS, {}, SMALL_VAE, LGM_KW)
    models = {name: {k: v.numpy() for k, v in state_dict_from_flax(
        flatten_tree(p["params"]), one.models[name]).items()}
        for name, p in jp._params.items()}
    args = (TINY_CFG, OPTS, models, SMALL_VAE, LGM_KW, inputs)
    tmp = tmp_path_factory.mktemp("rdv")
    # (world, jobs): 6 frames over sp 2 and sp 3, over sp 3 beside an idle
    # fourth rank then sp 2 × tp 2, and the port on one process (one generate
    # each, the forced batch, the nudged pair)
    plan = {"sp2": (2, FP + BATCH + STUB), "sp3": (3, FP + STUB[:1]), "four": (4, FP + TP),
            "one": (1, FP + BATCH[:1] + [dict(j, noise="nudged") for j in FP] + STUB_ONE)}
    with ThreadPoolExecutor(len(plan)) as pool:
        futures = {tag: pool.submit(spawn, ranks.serve, n, init_file=str(tmp / tag),
                                    deadline_s=DEADLINE_S, args=(*args, jobs, STEPS))
                   for tag, (n, jobs) in plan.items()}
        cams = [np.asarray(a) for a in jp._get_cameras(15.0, 2.0)]
        y, zero_y = inputs["y"], inputs["zero_y"]
        want = {}
        for refine in (False, True):
            sample = jp._build_sampler(steps=STEPS, guide_scale=9.0, with_refine=refine)
            want[refine] = np.asarray(sample(jp._params, inputs["noise1"], y[:1], zero_y,
                                             *cams, jax.random.PRNGKey(0)))
            sample = jp._build_sampler(steps=STEPS, guide_scale=9.0, with_refine=refine, b=3)
            want[("batch", refine)] = np.asarray(sample(
                jp._params, inputs["noise3"], y,
                np.broadcast_to(zero_y, (3,) + zero_y.shape[1:]),
                np.broadcast_to(cams[0], (3,) + cams[0].shape[1:]), *cams[1:],
                jax.random.PRNGKey(0)))
        unet, jp.unet = jp.unet, HalfDenoiser()
        sample = jp._build_sampler(steps=STEPS, guide_scale=9.0, with_refine=True)
        want["stub"] = np.asarray(sample(jp._params, inputs["noise1"], y[:1], zero_y, *cams,
                                         jax.random.PRNGKey(0)))
        sample = jp._build_sampler(steps=STEPS, guide_scale=9.0, with_refine=True, b=3)
        want[("batch", "stub")] = np.asarray(sample(
            jp._params, inputs["noise3"], y, np.broadcast_to(zero_y, (3,) + zero_y.shape[1:]),
            np.broadcast_to(cams[0], (3,) + cams[0].shape[1:]), *cams[1:],
            jax.random.PRNGKey(0)))
        jp.unet = unet
        res = {tag: f.result() for tag, f in futures.items()}
    got = {"sp2": res["sp2"], "sp3": res["sp3"], "stub_sp2": [r[5:] for r in res["sp2"]],
           "stub_sp3": [r[2:] for r in res["sp3"]],
           "sp3+1": [r[:2] for r in res["four"]], "sp2tp2": [r[2:4] for r in res["four"]],
           "refused": [r[4] for r in res["four"]]}
    single = res["one"][0]
    got["stub_one"] = single[5:]
    return got, single, want


@pytest.mark.parametrize("mesh", ["sp2", "sp3", "sp3+1", "sp2tp2"])
@pytest.mark.parametrize("refine", [False, True])
def test_frame_parallel_generate(runs, mesh, refine):
    got, single, want = runs
    lat = [r[int(refine)] for r in got[mesh]]
    assert lat[0].shape == (1, 4, 6, 4, 4) and np.isfinite(lat[0]).all()
    assert all(np.array_equal(x, lat[0]) for x in lat[1:])  # every rank returns the sample
    assert rel_err(lat[0], single[int(refine)]) <= (REFINED_TOL if refine else RANK_TOL)
    assert rel_err(lat[0], want[refine]) <= (REFINED_TOL if refine else JAX_TOL)


def test_tp_pipeline_refuses_other_requests(runs):
    """After serving_tp has cut the UNet to each rank's heads, a data-parallel
    batch and a single-rank request raise on every rank (they would sum
    partial attention outputs of different samples)."""
    got, _, _ = runs
    for batch_err, single_err in got["refused"]:
        assert "generate_batch" in batch_err and "attention heads" in batch_err
        assert "frame_parallel=False" in single_err


def test_refine_changes_the_sample(runs):
    got, _, _ = runs
    assert rel_err(got["sp2"][0][1], got["sp2"][0][0]) > 1e-2


def test_refined_sample_is_ill_conditioned(runs):
    """The plain sample barely moves under a 1e-7 change of its noise; the
    refined one moves by more than RANK_TOL, and stays within REFINED_TOL."""
    _, single, _ = runs
    plain, refined = rel_err(single[3], single[0]), rel_err(single[4], single[1])
    assert plain < 2e-5 and RANK_TOL < refined <= REFINED_TOL, (plain, refined)


@pytest.mark.parametrize("mesh", ["sp2", "sp3"])
def test_frame_parallel_refine_stage(runs, mesh):
    """The refined request behind HalfDenoiser: each rank decodes the
    canonical views among its frames, the LGM runs on the gathered four, each
    rank renders and encodes its frames' views."""
    got, _, want = runs
    lat = [r[0] for r in got[f"stub_{mesh}"]]
    assert lat[0].shape == (1, 4, 6, 4, 4) and np.isfinite(lat[0]).all()
    assert all(np.array_equal(x, lat[0]) for x in lat[1:])
    assert rel_err(lat[0], got["stub_one"][0]) <= RANK_TOL
    assert rel_err(lat[0], want["stub"]) <= JAX_TOL
    assert rel_err(got["stub_one"][0], got["sp2"][0][1]) > 1e-2  # not the UNet's sample


def test_data_parallel_refine_stage(runs):
    """The refined data-parallel batch behind HalfDenoiser (3 prompts padded
    to 4 over 2 ranks, each rank's render batch-local) against the forced
    batch on one rank and JAX's batched program."""
    got, _, want = runs
    lat = got["stub_sp2"][0][1]
    assert lat.shape == (3, 4, 6, 4, 4) and np.array_equal(got["stub_sp2"][1][1], lat)
    assert rel_err(lat, got["stub_one"][1]) <= RANK_TOL
    assert rel_err(lat, want[("batch", "stub")]) <= JAX_TOL


@pytest.mark.parametrize("job", [0, 1, 2], ids=["force_batched", "data_parallel",
                                                "data_parallel_refined"])
def test_generate_batch(runs, job):
    got, single, want = runs
    lat = got["sp2"][0][2 + job]
    assert lat.shape == (3, 4, 6, 4, 4) and np.isfinite(lat).all()
    assert np.array_equal(got["sp2"][1][2 + job], lat)
    assert rel_err(lat, want[("batch", BATCH[job]["refine"])]) <= (
        REFINED_TOL if BATCH[job]["refine"] else JAX_TOL)
    if not BATCH[job]["refine"]:
        assert rel_err(lat, single[2]) <= RANK_TOL
