"""The port's frame-parallel I2V sampler over gloo ranks on the CPU
(``parallel.mesh.spawn``), fp32, against the port on one process and JAX
``_build_sampler_i2v`` on one device: configs/i2vgen_xl_infer_tiny.yaml at
32², 6 views, 3 DDIM steps, guidance 6.0, the set-up of
``test_torch_i2v.py`` (small VAE and LGM, seeded weights, numpy noise and
conditioning), plain and with the ``shared`` refine at step 2, at sp = 2 and
sp = 3. The I2V UNet mixes frames in its temporal blocks and in its concat
plane (built whole on every rank). The refine stage is also held alone,
well-conditioned, behind a denoiser that mixes no frames and rounds nothing
(``HalfDenoiser``; test_torch_parallel_serve.py says why). On one rank it is
held to JAX stage by stage (the reference-frame encode, x_t at the refine
step, the LGM's Gaussians, the render, the 24-view encode): the render is
the first stage to leave 1e-4, and only at the pixels where a Gaussian's
alpha crosses the 1/255 cut between the two packages."""

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


# ---------------------------------------------------------------------------
# Why the refine stage on one rank is ~1.2e-3 off JAX: stage by stage, each
# package on its own sampler's x_t at the refine step (behind eps = x_t / 2)

STAGE_TOL = 1e-4
# the share of rendered pixels where some Gaussian's alpha is on the other
# side of the 1/255 cut in the two packages (14 of 6144 in this set-up)
MAX_CROSSING_SHARE = 0.01


def _cut_crossings(ga, gb, cam_view, cam_view_proj, size, fovy):
    """[V, S, S]: pixels where a Gaussian of ``ga`` and the same one of
    ``gb`` [N, 14] fall on different sides of the composite's cut (alpha
    >= 1/255 at power <= 0)."""
    import math

    import torch

    from videomv_tpu_torch.ops.gaussian_splat import project_gaussians

    ys, xs = torch.meshgrid(torch.arange(size, dtype=torch.float32),
                            torch.arange(size, dtype=torch.float32), indexing="ij")
    px = torch.stack([xs, ys], -1).reshape(-1, 2)
    thf = math.tan(math.radians(fovy) / 2)

    def alive(g, v):
        m, ic, _, _, _, op, valid = project_gaussians(g, cam_view[0, v], cam_view_proj[0, v],
                                                      size, thf)
        d0, d1 = px[None, :, 0] - m[:, None, 0], px[None, :, 1] - m[:, None, 1]
        power = -0.5 * (ic[:, 0, None] * d0 ** 2 + ic[:, 2, None] * d1 ** 2) \
            - ic[:, 1, None] * d0 * d1
        op = torch.where(valid, op, torch.zeros_like(op))
        return (power <= 0) & (torch.clamp_max(op[:, None] * torch.exp(power), 0.99)
                               >= 1.0 / 255.0)

    return np.stack([(alive(ga, v) != alive(gb, v)).any(0).reshape(size, size).numpy()
                     for v in range(cam_view.shape[1])])


@pytest.fixture(scope="module")
def refine_stages():
    import jax.numpy as jnp
    import torch

    import videomv_tpu.inference.refine as jrefine
    import videomv_tpu_torch.inference.refine as trefine
    from test_torch_i2v import IMAGE, _pipelines
    from videomv_tpu.diffusion import samplers as jsamplers
    from videomv_tpu.inference.i2v import load_white_composite
    from videomv_tpu_torch.diffusion import samplers as tsamplers

    jp, tp = _pipelines(OPTS, with_lgm=True, seed=90)
    f, (h, w) = jp.max_frames, jp.latent_hw
    c = _conditioning(np.random.default_rng(9), f, h, w)
    out = {}
    rgb = load_white_composite(IMAGE, jp.resolution[0])
    out["reference-frame encode"] = (tp.encode_local_latent(rgb).numpy(),
                                     np.asarray(jp.encode_local_latent(rgb)))
    cams = {"jax": jp._get_cameras(15.0, 2.0), "port": tp._get_cameras(15.0, 2.0)}
    kw = dict(scale_factor=jp.scale_factor, batch=1, uncond_mode="shared",
              view_idxs=tuple(int(v) for v in jp.cfg.gs_refine_views))
    seen = {}
    for side, mod, samplers, pipe in (("jax", jrefine, jsamplers, jp),
                                      ("port", trefine, tsamplers, tp)):
        cam, rays, cv, cvp = cams[side]
        if side == "jax":
            refine = mod.make_refine_fn(
                unet=HalfDenoiser, vae=jp.vae, lgm=jp.lgm, params=jp._params, diffusion=jp.diffusion,
                gs_settings=jp.gs_settings, y=c["y"], zero_y=c["zero_y"], cam=cam,
                gs_rays=rays, cam_view=cv, cam_view_proj=cvp, **kw)
            noise = jnp.asarray(c["noise"])
        else:
            refine = mod.make_refine_fn(
                unet=ranks.HalfDenoiser(), vae=tp.vae, lgm=tp.lgm, diffusion=tp.diffusion,
                gs_settings=tp.gs_settings, y=torch.from_numpy(c["y"]),
                zero_y=torch.from_numpy(c["zero_y"]), cam=cam, gs_rays=rays, cam_view=cv,
                cam_view_proj=cvp, **kw)
            noise = torch.from_numpy(c["noise"])

        def staged(xt, t, mod=mod, refine=refine):
            """The refine's x0 with the Gaussians and renders it rendered."""
            box, render = {}, mod.render_gaussians

            def rec(g, *a, **k):
                box["out"] = render(g, *a, **k)
                box["g"] = g
                return box["out"]

            mod.render_gaussians = rec
            try:
                z = refine(xt, t)[0]
            finally:
                mod.render_gaussians = render
            return z, box["g"], box["out"]["image"]

        staged = jax.jit(staged) if side == "jax" else staged

        def refine_rec(xt, t, side=side, staged=staged):
            z, g, img = staged(xt, t)
            seen[side] = {"xt": np.array(xt), "z": np.array(z), "g": np.array(g),
                          "img": np.array(img)}
            return z, z

        with torch.no_grad():
            samplers.ddim_sample_loop(pipe.diffusion, lambda x, t: (0.5 * x, 0.5 * x), noise,
                                      ddim_timesteps=STEPS, guide_scale=6.0,
                                      refine_fn=refine_rec, refine_steps=(2,))
    jx, pt = seen["jax"], seen["port"]
    out["x_t at the refine step"] = (pt["xt"], jx["xt"])
    # the LGM's Gaussians carry the chain: the fake x0, the 4-view decode and
    # the LGM before them agree to its bound
    out["LGM Gaussians"] = (pt["g"], jx["g"])
    _, _, cv, cvp = cams["port"]
    cross = _cut_crossings(torch.from_numpy(pt["g"][0]), torch.from_numpy(jx["g"][0]), cv, cvp,
                           tp.gs_settings.output_size, tp.gs_settings.fovy)
    out["render"] = (pt["img"], jx["img"], cross)
    # the 24-view encode on the same renders (JAX's)
    r = jx["img"].reshape(-1, 3, *jx["img"].shape[-2:])
    with torch.no_grad():
        zt = tp.vae.encode_first_stage((torch.from_numpy(r) - 0.5) / 0.5, tp.scale_factor)
    zj = jp.vae.apply(jp._params["vae"], (jnp.asarray(r) - 0.5) / 0.5, jp.scale_factor,
                      method=jp.vae.encode_first_stage)
    out["24-view encode"] = (zt.numpy(), np.asarray(zj))
    out["refined x0"] = (pt["z"], jx["z"])
    return out


@pytest.mark.parametrize("stage", ["reference-frame encode", "x_t at the refine step",
                                   "LGM Gaussians", "24-view encode"])
def test_i2v_refine_stage_matches_jax(refine_stages, stage):
    got, want = refine_stages[stage]
    assert rel_err(got, want) <= STAGE_TOL


def test_i2v_refine_render_differs_only_where_alpha_crosses_the_cut(refine_stages):
    """The first stage that leaves STAGE_TOL is the render: its difference
    sits at the pixels where a Gaussian's alpha crosses 1/255 between the two
    packages' (STAGE_TOL-close) Gaussians; every other pixel is within
    STAGE_TOL. That jump, not an error of a stage, is what the refined
    x0 carries (it is ~1e-3 off, as the sample is)."""
    got, want, cross = refine_stages["render"]
    diff = np.abs(got - want).max(axis=2)[0]  # [V, S, S]
    assert 0 < cross.sum() <= MAX_CROSSING_SHARE * cross.size
    assert diff[~cross].max() <= STAGE_TOL * np.abs(want).max()
    assert rel_err(got, want) > STAGE_TOL  # the jump is there
    assert rel_err(*refine_stages["refined x0"]) > STAGE_TOL
