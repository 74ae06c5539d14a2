"""The LGM-refine finetune behind the I2V denoiser: one step of the port's
``build_lgm_refine_step`` with ``make_i2v_apply`` against the JAX step with
its I2V apply function (``engine.py:314``), fp32 on the CPU, the same seeded
weights (I2V UNet, VAE, LGM, LPIPS), the same batch with the reference
frame's latent and image embedding, and the JAX step's own draws replayed
(dropout off on both sides, dense splat oracle; as in
``test_torch_lgm_refine.py``). Then ``T2VTrainer`` on a tiny
configs/i2vgen_xl_train.yaml with ``UNet.use_lgm_refine True``: only the LGM
moves."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import videomv_tpu_torch.training.engine as engine
from test_torch_i2v_train import I2V_CFG, REPO, SMALL_VAE, TINY, _small_joint
from test_torch_lgm_refine import (
    DIFFUSION,
    GRAD_TOL,
    LGM_OPT,
    LOSS_RTOL,
    VAE,
    R,
    S,
    STEP,
    _jax_draws,
    _max_rel,
    _port,
)
from torch_port_helpers import flatten_tree, seeded_like, set_torch_threads
from videomv_tpu.diffusion import GaussianDiffusion as JDiffusion
from videomv_tpu.models import UNetSD_I2VGen as JUNet
from videomv_tpu.models.autoencoder import AutoencoderKL as JVAE
from videomv_tpu.models.lgm import LGM as JLGM
from videomv_tpu.models.lgm import LGMOptions as JLGMOptions
from videomv_tpu.models.lpips import LPIPS as JLPIPS
from videomv_tpu.parallel import make_mesh, replicate, shard_batch
from videomv_tpu.training.lgm_refine import LGMTrainState as JLGMTrainState
from videomv_tpu.training.lgm_refine import build_lgm_refine_step as jbuild_step
from videomv_tpu_torch.config import load_config
from videomv_tpu_torch.data.cameras import get_camera
from videomv_tpu_torch.diffusion import GaussianDiffusion
from videomv_tpu_torch.models import AutoencoderKL, UNetSD_I2VGen
from videomv_tpu_torch.models.lgm import LGM, LGMOptions
from videomv_tpu_torch.models.lpips import LPIPS
from videomv_tpu_torch.parallel import make_i2v_apply
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax
from videomv_tpu_torch.training.lgm_refine import RefineDraws, build_lgm_refine_step

set_torch_threads()

B, F_, HW = 2, 4, 8
UNET = dict(in_dim=4, dim=32, y_dim=16, context_dim=16, out_dim=4, dim_mult=(1,), num_heads=1,
            head_dim=32, num_res_blocks=1, attn_scales=(1.0,), dropout=0.0,
            use_camera_condition=True, temporal_attention=False)


@pytest.fixture(scope="module")
def setup():
    ju, jv, jl, jp = JUNet(**UNET), JVAE(**VAE), JLGM(opt=JLGMOptions(**LGM_OPT)), JLPIPS()
    key = jax.random.PRNGKey(0)
    rs = np.random.default_rng(23)
    latents = (rs.standard_normal((B, 4, F_, HW, HW)) * 0.2).astype(np.float32)
    y = rs.standard_normal((B, 3, 16)).astype(np.float32)
    cams = np.stack([get_camera(F_, elevation=15, camera_distance=2.0),
                     get_camera(F_, elevation=25, camera_distance=1.8)])
    img = rs.standard_normal((B, 16)).astype(np.float32)
    probe = jnp.zeros((1, 3, R, R))
    params = {
        "unet": seeded_like(jax.eval_shape(lambda: ju.init(
            key, jnp.asarray(latents), jnp.zeros((B,), jnp.int32), y=jnp.asarray(y),
            camera_data=jnp.asarray(cams), local_image=jnp.asarray(latents[:, :, :1]),
            image=jnp.asarray(img))), 81),
        "vae": seeded_like(jax.eval_shape(lambda: jv.init(
            key, jnp.zeros((1, 3, 2 * HW, 2 * HW)))), 82),
        "lgm": seeded_like(jax.eval_shape(lambda: jl.init(
            key, jnp.zeros((1, 2, 9, S, S)))), 83),
        "lpips": seeded_like(jax.eval_shape(lambda: jp.init(key, probe, probe)), 84),
    }
    batch = {
        "latents": latents, "y_words": y, "camera_data": cams,
        "local_image": latents[:, :, :1].copy(), "image_embed": img,
        "images_gt": rs.uniform(0, 1, (B, F_, 3, R, R)).astype(np.float32),
        "masks_gt": rs.uniform(0, 1, (B, F_, 1, R, R)).astype(np.float32),
    }
    return (ju, jv, jl, jp), params, batch


def test_i2v_refine_step_matches_jax(setup):
    (ju, jv, jl, jp), params, batch = setup
    mesh = make_mesh(1)
    diffusion = JDiffusion(**DIFFUSION)
    opt = optax.sgd(1.0)

    def apply_fn(unet_params, xt, t, y, jbatch, rng):  # make_i2v_apply without dropout
        return ju.apply(unet_params, xt, t, y=y, camera_data=jbatch.get("camera_data"),
                        local_image=jbatch["local_image"], image=jbatch.get("image_embed"))

    step = jbuild_step(apply_fn, jv, jl, diffusion, opt, mesh, lpips=jp, **STEP)
    old = jax.tree_util.tree_map(np.asarray, params["lgm"])
    state = JLGMTrainState(step=replicate(mesh, jnp.zeros((), jnp.int32)),
                           lgm_params=replicate(mesh, params["lgm"]),
                           opt_state=replicate(mesh, opt.init(params["lgm"])))
    frozen = tuple(replicate(mesh, params[k]) for k in ("unet", "vae", "lpips"))
    rng = jax.random.PRNGKey(6)
    state, jloss, jaux = step(state, frozen, shard_batch(
        mesh, {k: jnp.asarray(v) for k, v in batch.items()}), rng)
    jgrads = jax.tree_util.tree_map(lambda o, n: o - np.asarray(n), old, state.lgm_params)
    draws = _jax_draws(rng, 0, diffusion, batch["latents"])

    unet = _port(UNetSD_I2VGen(**UNET), params["unet"]).eval().requires_grad_(False)
    vae = _port(AutoencoderKL(**VAE), params["vae"]).eval().requires_grad_(False)
    lpips = _port(LPIPS(), params["lpips"]).eval().requires_grad_(False)
    lgm = _port(LGM(LGMOptions(**LGM_OPT)), params["lgm"]).train()
    tstep = build_lgm_refine_step(make_i2v_apply(unet), vae, lgm, GaussianDiffusion(**DIFFUSION),
                                  lpips=lpips, **STEP)
    d = RefineDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
                    dropout_seed=0)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = tstep.loss_fn(tbatch, d)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["psnr"]), float(jaux["psnr"]), rtol=LOSS_RTOL)
    want = {k: v.numpy() for k, v in state_dict_from_flax(
        flatten_tree(jgrads["params"]), lgm).items()}
    grads = {k: p.grad.numpy() for k, p in lgm.named_parameters()}
    assert set(want) == set(grads)
    assert max(np.abs(w).max() for w in want.values()) > 1e-4  # gradients worth comparing
    assert _max_rel(grads, want) <= GRAD_TOL
    # the image conditioning reaches the frozen denoiser: another embedding,
    # another fake x0, another loss
    other = dict(tbatch, image_embed=tbatch["image_embed"] + 1.0)
    with torch.no_grad():
        assert float(tstep.loss_fn(other, d)[0]) != float(loss.detach())


def test_i2v_refine_trainer_moves_only_the_lgm(monkeypatch, tmp_path):
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(engine, "OpenCLIPTextVisual", _small_joint)
    monkeypatch.setattr(engine, "AutoencoderKL", functools.partial(AutoencoderKL, **SMALL_VAE))
    lgm_opts = ("{input_size: 32, down_channels: [32, 64], down_attention: [false, true], "
                "mid_attention: true, up_channels: [64, 32], up_attention: [true, false], "
                "splat_size: 32, output_size: 32, num_views: 8, num_input_views: 4}")
    cfg = load_config(I2V_CFG, opts=[*TINY, "log_dir", str(tmp_path), "UNet.use_lgm_refine",
                                     "True", "lgm_opts", lgm_opts, "viz_interval", "1"])
    tr = engine.T2VTrainer(cfg, device="cpu").init(zero_init=False)
    assert tr.is_i2v and tr.use_lgm_refine and tr.unet.training and tr.state is None
    frozen = {n: [p.detach().clone() for p in getattr(tr, n).parameters()]
              for n in ("unet", "vae", "clip", "lpips")}
    before = [p.detach().clone() for p in tr.lgm.parameters()]
    loss = tr.train(num_steps=2, batch_size=1)
    assert np.isfinite(loss) and tr.lgm_state.step == 2
    assert max(float((a - b.detach()).abs().max())
               for a, b in zip(before, tr.lgm.parameters())) > 0
    for name, snap in frozen.items():
        assert all(torch.equal(a, b) for a, b in zip(snap, getattr(tr, name).parameters())), name
    assert not os.path.exists(tmp_path / "viz")  # no visualisation in the LGM finetune
