"""One LGM-refine finetune step of the port against the JAX package's, the
slice as a whole at a small size, fp32 on the CPU: the same seeded weights
(UNet, VAE, LGM, LPIPS through the Flax-tree bridge), the same batch, and
the JAX step's own random draws replayed and fed to the port. The JAX step
is built with ``optax.sgd(1.0)``, so ``old - new`` LGM parameters are its
gradients. Dropout is off on both sides (the UNet's temporal convolutions
carry a fixed dropout of 0.1 that no config turns off, and the two
frameworks' generators never agree): the JAX step gets a deterministic UNet
apply function, the port's UNet is in eval mode. Both sides render with the
dense splat oracle (the port's binned
path and its backward are held against JAX in ``test_torch_splat_bwd.py``).
Also: the port's view-chunked, block-checkpointed step equals the plain
one, and both camera wire modes agree."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import flatten_tree, seeded_like, set_torch_threads
from videomv_tpu.diffusion import GaussianDiffusion as JDiffusion
from videomv_tpu.models import UNetSD_T2VBase as JUNet
from videomv_tpu.models.autoencoder import AutoencoderKL as JVAE
from videomv_tpu.models.lgm import LGM as JLGM
from videomv_tpu.models.lgm import LGMOptions as JLGMOptions
from videomv_tpu.models.lpips import LPIPS as JLPIPS
from videomv_tpu.parallel import make_mesh, replicate, shard_batch
from videomv_tpu.training.lgm_refine import LGMTrainState as JLGMTrainState
from videomv_tpu.training.lgm_refine import build_lgm_refine_step as jbuild_step
from videomv_tpu_torch.data.cameras import GSCameraSettings, get_camera, prepare_gs_training
from videomv_tpu_torch.diffusion import GaussianDiffusion
from videomv_tpu_torch.models import AutoencoderKL, UNetSD_T2VBase
from videomv_tpu_torch.models.lgm import LGM, LGMOptions
from videomv_tpu_torch.models.lpips import LPIPS
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax
from videomv_tpu_torch.training.lgm_refine import RefineDraws, build_lgm_refine_step

set_torch_threads()

B, F_, HW = 2, 4, 8            # 2 samples, 4 views, latents 8×8 → images 16×16
S = R = 16                     # LGM input and render size
UNET = dict(in_dim=4, dim=32, y_dim=16, context_dim=16, out_dim=4, dim_mult=(1,), num_heads=1,
            head_dim=32, num_res_blocks=1, attn_scales=(1.0,), dropout=0.0,
            use_camera_condition=True, temporal_attention=False)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
LGM_OPT = dict(input_size=S, down_channels=(32, 64), down_attention=(False, True),
               mid_attention=True, up_channels=(64, 32), up_attention=(True, False),
               splat_size=S, output_size=R, num_views=3, num_input_views=2)
DIFFUSION = dict(schedule="linear_sd",
                 schedule_param=dict(num_timesteps=100, init_beta=0.00085, last_beta=0.012),
                 mean_type="eps", var_type="fixed_small")
STEP = dict(n_input_views=2, n_supervise_extra=1, render_size=R, ray_size=S,
            splat_backend="dense", lambda_lpips=0.5)
# fp32 both sides through UNet → decode → LGM → dense splat → MSE + LPIPS
LOSS_RTOL = 1e-4
# gradients, per parameter: |got - want| against GRAD_TOL of the largest
# entry of that parameter's gradient plus GRAD_FLOOR of the largest entry of
# the whole gradient. The floor is for the convolution biases in front of a
# GroupNorm, whose gradient is zero in exact arithmetic (1e-9 here) and
# rounding noise in both frameworks; the JAX side is moreover old - new
# parameters after an SGD step of size 1, which rounds at the parameters'
# ulp. The largest mismatch seen is 2.3e-3 (a GroupNorm scale).
GRAD_TOL = 5e-3
GRAD_FLOOR = 1e-5


@pytest.fixture(scope="module")
def setup():
    ju, jv, jl, jp = JUNet(**UNET), JVAE(**VAE), JLGM(opt=JLGMOptions(**LGM_OPT)), JLPIPS()
    key = jax.random.PRNGKey(0)
    rs = np.random.default_rng(21)
    latents = (rs.standard_normal((B, 4, F_, HW, HW)) * 0.2).astype(np.float32)
    y = rs.standard_normal((B, 3, 16)).astype(np.float32)
    cams = np.stack([get_camera(F_, elevation=15, camera_distance=2.0),
                     get_camera(F_, elevation=25, camera_distance=1.8)])
    probe = jnp.zeros((1, 3, R, R))
    params = {
        "unet": seeded_like(jax.eval_shape(lambda: ju.init(
            key, jnp.asarray(latents), jnp.zeros((B,), jnp.int32), y=jnp.asarray(y),
            camera_data=jnp.asarray(cams))), 71),
        "vae": seeded_like(jax.eval_shape(lambda: jv.init(
            key, jnp.zeros((1, 3, 2 * HW, 2 * HW)))), 72),
        "lgm": seeded_like(jax.eval_shape(lambda: jl.init(
            key, jnp.zeros((1, 2, 9, S, S)))), 73),
        "lpips": seeded_like(jax.eval_shape(lambda: jp.init(key, probe, probe)), 74),
    }
    batch = {
        "latents": latents, "y_words": y, "camera_data": cams,
        "images_gt": rs.uniform(0, 1, (B, F_, 3, R, R)).astype(np.float32),
        "masks_gt": rs.uniform(0, 1, (B, F_, 1, R, R)).astype(np.float32),
    }
    return (ju, jv, jl, jp), params, batch


def _jax_draws(rng, step, diffusion, latents):
    """The draws of the JAX step (``lgm_refine.py``: ``fold_in(rng, step)``,
    the 6-way split, randint, sample_noise, two permutations, uniform)."""
    rng = jax.random.fold_in(rng, step)
    t_rng, n_rng, v_rng, e_rng, _, bg_rng = jax.random.split(rng, 6)
    b, f = latents.shape[0], latents.shape[2]
    return dict(
        t=np.asarray(jax.random.randint(t_rng, (b,), 0, diffusion.num_timesteps), np.int64),
        noise=np.asarray(diffusion.sample_noise(n_rng, jnp.asarray(latents))),
        idxs=np.asarray(jax.random.permutation(v_rng, f)[:STEP["n_input_views"]], np.int64),
        extra=np.asarray(jax.random.permutation(e_rng, f)[:STEP["n_supervise_extra"]],
                         np.int64),
        bg=np.asarray(jax.random.uniform(bg_rng, (3,))))


@pytest.fixture(scope="module")
def jax_step(setup):
    """Loss, aux and LGM gradients of one JAX step (SGD with lr 1)."""
    (ju, jv, jl, jp), params, batch = setup
    mesh = make_mesh(1)
    diffusion = JDiffusion(**DIFFUSION)
    opt = optax.sgd(1.0)

    def apply_fn(unet_params, xt, t, y, jbatch, rng):  # make_t2v_apply without dropout
        return ju.apply(unet_params, xt, t, y=y, camera_data=jbatch.get("camera_data"))

    step = jbuild_step(apply_fn, jv, jl, diffusion, opt, mesh, lpips=jp, **STEP)
    old = jax.tree_util.tree_map(np.asarray, params["lgm"])
    state = JLGMTrainState(step=replicate(mesh, jnp.zeros((), jnp.int32)),
                           lgm_params=replicate(mesh, params["lgm"]),
                           opt_state=replicate(mesh, opt.init(params["lgm"])))
    frozen = tuple(replicate(mesh, params[k]) for k in ("unet", "vae", "lpips"))
    rng = jax.random.PRNGKey(5)
    jbatch = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    state, loss, aux = step(state, frozen, jbatch, rng)
    grads = jax.tree_util.tree_map(lambda o, n: o - np.asarray(n), old, state.lgm_params)
    draws = _jax_draws(rng, 0, diffusion, batch["latents"])
    return float(loss), {k: float(v) for k, v in aux.items()}, grads, draws


def _port(module, jax_params):
    module.load_state_dict(state_dict_from_flax(flatten_tree(jax_params["params"]), module))
    return module


@pytest.fixture(scope="module")
def port(setup):
    _, params, batch = setup
    unet = _port(UNetSD_T2VBase(**UNET), params["unet"]).eval().requires_grad_(False)
    vae = _port(AutoencoderKL(**VAE), params["vae"]).eval().requires_grad_(False)
    lpips = _port(LPIPS(), params["lpips"]).eval().requires_grad_(False)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def run(draws, use_checkpoint=False, view_chunk=0, host_cameras=False):
        lgm = _port(LGM(LGMOptions(**LGM_OPT), use_checkpoint=use_checkpoint), params["lgm"])
        step = build_lgm_refine_step(unet, vae, lgm.train(), GaussianDiffusion(**DIFFUSION),
                                     lpips=lpips, view_chunk=view_chunk, **STEP)
        b = dict(tbatch)
        if host_cameras:  # the host chain, per sample, as the engine prepares it
            st = GSCameraSettings(input_size=S, output_size=R)
            per = [prepare_gs_training(batch["camera_data"][i][None], st, ray_size=S)
                   for i in range(B)]
            for key, name in (("gs_rays", "input_rays"), ("cam_view", "cam_view"),
                              ("cam_view_proj", "cam_view_proj")):
                b[key] = torch.from_numpy(np.concatenate([g[name] for g in per]))
        d = RefineDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
                        dropout_seed=0)
        loss, aux = step.loss_fn(b, d)
        loss.backward()
        grads = {k: p.grad.numpy() for k, p in lgm.named_parameters()}
        return loss.item(), {k: float(v) for k, v in aux.items()}, grads, lgm
    return run


def _max_rel(got: dict, want: dict) -> float:
    """Largest per-parameter |got - want| in units of (that parameter's
    largest |want| + GRAD_FLOOR of the largest |want| overall / GRAD_TOL),
    so ``<= tol`` reads: within tol of the leaf's scale, or under the floor."""
    top = max(np.abs(w).max() for w in want.values())
    worst = 0.0
    for k, w in want.items():
        scale = np.abs(w).max() + GRAD_FLOOR * top / GRAD_TOL
        worst = max(worst, float(np.abs(got[k] - w).max() / scale))
    return worst


def test_refine_step_matches_jax(jax_step, port):
    jloss, jaux, jgrads, draws = jax_step
    loss, aux, grads, lgm = port(draws)
    assert np.isfinite(loss) and jaux["loss_lpips"] != 0.0
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["psnr"], jaux["psnr"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["loss_lpips"], jaux["loss_lpips"], rtol=LOSS_RTOL,
                               atol=LOSS_RTOL * abs(jloss))
    want = {k: v.numpy() for k, v in state_dict_from_flax(
        flatten_tree(jgrads["params"]), lgm).items()}
    assert set(want) == set(grads)
    assert max(np.abs(w).max() for w in want.values()) > 1e-4  # gradients worth comparing
    assert _max_rel(grads, want) <= GRAD_TOL


def test_chunked_checkpointed_step_equals_plain(jax_step, port):
    """``view_chunk`` with per-block LGM rematerialisation is numerically the
    plain step: same loss and aux, same gradients."""
    draws = jax_step[3]
    loss0, aux0, grads0, _ = port(draws)
    loss1, aux1, grads1, _ = port(draws, use_checkpoint=True, view_chunk=1)
    np.testing.assert_allclose(loss1, loss0, rtol=1e-6)
    np.testing.assert_allclose(aux1["psnr"], aux0["psnr"], rtol=1e-6)
    np.testing.assert_allclose(aux1["loss_lpips"], aux0["loss_lpips"], rtol=1e-5, atol=1e-9)
    assert _max_rel(grads1, grads0) <= 1e-4


def test_camera_wire_modes_agree(jax_step, port):
    """Cameras derived on the device from ``camera_data`` against the host
    chain's rays and matrices in the batch."""
    draws = jax_step[3]
    loss0, _, grads0, _ = port(draws)
    loss1, _, grads1, _ = port(draws, host_cameras=True)
    np.testing.assert_allclose(loss1, loss0, rtol=1e-4)
    assert _max_rel(grads1, grads0) <= 1e-2


def test_step_updates_only_the_lgm_and_draws_from_its_generator(setup, port):
    """``refine_step`` with a generator: deterministic in its seed, and the
    update goes through the optimizer."""
    from videomv_tpu_torch.training.lgm_refine import LGMTrainState, draw_refine_randoms
    from videomv_tpu_torch.training.optim import build_optimizer

    _, params, batch = setup
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    diffusion = GaussianDiffusion(**DIFFUSION)
    d1 = draw_refine_randoms(torch.Generator().manual_seed(3), tbatch["latents"], diffusion, 2, 1)
    d2 = draw_refine_randoms(torch.Generator().manual_seed(3), tbatch["latents"], diffusion, 2, 1)
    assert torch.equal(d1.noise, d2.noise) and torch.equal(d1.idxs, d2.idxs)
    assert d1.t.shape == (B,) and d1.idxs.shape == (2,) and d1.extra.shape == (1,)
    assert len(set(d1.idxs.tolist())) == 2 and d1.dropout_seed == d2.dropout_seed

    losses = []
    for _ in range(2):
        lgm = _port(LGM(LGMOptions(**LGM_OPT)), params["lgm"]).train()
        unet = _port(UNetSD_T2VBase(**UNET), params["unet"]).train().requires_grad_(False)
        vae = _port(AutoencoderKL(**VAE), params["vae"]).eval().requires_grad_(False)
        step = build_lgm_refine_step(unet, vae, lgm, diffusion, **STEP)
        state = LGMTrainState(0, lgm, build_optimizer(lgm.parameters(), lr=1e-3, warmup_steps=0))
        before = [p.detach().clone() for p in lgm.parameters()]
        frozen = [p.detach().clone() for p in unet.parameters()]
        gen = torch.Generator().manual_seed(9)
        losses.append([float(step(state, tbatch, generator=gen)[0]) for _ in range(2)])
        assert state.step == 2 and state.optimizer.count == 2
        assert max(float((a - b.detach()).abs().max())
                   for a, b in zip(before, lgm.parameters())) > 0
        assert all(torch.equal(a, b) for a, b in zip(frozen, unet.parameters()))
    assert losses[0] == losses[1] and losses[0][0] != losses[0][1]
    with pytest.raises(ValueError, match="generator"):
        step(state, tbatch)

