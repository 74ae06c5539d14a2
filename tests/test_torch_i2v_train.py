"""I2V training of the port against the JAX package, the slice as a whole at
a small size, fp32 on the CPU. The I2V UNet of the JAX package's own tiny
I2V step (tests/test_parallel.py: dim 64, y_dim 48, context 32, dim_mult
(1, 2), 2 heads × 16, block checkpointing) with the same seeded weights
through the Flax-tree bridge, the same batch and the JAX step's own draws
(t, the noise with its offset, the classifier-free drop) replayed, under the
shipped configs/i2vgen_xl_train.yaml diffusion (cosine, zero terminal SNR,
v-prediction, noise_strength 0.1). Dropout is off on both sides, as in
``test_torch_unet_train.py``. One step through SGD(1) (loss and gradients),
two steps of the shipped chain (AdamW, the SD keys at 0.5, EMA),
``encode_batch``'s ``local_image`` and ``image_embed`` against JAX
``T2VTrainer.encode_batch`` on small towers, ``i2v_viz``'s sampler on shared
noise against the JAX visualisation's CFG DDIM, and the training CLI. The
LGM-refine step behind the I2V denoiser is in
``test_torch_i2v_train_refine.py``."""

import functools
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import videomv_tpu_torch.training.engine as engine
from test_torch_unet_train import _jax_draws, _max_rel, _SGD, _to_torch_names
from torch_port_helpers import flatten_tree, rel_err, seeded_like, set_torch_threads
from videomv_tpu.config import AttrDict as JAttrDict
from videomv_tpu.diffusion import GaussianDiffusion as JDiffusion
from videomv_tpu.diffusion.samplers import ddim_sample_loop as jddim_sample_loop
from videomv_tpu.models import UNetSD_I2VGen as JUNet
from videomv_tpu.models.autoencoder import AutoencoderKL as JVAE
from videomv_tpu.models.clip import CLIPTextTower as JText
from videomv_tpu.models.clip import CLIPVisionTower as JVision
from videomv_tpu.parallel import TrainState as JTrainState
from videomv_tpu.parallel import build_train_step as jbuild_train_step
from videomv_tpu.parallel import make_mesh, replicate, shard_batch
from videomv_tpu.training.engine import T2VTrainer as JTrainer
from videomv_tpu.training.optim import build_optimizer as jbuild_optimizer
from videomv_tpu_torch.config import load_config
from videomv_tpu_torch.diffusion import GaussianDiffusion
from videomv_tpu_torch.models import AutoencoderKL, CLIPVisionTower, OpenCLIPTextVisual
from videomv_tpu_torch.models import UNetSD_I2VGen
from videomv_tpu_torch.parallel import TrainState, build_train_step, make_i2v_apply
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax
from videomv_tpu_torch.training.optim import build_optimizer

set_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
I2V_CFG = os.path.join(REPO, "configs", "i2vgen_xl_train.yaml")
SD_KEYS = os.path.join(REPO, "data", "stable_diffusion_image_key_temporal_attention_x1.json")
UNET = dict(in_dim=4, dim=64, y_dim=48, context_dim=32, out_dim=4, dim_mult=(1, 2),
            num_heads=2, head_dim=16, num_res_blocks=1, attn_scales=(1.0,), dropout=0.0,
            use_camera_condition=True, use_checkpoint=True)
# the shipped config's diffusion (configs/i2vgen_xl_train.yaml)
DIFFUSION = dict(schedule="cosine",
                 schedule_param=dict(num_timesteps=1000, cosine_s=0.008, zero_terminal_snr=True),
                 mean_type="v", var_type="fixed_small", loss_type="mse", noise_strength=0.1)
B, F_, HW, L = 2, 4, 8, 5
P_ZERO = 0.5
# fp32 on both sides; the tolerances of the T2V step's tests
LOSS_RTOL = 1e-4
GRAD_TOL = 5e-3
PARAM_TOL = 1e-5
# i2v_viz's sampler: guided steps amplify per-forward rounding (the I2V
# sampler's tolerance, test_torch_i2v.py)
LATENT_REL_TOL = 1e-3
# the tiny engine config: configs/i2vgen_xl_train.yaml with these widths,
# small towers (see small_towers) and fp32
TINY = ["UNet.dim", "64", "UNet.y_dim", "48", "UNet.context_dim", "32", "UNet.dim_mult", "[1, 2]",
        "UNet.num_heads", "2", "UNet.head_dim", "16", "UNet.num_res_blocks", "1",
        "frame_lens", "[4]", "resolution", "[64, 64]", "batch_sizes", "{'4': 2}",
        "training_dtype", "float32", "save_ckp_interval", "0"]
SMALL_TEXT = dict(width=32, heads=2, layers=3, embed_dim=32)
SMALL_VISION = dict(image_size=224, patch_size=32, width=32, heads=2, layers=2, embed_dim=48)
SMALL_VAE = dict(ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=1)


def _jax_apply(ju):
    def apply_fn(params, xt, t, y, batch, rng):  # make_i2v_apply without dropout
        return ju.apply(params, xt, t, y=y, camera_data=batch.get("camera_data"),
                        local_image=batch["local_image"], image=batch.get("image_embed"))
    return apply_fn


@pytest.fixture(scope="module")
def setup():
    ju = JUNet(**UNET)
    rs = np.random.default_rng(61)
    latents = (rs.standard_normal((B, 4, F_, HW, HW)) * 0.5).astype(np.float32)
    batch = {"latents": latents,
             "y_words": rs.standard_normal((B, L, UNET["context_dim"])).astype(np.float32),
             "camera_data": rs.standard_normal((B, F_, 16)).astype(np.float32),
             "local_image": latents[:, :, :1].copy(),
             "image_embed": rs.standard_normal((B, UNET["y_dim"])).astype(np.float32)}
    shapes = jax.eval_shape(lambda: ju.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 4, F_, HW, HW)), jnp.zeros((B,), jnp.int32),
        y=jnp.zeros((B, L, UNET["context_dim"])), camera_data=jnp.zeros((B, F_, 16)),
        local_image=jnp.zeros((B, 4, 1, HW, HW)), image=jnp.zeros((B, UNET["y_dim"]))))
    params = jax.tree_util.tree_map(np.asarray, seeded_like(shapes, 62))
    zero_y = rs.standard_normal((1, L, UNET["context_dim"])).astype(np.float32)
    return ju, params, batch, zero_y


def _jax_run(setup, opt, steps=1, use_ema=False, ema_decay=0.9):
    """``steps`` JAX I2V train steps; returns (losses, params, ema, draws)."""
    ju, params, batch, zero_y = setup
    mesh = make_mesh(1)
    diffusion = JDiffusion(**DIFFUSION)
    step = jbuild_train_step(_jax_apply(ju), diffusion, opt, mesh, ema_decay=ema_decay,
                             use_ema=use_ema, p_zero=P_ZERO, zero_y=jnp.asarray(zero_y))
    fresh = lambda: jax.tree_util.tree_map(jnp.array, params)  # noqa: E731 - the step donates
    state = JTrainState(step=replicate(mesh, jnp.zeros((), jnp.int32)),
                        params=replicate(mesh, fresh()),
                        opt_state=replicate(mesh, opt.init(fresh())),
                        ema_params=replicate(mesh, fresh()) if use_ema else None)
    rng = jax.random.PRNGKey(11)  # step 0 drops one row of two
    jbatch = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    losses, draws = [], []
    for i in range(steps):
        state, loss = step(state, jbatch, rng)
        losses.append(float(loss))
        draws.append(_jax_draws(rng, i, diffusion, batch["latents"]))
    ema = jax.tree_util.tree_map(np.asarray, state.ema_params) if use_ema else None
    return losses, jax.tree_util.tree_map(np.asarray, state.params), ema, draws


def _port_unet(params):
    unet = UNetSD_I2VGen(**UNET)
    unet.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), unet))
    for m in unet.modules():
        if isinstance(m, torch.nn.Dropout):  # the temporal convolutions' fixed 0.1
            m.p = 0.0
    return unet.train()


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_one_i2v_step_matches_jax(setup):
    _, params, batch, zero_y = setup
    losses, new, _, draws = _jax_run(setup, optax.sgd(1.0))
    jgrads = jax.tree_util.tree_map(lambda o, n: np.asarray(o) - n, params, new)
    assert draws[0].drop.any() and not draws[0].drop.all()  # one row of each kind
    unet = _port_unet(params)
    old = {k: p.detach().clone() for k, p in unet.named_parameters()}
    step = build_train_step(make_i2v_apply(unet), GaussianDiffusion(**DIFFUSION), use_ema=False,
                            p_zero=P_ZERO, zero_y=torch.from_numpy(zero_y))
    state = TrainState(step=0, unet=unet, optimizer=_SGD(unet.parameters()))
    loss = step(state, _tbatch(batch), draws=draws[0])
    np.testing.assert_allclose(float(loss), losses[0], rtol=LOSS_RTOL)
    grads = {k: (old[k] - p.detach()).numpy() for k, p in unet.named_parameters()}
    want = _to_torch_names(jgrads, unet)
    assert set(want) == set(grads)
    # the image conditioning takes a gradient: its adapters are trained
    for name in ("local_image_concat", "local_image_embedding", "context_embedding"):
        assert max(np.abs(w).max() for k, w in want.items() if k.startswith(name)) > 0, name
    assert _max_rel(grads, want) <= GRAD_TOL


def test_two_steps_of_the_shipped_chain_match_jax(setup):
    """AdamW under ``annealing_lr`` without warm-up, the SD keys' gradients
    at the shipped 0.5, EMA on."""
    _, params, batch, zero_y = setup
    kw = dict(lr=3e-5, warmup_steps=0, total_steps=100, grad_scale=0.5, sd_keys_path=SD_KEYS)
    losses, jparams, jema, draws = _jax_run(setup, jbuild_optimizer(**kw), steps=2, use_ema=True)
    unet = _port_unet(params)
    opt = build_optimizer(unet.named_parameters(), **kw)
    assert len(opt.scaled) > 20
    step = build_train_step(make_i2v_apply(unet), GaussianDiffusion(**DIFFUSION), ema_decay=0.9,
                            use_ema=True, p_zero=P_ZERO, zero_y=torch.from_numpy(zero_y))
    state = TrainState(step=0, unet=unet, optimizer=opt,
                       ema=[p.detach().clone() for p in unet.parameters()])
    for i in range(2):
        loss = step(state, _tbatch(batch), draws=draws[i])
        np.testing.assert_allclose(float(loss), losses[i], rtol=LOSS_RTOL)
    assert state.step == 2 and opt.count == 2
    names = [k for k, _ in unet.named_parameters()]
    got = {k: p.detach().numpy() for k, p in unet.named_parameters()}
    got_ema = {k: e.numpy() for k, e in zip(names, state.ema)}
    for mine, theirs in ((got, _to_torch_names(jparams, unet)),
                         (got_ema, _to_torch_names(jema, unet))):
        top = max(float(np.abs(w).max()) for w in theirs.values())
        worst = max(float(np.abs(mine[k] - w).max()) for k, w in theirs.items())
        assert worst <= PARAM_TOL * top, (worst, top)


# ------------------------------------------------------------------ engine


class JJoint(nn.Module):
    """The JAX joint CLIP with small towers, under the method names that
    ``T2VTrainer.encode_batch`` calls."""

    def setup(self):
        self.text = JText(**SMALL_TEXT)
        self.visual = JVision(**SMALL_VISION)

    def __call__(self, tokens, images):
        return self.visual(images), *self.text(tokens)

    def encode_text(self, tokens):
        return self.text(tokens)

    def encode_image(self, images):
        return self.visual(images)


def _small_joint():
    return OpenCLIPTextVisual(visual=CLIPVisionTower(**SMALL_VISION), **SMALL_TEXT)


@pytest.fixture()
def small_towers(monkeypatch):
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(engine, "OpenCLIPTextVisual", _small_joint)
    monkeypatch.setattr(engine, "AutoencoderKL", functools.partial(AutoencoderKL, **SMALL_VAE))


def _trainer(tmp_path, *opts):
    cfg = load_config(I2V_CFG, opts=[*TINY, "log_dir", str(tmp_path), *opts])
    return engine.T2VTrainer(cfg, device="cpu").init(zero_init=False)


def test_encode_batch_matches_jax(small_towers, tmp_path):
    """``latents``, ``y_words``, ``local_image`` and ``image_embed`` of one
    host batch against JAX ``T2VTrainer.encode_batch`` (engine.py:473-530)
    on the same small towers and weights."""
    from videomv_tpu_torch.data.datasets import SyntheticMVDataset, batch_iterator

    tr = _trainer(tmp_path)
    assert tr.is_i2v and isinstance(tr.unet, UNetSD_I2VGen)
    jt = object.__new__(JTrainer)
    jt.cfg, jt.is_i2v, jt.scale_factor = JAttrDict({}), True, tr.scale_factor
    jt.vae, jt.clip = JVAE(**SMALL_VAE), JJoint()
    jt._encode_batch = jt._encode_image = None
    key = jax.random.PRNGKey(0)
    jt.params = {
        "vae": seeded_like(jax.eval_shape(lambda: jt.vae.init(key, jnp.zeros((1, 3, 64, 64)))),
                           31),
        "clip": seeded_like(jax.eval_shape(lambda: jt.clip.init(
            key, jnp.zeros((1, 77), jnp.int32), jnp.zeros((1, 3, 224, 224)))), 32)}
    for name in ("vae", "clip"):
        module = getattr(tr, name)
        module.load_state_dict(state_dict_from_flax(flatten_tree(jt.params[name]["params"]),
                                                    module))
    host = next(batch_iterator(SyntheticMVDataset(resolution=(64, 64), max_frames=4, seed=4), 2))
    host["caption"] = ["", "a box"]
    want = jt.encode_batch(host)
    got = tr.encode_batch(host)
    assert set(got) == set(want) == {"latents", "y_words", "camera_data", "local_image",
                                     "image_embed"}
    assert got["image_embed"].shape == (2, 48) and got["local_image"].shape == (2, 4, 1, 8, 8)
    for k in want:
        assert rel_err(got[k].numpy(), want[k]) <= 1e-4, k
    assert torch.equal(got["local_image"], got["latents"][:, :, :1])


def test_i2v_viz_sampler_matches_jax(small_towers, setup, tmp_path):
    """``sample_i2v_viz`` on shared noise and conditioning against the JAX
    visualisation's sampler (engine.py:664-687: CFG rows ``[cond; uncond]``
    where only the text becomes ``zero_y``, DDIM with eta 0 at
    ``visual_train.guide_scale``), then ``i2v_viz`` writes its file."""
    ju, params, batch, _ = setup
    tr = _trainer(tmp_path, "ddim_timesteps", "4", "UNet.attn_scales", "[1.0]")
    tr.unet.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), tr.unet))
    tr.unet.eval()
    rs = np.random.default_rng(5)
    tr.zero_y = torch.from_numpy(rs.standard_normal((1, 77, 32)).astype(np.float32))
    noise = rs.standard_normal((1, 4, F_, HW, HW)).astype(np.float32)
    feats = {k: np.asarray(v)[:1] for k, v in batch.items()}
    feats["y_words"] = rs.standard_normal((1, 77, UNET["context_dim"])).astype(np.float32)
    got = tr.sample_i2v_viz(torch.from_numpy(noise), _tbatch(feats)).numpy()

    diffusion = JDiffusion(**DIFFUSION)

    def cfg_model(xt, t):  # the JAX trainer's visualisation closure
        zy = jnp.asarray(tr.zero_y.numpy())
        y = jnp.asarray(feats["y_words"])
        out = ju.apply(params, jnp.concatenate([xt, xt]), jnp.concatenate([t, t]),
                       y=jnp.concatenate([y, jnp.broadcast_to(zy, y.shape)]),
                       camera_data=jnp.concatenate([feats["camera_data"]] * 2),
                       local_image=jnp.concatenate([feats["local_image"]] * 2),
                       image=jnp.concatenate([feats["image_embed"]] * 2))
        return out[:1], out[1:]

    want = jax.jit(lambda n: jddim_sample_loop(diffusion, cfg_model, n, ddim_timesteps=4,
                                               eta=0.0, guide_scale=6.0,
                                               rng=jax.random.PRNGKey(0)))(jnp.asarray(noise))
    assert float(tr.cfg.visual_train.guide_scale) == 6.0
    assert rel_err(got, want) <= LATENT_REL_TOL

    tr.unet.train()
    path = tr.i2v_viz(7, _tbatch(feats), ["a"], str(tmp_path))
    assert path is not None and os.path.exists(path) and "viz_step_00000007" in path
    assert tr.unet.training
    # never raises into the loop: a broken batch is logged and gives None
    assert tr.i2v_viz(8, {"latents": torch.zeros(1, 4, F_, HW, HW)}, [], str(tmp_path)) is None
    assert tr.unet.training


def test_i2v_trainer_takes_steps_with_ema_and_viz(small_towers, tmp_path):
    """The I2V finetune through ``T2VTrainer.train``: the UNet and its EMA
    move, the frozen towers do not, the visualisation of the live batch is
    written at ``viz_interval`` over the EMA weights, which are swapped back."""
    tr = _trainer(tmp_path, "viz_interval", "2", "ddim_timesteps", "2")
    assert tr.state.ema is not None and tr.zero_y.shape == (1, 77, 32)
    assert len(tr.state.optimizer.scaled) > 20 and tr.diffusion.noise_strength == 0.1
    frozen = {n: [p.detach().clone() for p in getattr(tr, n).parameters()]
              for n in ("vae", "clip")}
    before = [p.detach().clone() for p in tr.unet.parameters()]
    loss = tr.train(num_steps=2)
    assert np.isfinite(loss) and tr.state.step == 2
    assert max(float((a - b.detach()).abs().max())
               for a, b in zip(before, tr.unet.parameters())) > 0
    assert max(float((a - e).abs().max()) for a, e in zip(before, tr.state.ema)) > 0
    for name, snap in frozen.items():
        assert all(torch.equal(a, b) for a, b in zip(snap, getattr(tr, name).parameters())), name
    assert any(n.startswith("viz_step_00000002") for n in os.listdir(tmp_path / "viz"))
    assert tr.unet.training
    assert all(not torch.equal(p, e) for p, e in zip(tr.unet.parameters(), tr.state.ema)
               if p.numel() > 1)


def test_i2v_training_cli_on_cpu(small_towers, tmp_path):
    from videomv_tpu_torch.training.__main__ import main

    loss = main(["--cfg", I2V_CFG, "--steps", "2", "--device", "cpu", *TINY, "log_dir",
                 str(tmp_path)])
    assert np.isfinite(loss) and loss > 0
