"""The Gaussian-splat refine step (``make_refine_fn``) of the port against the
JAX package's, at the small sizes of ``tests/test_refine_fn.py``, fp32 on
the CPU, with the same seeded weights (UNet, VAE, LGM), latents, text
encodings and cameras; both sides render with the dense splat oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import flatten_tree, rel_err, seeded_like, set_torch_threads
from videomv_tpu.data.cameras import GSCameraSettings as JGS
from videomv_tpu.diffusion import GaussianDiffusion as JDiffusion
from videomv_tpu.inference.refine import make_refine_fn as jmake_refine_fn
from videomv_tpu.models import UNetSD_T2VBase as JUNet
from videomv_tpu.models.autoencoder import AutoencoderKL as JVAE
from videomv_tpu.models.lgm import LGM as JLGM
from videomv_tpu.models.lgm import LGMOptions as JLGMOptions
from videomv_tpu_torch.data.cameras import (
    GSCameraSettings,
    orbit_c2w_opengl,
    orbit_camera_for_t2v,
    prepare_gs_training,
)
from videomv_tpu_torch.diffusion import GaussianDiffusion
from videomv_tpu_torch.inference.refine import make_refine_fn
from videomv_tpu_torch.models import AutoencoderKL, UNetSD_T2VBase
from videomv_tpu_torch.models.lgm import LGM, LGMOptions
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

F_, HW = 6, 4                     # 6 views, latents 4×4 → images 32×32
SIZE = 8 * HW
UNET = dict(dim=64, y_dim=16, context_dim=16, dim_mult=(1, 2), num_heads=2, head_dim=16,
            num_res_blocks=1, attn_scales=(1.0,), dropout=0.0, use_camera_condition=True)
VAE = dict(ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=1)
LGM_OPT = dict(input_size=SIZE, down_channels=(32, 64), down_attention=(False, True),
               mid_attention=True, up_channels=(64, 32), up_attention=(True, False),
               splat_size=SIZE, output_size=SIZE, num_views=F_, num_input_views=4)
DIFFUSION = dict(schedule="linear_sd",
                 schedule_param=dict(num_timesteps=100, init_beta=0.00085, last_beta=0.012),
                 mean_type="eps", var_type="fixed_small")
VIEWS = (0, 1, 2, 3)
# fp32 both sides through UNet → decode → LGM → splat → encode
REL_TOL = 1e-3


def _port(module, jax_params):
    module.load_state_dict(state_dict_from_flax(flatten_tree(jax_params["params"]), module))
    return module.eval()


@pytest.fixture(scope="module")
def stacks():
    ju, jv, jl = JUNet(**UNET), JVAE(**VAE), JLGM(opt=JLGMOptions(**LGM_OPT))
    key = jax.random.PRNGKey(0)
    cam = orbit_camera_for_t2v(F_)
    params = {
        "unet": seeded_like(jax.eval_shape(lambda: ju.init(
            key, jnp.zeros((1, 4, F_, HW, HW)), jnp.zeros((1,), jnp.int32),
            y=jnp.zeros((1, 5, 16)), camera_data=jnp.asarray(cam))), 51),
        "vae": seeded_like(jax.eval_shape(lambda: jv.init(key, jnp.zeros((1, 3, SIZE, SIZE)))),
                           52),
        "lgm": seeded_like(jax.eval_shape(lambda: jl.init(
            key, jnp.zeros((1, 4, 9, SIZE, SIZE)))), 53),
    }
    gs = prepare_gs_training(orbit_c2w_opengl(F_, 15.0, 2.0),
                             GSCameraSettings(input_size=SIZE, output_size=SIZE), ray_size=SIZE)
    rs = np.random.default_rng(8)
    y = rs.standard_normal((1, 5, 16)).astype(np.float32)
    zero_y = rs.standard_normal((1, 5, 16)).astype(np.float32)
    xt = rs.standard_normal((1, 4, F_, HW, HW)).astype(np.float32)
    inputs = dict(y=y, zero_y=zero_y, cam=cam, gs_rays=gs["input_rays"],
                  cam_view=gs["cam_view"], cam_view_proj=gs["cam_view_proj"])
    jcommon = dict(unet=ju, vae=jv, lgm=jl, params=params, diffusion=JDiffusion(**DIFFUSION),
                   scale_factor=0.18215, batch=1, gs_settings=JGS(input_size=SIZE,
                                                                  output_size=SIZE),
                   splat_backend="dense", view_idxs=VIEWS,
                   **{k: jnp.asarray(v) for k, v in inputs.items()})
    tcommon = dict(unet=_port(UNetSD_T2VBase(**UNET), params["unet"]),
                   vae=_port(AutoencoderKL(**VAE), params["vae"]),
                   lgm=_port(LGM(LGMOptions(**LGM_OPT)), params["lgm"]),
                   diffusion=GaussianDiffusion(**DIFFUSION), scale_factor=0.18215, batch=1,
                   gs_settings=GSCameraSettings(input_size=SIZE, output_size=SIZE),
                   view_idxs=VIEWS, **{k: torch.from_numpy(v) for k, v in inputs.items()})
    return jcommon, tcommon, xt


@pytest.fixture(scope="module")
def outputs(stacks):
    jcommon, tcommon, xt = stacks
    out = {}
    for mode in ("full", "shared"):
        j = jax.jit(jmake_refine_fn(**jcommon, uncond_mode=mode))(
            jnp.asarray(xt), jnp.full((1,), 40, jnp.int32))
        t = make_refine_fn(**tcommon, uncond_mode=mode)(
            torch.from_numpy(xt), torch.full((1,), 40, dtype=torch.long))
        out[mode] = ([np.asarray(a) for a in j], [a.numpy() for a in t])
    return out


@pytest.mark.parametrize("mode", ["full", "shared"])
def test_refine_fn_matches_jax(outputs, mode):
    want, got = outputs[mode]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 4, F_, HW, HW)
        assert np.isfinite(g).all() and np.abs(w).max() > 0
        assert rel_err(g, w) <= REL_TOL


def test_shared_mode_returns_identical_rows(outputs):
    _, (cond, uncond) = outputs["shared"]
    np.testing.assert_array_equal(cond, uncond)
    # the cond row is the full mode's cond row (each CFG row refines alone;
    # batch 1 and batch 2 convolutions round differently)
    assert rel_err(cond, outputs["full"][1][0]) <= REL_TOL


def test_bad_uncond_mode_raises(stacks):
    _, tcommon, _ = stacks
    with pytest.raises(ValueError, match="uncond_mode"):
        make_refine_fn(**tcommon, uncond_mode="half")
