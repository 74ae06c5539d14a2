"""The whole T2V slice at tiny size, port against the JAX package: the JAX
pipeline's own sampler program (``_build_sampler``, 10 DDIM steps, CFG 9.0,
no refine; and 4 steps with the Gaussian-splat refine at step 2) and
``_decode_latents`` against the port's ``sample`` and ``_decode_latents``,
fp32 on the CPU, with the same seeded weights, numpy noise, text encodings
(``y``, ``zero_y``) and orbit cameras. Also runs the port's CLI on
``configs/t2v_infer_tiny.yaml``, plain and with the refine."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import flatten_tree, rel_err, seeded_like, set_torch_threads
from videomv_tpu.config import load_inference_config as jload_inference_config
from videomv_tpu.inference.pipeline import T2VPipeline as JPipeline
from videomv_tpu_torch.config import load_inference_config
from videomv_tpu_torch.data.cameras import orbit_camera_for_t2v
from videomv_tpu_torch.inference import T2VPipeline
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "t2v_infer_tiny.yaml")
# fp32 both sides; 10 guided steps amplify per-forward rounding differences
LATENT_REL_TOL = 1e-3
MIN_PSNR_DB = 40.0


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def slices():
    opts = ["sampling_dtype", "float32"]
    jp = JPipeline(jload_inference_config(TINY_CFG, opts=opts))
    tp = T2VPipeline(load_inference_config(TINY_CFG, opts=opts), device="cpu")
    f, (h, w) = jp.max_frames, jp.latent_hw
    x = jnp.zeros((1, 4, f, h, w))
    unet_shapes = jax.eval_shape(lambda: jp.unet.init(
        jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32), y=jnp.zeros((1, 77, 1024)),
        camera_data=jnp.zeros((1, f, 16))))
    vae_shapes = jax.eval_shape(lambda: jp.vae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, h * 8, w * 8))))
    jp._params = {"unet": seeded_like(unet_shapes, seed=31), "vae": seeded_like(vae_shapes, 32)}
    tp.load_state_dicts(
        unet=state_dict_from_flax(flatten_tree(jp._params["unet"]["params"]), tp.unet),
        vae=state_dict_from_flax(flatten_tree(jp._params["vae"]["params"]), tp.vae))

    rs = np.random.default_rng(7)
    noise = rs.standard_normal((1, 4, f, h, w)).astype(np.float32)
    y = rs.standard_normal((1, 77, 1024)).astype(np.float32)
    zero_y = rs.standard_normal((1, 77, 1024)).astype(np.float32)
    cam = orbit_camera_for_t2v(f)
    sample = jp._build_sampler(steps=10, guide_scale=9.0, with_refine=False)
    lat_j = sample(jp._params, noise, y, zero_y, cam, None, None, None, jax.random.PRNGKey(0))
    frames_j = np.asarray(jp._decode_latents(lat_j))
    lat_t = tp.sample(*(torch.from_numpy(a) for a in (noise, y, zero_y, cam)),
                      steps=10, guide_scale=9.0)
    frames_t = tp._decode_latents(lat_t).numpy()
    return np.asarray(lat_j), frames_j, lat_t.numpy(), frames_t


def test_latents_match_jax(slices):
    lat_j, _, lat_t, _ = slices
    assert lat_t.shape == lat_j.shape == (1, 4, 8, 8, 8)
    assert np.isfinite(lat_t).all()
    assert rel_err(lat_t, lat_j) <= LATENT_REL_TOL


def test_decoded_frames_match_jax(slices):
    _, frames_j, _, frames_t = slices
    assert frames_t.dtype == np.uint8 and frames_t.shape == frames_j.shape == (1, 8, 64, 64, 3)
    assert frames_t.std() > 0  # not a constant image
    for v in range(frames_t.shape[1]):
        assert _psnr(frames_t[0, v], frames_j[0, v]) >= MIN_PSNR_DB, v


def test_cli_writes_one_output_per_prompt(tmp_path, monkeypatch):
    """``python -m videomv_tpu_torch.inference`` on the tiny config, CPU,
    fp32. A small text tower stands in for ViT-H (UNet context 64 to match)."""
    import functools

    import videomv_tpu_torch.inference.pipeline as tpipeline
    from videomv_tpu_torch.inference.__main__ import main
    from videomv_tpu_torch.models import CLIPTextTower

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(tpipeline, "CLIPTextTower",
                        functools.partial(CLIPTextTower, width=64, heads=2, layers=3))
    written = main(["--cfg", TINY_CFG, "--debug", "--device", "cpu",
                    "sampling_dtype", "float32", "log_dir", str(tmp_path),
                    "UNet.context_dim", "64"])
    assert len(written) == 1 and os.path.exists(written[0])
    assert os.path.dirname(written[0]) == str(tmp_path)


# the refined tiny slice: a 32² sample, its splat cameras at 32², and a
# small VAE and LGM (those of tests/test_pipeline_batch.py)
REFINE_OPTS = ["sampling_dtype", "float32", "resolution", "[32, 32]", "UNet.use_lgm_refine",
               "True", "gs_refine_uncond", "shared", "gs_refine_steps", "[2]",
               "gs_refine_views", "[0, 1, 2, 3]", "gs_input_size", "32", "gs_render_size", "32"]
SMALL_VAE = dict(ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=1)


def _small_lgm(size):
    return dict(input_size=size, down_channels=(32, 64), down_attention=(False, True),
                mid_attention=True, up_channels=(64, 32), up_attention=(True, False),
                splat_size=size, output_size=size, num_views=8, num_input_views=4)


@pytest.fixture(scope="module")
def refined():
    from videomv_tpu.models.autoencoder import AutoencoderKL as JVAE
    from videomv_tpu.models.lgm import LGM as JLGM
    from videomv_tpu.models.lgm import LGMOptions as JLGMOptions
    from videomv_tpu_torch.models import AutoencoderKL
    from videomv_tpu_torch.models.lgm import LGM, LGMOptions

    jp = JPipeline(jload_inference_config(TINY_CFG, opts=REFINE_OPTS))
    tp = T2VPipeline(load_inference_config(TINY_CFG, opts=REFINE_OPTS), device="cpu")
    jp.vae, jp.lgm = JVAE(**SMALL_VAE), JLGM(opt=JLGMOptions(**_small_lgm(32)))
    tp.vae, tp.lgm = AutoencoderKL(**SMALL_VAE), LGM(LGMOptions(**_small_lgm(32)))
    f, (h, w) = jp.max_frames, jp.latent_hw
    key = jax.random.PRNGKey(0)
    jp._params = {
        "unet": seeded_like(jax.eval_shape(lambda: jp.unet.init(
            key, jnp.zeros((1, 4, f, h, w)), jnp.zeros((1,), jnp.int32),
            y=jnp.zeros((1, 77, 1024)), camera_data=jnp.zeros((1, f, 16)))), seed=61),
        "vae": seeded_like(jax.eval_shape(lambda: jp.vae.init(
            key, jnp.zeros((1, 3, 32, 32)))), seed=62),
        "lgm": seeded_like(jax.eval_shape(lambda: jp.lgm.init(
            key, jnp.zeros((1, 4, 9, 32, 32)))), seed=63),
    }
    tp.load_state_dicts(**{name: state_dict_from_flax(flatten_tree(p["params"]),
                                                      tp.models[name])
                           for name, p in jp._params.items()})
    cams = [np.asarray(a) for a in jp._get_cameras(15.0, 2.0)]
    rs = np.random.default_rng(17)
    noise = rs.standard_normal((1, 4, f, h, w)).astype(np.float32)
    y = rs.standard_normal((1, 77, 1024)).astype(np.float32)
    zero_y = rs.standard_normal((1, 77, 1024)).astype(np.float32)
    sample = jp._build_sampler(steps=4, guide_scale=9.0, with_refine=True)
    lat_j = sample(jp._params, noise, y, zero_y, *cams, jax.random.PRNGKey(0))
    frames_j = np.asarray(jp._decode_latents(lat_j))
    t_args = [torch.from_numpy(a) for a in (noise, y, zero_y, cams[0])]
    lat_t = tp.sample(*t_args, steps=4, guide_scale=9.0,
                      gs=tuple(torch.from_numpy(a) for a in cams[1:]))
    plain_t = tp.sample(*t_args, steps=4, guide_scale=9.0)
    frames_t = tp._decode_latents(lat_t).numpy()
    return dict(tp=tp, cams=cams, lat_j=np.asarray(lat_j), frames_j=frames_j,
                lat_t=lat_t.numpy(), frames_t=frames_t, plain_t=plain_t.numpy())


def test_refined_latents_match_jax(refined):
    lat_t, lat_j = refined["lat_t"], refined["lat_j"]
    assert lat_t.shape == lat_j.shape == (1, 4, 8, 4, 4)
    assert np.isfinite(lat_t).all()
    assert rel_err(lat_t, lat_j) <= LATENT_REL_TOL
    # the refine step did change the sample
    assert rel_err(refined["plain_t"], lat_j) > 100 * LATENT_REL_TOL
    # the port's own splat cameras are the JAX pipeline's
    for got, want in zip(refined["tp"]._get_cameras(15.0, 2.0), refined["cams"]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_refined_frames_match_jax(refined):
    frames_t, frames_j = refined["frames_t"], refined["frames_j"]
    assert frames_t.dtype == np.uint8 and frames_t.shape == frames_j.shape == (1, 8, 32, 32, 3)
    for v in range(frames_t.shape[1]):
        assert _psnr(frames_t[0, v], frames_j[0, v]) >= MIN_PSNR_DB, v


def test_cli_with_refine_writes_plain_refined_and_ply(tmp_path, monkeypatch):
    """The CLI with ``UNet.use_lgm_refine True`` (and ``save_ply``) writes the
    plain sample, the ``_gs`` sample and the ``.ply``. A small text tower
    and a small LGM stand in for ViT-H and LGM 'big'."""
    import functools

    import videomv_tpu_torch.inference.pipeline as tpipeline
    from videomv_tpu_torch.inference.__main__ import main
    from videomv_tpu_torch.models import CLIPTextTower
    from videomv_tpu_torch.models.lgm import LGM, LGMOptions
    from videomv_tpu_torch.ops.ply_io import load_ply

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(tpipeline, "CLIPTextTower",
                        functools.partial(CLIPTextTower, width=64, heads=2, layers=3))
    monkeypatch.setattr(tpipeline, "LGM", lambda opt: LGM(LGMOptions(**_small_lgm(32))))
    written = main(["--cfg", TINY_CFG, "--debug", "--device", "cpu",
                    "sampling_dtype", "float32", "log_dir", str(tmp_path),
                    "UNet.context_dim", "64", "UNet.use_lgm_refine", "True", "resolution", "[32, 32]",
                    "gs_input_size", "32", "gs_render_size", "32", "gs_refine_steps", "[5]",
                    "gs_refine_views", "[0, 2, 4, 6]", "gs_refine_uncond", "shared",
                    "save_ply", "True"])
    assert len(written) == 3 and all(os.path.exists(p) for p in written), written
    assert "_gs" in os.path.basename(written[1]) and written[2].endswith(".ply")
    g = load_ply(written[2])
    assert g.shape[0] == 1 and g.shape[2] == 14 and np.isfinite(g).all()
