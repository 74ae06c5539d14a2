"""The tiny I2V slice of the port against the JAX package on the CPU, fp32:
``configs/i2vgen_xl_infer_tiny.yaml`` with small towers swapped in, the same
seeded weights (``state_dict_from_flax``) and the same numpy noise and
conditioning through JAX ``_build_sampler_i2v`` and the port's
``sample_i2v``, plain and with the ``shared`` Gaussian-splat refine; the
image conditioning of ``data/images/test_obj.png``; the CLI."""

import logging
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import flatten_tree, rel_err, seeded_like, set_torch_threads
from videomv_tpu.config import load_inference_config as jload_inference_config
from videomv_tpu.inference import i2v as ji2v
from videomv_tpu.models.clip import CLIPTextTower as JText
from videomv_tpu.models.clip import CLIPVisionTower as JVision
from videomv_tpu_torch.config import load_inference_config
from videomv_tpu_torch.data.cameras import orbit_camera_for_t2v
from videomv_tpu_torch.inference import i2v as ti2v
from videomv_tpu_torch.models import CLIPVisionTower, OpenCLIPTextVisual
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "i2vgen_xl_infer_tiny.yaml")
IMAGE = os.path.join(REPO, "data", "images", "test_obj.png")
# fp32 both sides; the guided steps amplify per-forward rounding differences
LATENT_REL_TOL = 1e-3
MIN_PSNR_DB = 40.0

SMALL_TEXT = dict(width=64, heads=2, layers=3, embed_dim=64)
SMALL_VISION = dict(image_size=224, patch_size=14, width=64, heads=2, layers=2, embed_dim=1024)
SMALL_VAE = dict(ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=1)
REFINE_OPTS = ["sampling_dtype", "float32", "resolution", "[32, 32]", "UNet.use_lgm_refine",
               "True", "gs_refine_uncond", "shared", "gs_refine_steps", "[2]",
               "gs_refine_views", "[0, 1, 2, 3]", "gs_input_size", "32", "gs_render_size", "32"]


class JJoint(nn.Module):
    """The JAX joint CLIP with small towers."""

    def setup(self):
        self.text = JText(**SMALL_TEXT)
        self.visual = JVision(**SMALL_VISION)

    def __call__(self, tokens, images):
        return self.visual(images), *self.text(tokens)

    def encode_image(self, images):
        return self.visual(images)


def _small_joint():
    return OpenCLIPTextVisual(visual=CLIPVisionTower(**SMALL_VISION), **SMALL_TEXT)


def _small_lgm(size):
    return dict(input_size=size, down_channels=(32, 64), down_attention=(False, True),
                mid_attention=True, up_channels=(64, 32), up_attention=(True, False),
                splat_size=size, output_size=size, num_views=8, num_input_views=4)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _pipelines(opts, with_lgm=False, seed=70):
    """Both pipelines with small VAE (and LGM) and one set of seeded UNet,
    VAE (and LGM) weights."""
    from videomv_tpu.models.autoencoder import AutoencoderKL as JVAE
    from videomv_tpu_torch.models import AutoencoderKL

    jp = ji2v.I2VPipeline(jload_inference_config(TINY_CFG, opts=opts))
    tp = ti2v.I2VPipeline(load_inference_config(TINY_CFG, opts=opts), device="cpu")
    jp.vae, tp.vae = JVAE(**SMALL_VAE), AutoencoderKL(**SMALL_VAE)
    f, (h, w) = jp.max_frames, jp.latent_hw
    key = jax.random.PRNGKey(0)
    res = jp.resolution[0]
    jp._params = {
        "unet": seeded_like(jax.eval_shape(lambda: jp.unet.init(
            key, jnp.zeros((1, 4, f, h, w)), jnp.zeros((1,), jnp.int32),
            y=jnp.zeros((1, 77, 1024)), camera_data=jnp.zeros((1, f, 16)),
            local_image=jnp.zeros((1, 4, 1, h, w)), image=jnp.zeros((1, 1024)))), seed=seed),
        "vae": seeded_like(jax.eval_shape(lambda: jp.vae.init(
            key, jnp.zeros((1, 3, res, res)))), seed=seed + 1),
    }
    if with_lgm:
        from videomv_tpu.models.lgm import LGM as JLGM
        from videomv_tpu.models.lgm import LGMOptions as JLGMOptions
        from videomv_tpu_torch.models.lgm import LGM, LGMOptions

        jp.lgm, tp.lgm = JLGM(opt=JLGMOptions(**_small_lgm(32))), LGM(LGMOptions(**_small_lgm(32)))
        jp._params["lgm"] = seeded_like(jax.eval_shape(lambda: jp.lgm.init(
            key, jnp.zeros((1, 4, 9, 32, 32)))), seed=seed + 2)
    tp.load_state_dicts(**{name: state_dict_from_flax(flatten_tree(p["params"]), tp.models[name])
                           for name, p in jp._params.items()})
    return jp, tp


def _conditioning(rs, f, h, w):
    return dict(noise=rs.standard_normal((1, 4, f, h, w)).astype(np.float32),
                y=rs.standard_normal((1, 77, 1024)).astype(np.float32),
                zero_y=rs.standard_normal((1, 77, 1024)).astype(np.float32),
                cam=orbit_camera_for_t2v(f),
                local=rs.standard_normal((1, 4, 1, h, w)).astype(np.float32),
                img=rs.standard_normal((1, 1024)).astype(np.float32),
                zero_img=np.zeros((1, 1024), np.float32))


ORDER = ("noise", "y", "zero_y", "cam", "local", "img", "zero_img")


@pytest.fixture(scope="module")
def plain():
    jp, tp = _pipelines(["sampling_dtype", "float32"])
    f, (h, w) = jp.max_frames, jp.latent_hw
    c = _conditioning(np.random.default_rng(8), f, h, w)
    sample = jp._build_sampler_i2v(steps=10, guide_scale=6.0, with_refine=False)
    lat_j = sample(jp._params, *(c[k] for k in ORDER), None, None, None, jax.random.PRNGKey(0))
    frames_j = np.asarray(jp._decode_latents(lat_j))
    lat_t = tp.sample_i2v(*(torch.from_numpy(c[k]) for k in ORDER), steps=10, guide_scale=6.0)
    return dict(jp=jp, tp=tp, c=c, lat_j=np.asarray(lat_j), frames_j=frames_j,
                lat_t=lat_t.numpy(), frames_t=tp._decode_latents(lat_t).numpy())


def test_latents_match_jax(plain):
    lat_t, lat_j = plain["lat_t"], plain["lat_j"]
    assert lat_t.shape == lat_j.shape == (1, 4, 8, 8, 8)
    assert np.isfinite(lat_t).all()
    assert rel_err(lat_t, lat_j) <= LATENT_REL_TOL


def test_decoded_frames_match_jax(plain):
    frames_t, frames_j = plain["frames_t"], plain["frames_j"]
    assert frames_t.dtype == np.uint8 and frames_t.shape == frames_j.shape == (1, 8, 64, 64, 3)
    assert frames_t.std() > 0
    for v in range(frames_t.shape[1]):
        assert _psnr(frames_t[0, v], frames_j[0, v]) >= MIN_PSNR_DB, v


def test_uncond_row_gets_the_zero_image(plain):
    """The CFG rows are [cond; uncond] with ``image = [img_emb; zero_img]``:
    another zero_img changes the sample, so the second row does use it."""
    tp, c = plain["tp"], plain["c"]
    other = dict(c, zero_img=c["img"])
    lat = tp.sample_i2v(*(torch.from_numpy(other[k]) for k in ORDER), steps=10, guide_scale=6.0)
    assert rel_err(lat.numpy(), plain["lat_t"]) > 10 * LATENT_REL_TOL


@pytest.fixture(scope="module")
def refined():
    # The refine's x0 lies behind a splat render whose 1/255 alpha cut and
    # 0.99 clamp make the two packages' rounding differences jump at a few
    # pixels: over seven weight seeds the error read 3e-4 to 2.5e-3 of the
    # (small: max 0.3) refined latents. The seeds are those of the T2V slice's
    # refined test.
    jp, tp = _pipelines(REFINE_OPTS, with_lgm=True, seed=61)
    f, (h, w) = jp.max_frames, jp.latent_hw
    c = _conditioning(np.random.default_rng(17), f, h, w)
    cams = [np.asarray(a) for a in jp._get_cameras(15.0, 2.0)]
    c["cam"] = cams[0]
    sample = jp._build_sampler_i2v(steps=4, guide_scale=6.0, with_refine=True)
    lat_j = sample(jp._params, *(c[k] for k in ORDER), *cams[1:], jax.random.PRNGKey(0))
    frames_j = np.asarray(jp._decode_latents(lat_j))
    args = [torch.from_numpy(np.array(c[k])) for k in ORDER]
    gs = tuple(torch.from_numpy(np.array(a)) for a in cams[1:])
    lat_t = tp.sample_i2v(*args, steps=4, guide_scale=6.0, gs=gs)
    plain_t = tp.sample_i2v(*args, steps=4, guide_scale=6.0)
    return dict(tp=tp, args=args, gs=gs, lat_j=np.asarray(lat_j), frames_j=frames_j,
                lat_t=lat_t.numpy(), frames_t=tp._decode_latents(lat_t).numpy(),
                plain_t=plain_t.numpy())


def test_refined_latents_match_jax(refined):
    lat_t, lat_j = refined["lat_t"], refined["lat_j"]
    assert lat_t.shape == lat_j.shape == (1, 4, 8, 4, 4)
    assert np.isfinite(lat_t).all()
    assert rel_err(lat_t, lat_j) <= LATENT_REL_TOL
    assert rel_err(refined["plain_t"], lat_j) > 100 * LATENT_REL_TOL  # the refine acted


def test_refined_frames_match_jax(refined):
    frames_t, frames_j = refined["frames_t"], refined["frames_j"]
    assert frames_t.dtype == np.uint8 and frames_t.shape == frames_j.shape == (1, 8, 32, 32, 3)
    for v in range(frames_t.shape[1]):
        assert _psnr(frames_t[0, v], frames_j[0, v]) >= MIN_PSNR_DB, v


def test_full_uncond_refine_runs_both_rows(refined):
    """``gs_refine_uncond: full`` sends 2b rows through the refine's UNet
    forward ([cond; uncond] image conditioning): another sample than
    ``shared``, finite."""
    tp = refined["tp"]
    tp.cfg.gs_refine_uncond = "full"
    try:
        lat = tp.sample_i2v(*refined["args"], steps=4, guide_scale=6.0, gs=refined["gs"]).numpy()
    finally:
        tp.cfg.gs_refine_uncond = "shared"
    assert np.isfinite(lat).all()
    assert rel_err(lat, refined["lat_t"]) > LATENT_REL_TOL


def test_white_composite_equals_jax():
    got, want = ti2v.load_white_composite(IMAGE, 64), ji2v.load_white_composite(IMAGE, 64)
    assert got.shape == (64, 64, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.max() == 1.0  # the white background


def test_image_conditioning_matches_jax(plain):
    """``encode_image_clip`` (antialiased bilinear 256² → 224², CLIP mean/std,
    a small visual tower) and ``encode_local_latent`` (2x − 1, posterior mode
    × scale_factor) on the repository's test image."""
    jp, tp = plain["jp"], plain["tp"]
    jp.clip, tp.clip = JJoint(), _small_joint()
    rgb = ti2v.load_white_composite(IMAGE, 256)
    shapes = jax.eval_shape(lambda: jp.clip.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32), jnp.zeros((1, 3, 224, 224))))
    jp._params["clip"] = seeded_like(shapes, seed=90)
    tp.load_state_dicts(clip=state_dict_from_flax(flatten_tree(jp._params["clip"]["params"]),
                                                  tp.clip))
    want = np.asarray(jp.encode_image_clip(rgb))
    got = tp.encode_image_clip(rgb).numpy()
    assert got.shape == want.shape == (1, 1024)
    assert rel_err(got, want) <= 1e-4
    rgb64 = ti2v.load_white_composite(IMAGE, 64)
    want = np.asarray(jp.encode_local_latent(rgb64))
    got = tp.encode_local_latent(rgb64).numpy()
    assert got.shape == want.shape == (1, 4, 1, 8, 8)
    assert rel_err(got, want) <= 1e-4


def _cli(monkeypatch, tmp_path, *opts):
    from videomv_tpu_torch.inference.__main__ import main

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(ti2v, "OpenCLIPTextVisual", _small_joint)
    return main(["--cfg", TINY_CFG, "--debug", "--device", "cpu", "sampling_dtype", "float32",
                 "log_dir", str(tmp_path), "UNet.context_dim", "64", *opts])


def test_cli_writes_the_plain_sample(tmp_path, monkeypatch):
    written = _cli(monkeypatch, tmp_path)
    assert len(written) == 1 and os.path.exists(written[0])
    assert os.path.basename(written[0]).startswith("0000_test_obj_9")


def test_cli_with_refine_writes_plain_and_gs_and_no_ply(tmp_path, monkeypatch):
    import videomv_tpu_torch.inference.pipeline as tpipeline
    from videomv_tpu_torch.models.lgm import LGM, LGMOptions

    monkeypatch.setattr(tpipeline, "LGM", lambda opt: LGM(LGMOptions(**_small_lgm(32))))
    written = _cli(monkeypatch, tmp_path, "UNet.use_lgm_refine", "True", "resolution", "[32, 32]",
                   "gs_input_size", "32", "gs_render_size", "32", "gs_refine_steps", "[5]",
                   "gs_refine_views", "[0, 2, 4, 6]", "gs_refine_uncond", "shared",
                   "save_ply", "True")
    assert len(written) == 2 and all(os.path.exists(p) for p in written), written
    assert "_gs" in os.path.basename(written[1])
    assert not any(p.endswith(".ply") for p in written)


def test_cli_stops_on_an_empty_list(tmp_path, monkeypatch):
    empty = tmp_path / "none.txt"
    empty.write_text("# no images\n")
    with pytest.raises(SystemExit, match="no inputs"):
        _cli(monkeypatch, tmp_path, "test_list_path", str(empty))


def test_generate_from_image_is_deterministic_in_the_seed(monkeypatch):
    monkeypatch.setattr(ti2v, "OpenCLIPTextVisual", _small_joint)
    cfg = load_inference_config(TINY_CFG, opts=["sampling_dtype", "float32",
                                                "UNet.context_dim", "64"])
    pipe = ti2v.I2VPipeline(cfg, device="cpu", seed=3)
    from videomv_tpu_torch.training.checkpoints import init_weights

    for i, m in enumerate(pipe.models.values()):
        init_weights(m, seed=3 + i, zero_init=False, device=pipe.device)
    pipe._finalize()
    a = pipe.generate_from_image(IMAGE, steps=3, seed=5)
    b = pipe.generate_from_image(IMAGE, steps=3, seed=5)
    c = pipe.generate_from_image(IMAGE, steps=3, seed=6)
    assert a["frames"].shape == (8, 64, 64, 3) and a["frames"].dtype == np.uint8
    np.testing.assert_array_equal(a["latents"], b["latents"])
    assert not np.array_equal(a["latents"], c["latents"])
    assert list(pipe._negative_cache) == [cfg.get("negative_prompt", "")]


@pytest.mark.parametrize("value,sampling,outcome", [
    ("bfloat16", "bfloat16", "ok"), ("float32", "float32", "ok"),
    ("bfloat16", "float32", "warns"), ("float16", "bfloat16", "raises")])
def test_params_dtype(value, sampling, outcome, caplog):
    """The port stores weights in the sampling dtype: ``params_dtype`` is
    accepted as bfloat16 / float32, ignored with a warning under fp32
    sampling, refused otherwise (as the JAX pipeline)."""
    cfg = load_inference_config(TINY_CFG, opts=["sampling_dtype", sampling,
                                                "params_dtype", value])
    pipe = ti2v.I2VPipeline(cfg, device="cpu")
    with caplog.at_level(logging.WARNING):
        if outcome == "raises":
            with pytest.raises(ValueError, match="params_dtype"):
                pipe._finalize()
            return
        pipe._finalize()
    assert ("params_dtype bfloat16 ignored" in caplog.text) == (outcome == "warns")
