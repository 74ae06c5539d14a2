"""Port parity for the VAE, the CLIP text tower and the copied numpy/yaml
modules (tokenizer, config loader, orbit cameras) against the JAX package."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import flatten_tree, rel_err, seeded_like, set_torch_threads
from videomv_tpu.config import load_config as jload_config
from videomv_tpu.config import load_inference_config as jload_inference_config
from videomv_tpu.data import cameras as jcameras
from videomv_tpu.data import tokenizer as jtokenizer
from videomv_tpu.models.autoencoder import AutoencoderKL as JVAE
from videomv_tpu.models.clip import CLIPTextTower as JCLIP
from videomv_tpu_torch.config import load_config, load_inference_config
from videomv_tpu_torch.data import cameras, tokenizer
from videomv_tpu_torch.models import AutoencoderKL, CLIPTextTower
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

# fp32 on both sides; summation order differs (XLA vs ATen convolutions)
REL_TOL = 1e-5
SMALL_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
SMALL_CLIP = dict(width=64, heads=2, layers=3, embed_dim=64)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def small_vae():
    jm = JVAE(**SMALL_VAE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16))))
    params = seeded_like(shapes, seed=11)
    tm = AutoencoderKL(**SMALL_VAE)
    tm.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), tm))
    return jm, params, tm.eval()


def test_vae_decode_matches_jax(small_vae):
    jm, params, tm = small_vae
    z = np.random.default_rng(0).standard_normal((2, 4, 8, 8)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))(params, z))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (2, 3, 16, 16)
    assert rel_err(got, want) <= REL_TOL


def test_vae_encode_matches_jax(small_vae):
    jm, params, tm = small_vae
    x = np.random.default_rng(1).standard_normal((2, 3, 16, 16)).astype(np.float32)
    want = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode_moments))(params, x)
    with torch.no_grad():
        got = tm.encode_moments(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), np.asarray(w)) <= REL_TOL


def test_clip_text_tower_matches_jax():
    jm = JCLIP(**SMALL_CLIP)
    toks = tokenizer.tokenize(["a wooden chair, 3d asset", "Distorted, blurry"])
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(toks)))
    params = seeded_like(shapes, seed=13)
    want_pooled, want_seq = jax.jit(jm.apply)(params, jnp.asarray(toks))
    tm = CLIPTextTower(**SMALL_CLIP)
    tm.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), tm))
    with torch.no_grad():
        pooled, seq = tm.eval()(torch.from_numpy(toks).long())
    assert seq.shape == (2, 77, 64)
    assert rel_err(seq.numpy(), np.asarray(want_seq)) <= REL_TOL
    assert rel_err(pooled.numpy(), np.asarray(want_pooled)) <= REL_TOL


SMALL_VISION = dict(image_size=28, patch_size=14, width=64, heads=2, layers=3, embed_dim=48)


def test_clip_vision_tower_matches_jax():
    from videomv_tpu.models.clip import CLIPVisionTower as JVision
    from videomv_tpu_torch.models import CLIPVisionTower

    jm = JVision(**SMALL_VISION)
    x = np.random.default_rng(4).standard_normal((2, 3, 28, 28)).astype(np.float32)
    params = seeded_like(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))),
                         seed=14)
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    tm = CLIPVisionTower(**SMALL_VISION)
    tm.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), tm))
    assert tm.positional_embedding.shape == (5, 64) and tm.conv1.bias is None
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 48)
    assert rel_err(got, want) <= 1e-4


def test_joint_clip_matches_jax_and_shares_the_text_tower():
    """``OpenCLIPTextVisual``: (image_emb, pooled, seq) as the JAX joint
    module's; ``encode_text`` is the text tower alone."""
    import flax.linen as nn

    from videomv_tpu.models.clip import CLIPVisionTower as JVision
    from videomv_tpu_torch.models import CLIPVisionTower, OpenCLIPTextVisual
    from videomv_tpu_torch.models.clip import VIT_MEAN, VIT_STD
    from videomv_tpu.models import clip as jclip

    class JJoint(nn.Module):  # the JAX joint module with small towers
        def setup(self):
            self.text = JCLIP(**SMALL_CLIP)
            self.visual = JVision(**SMALL_VISION)

        def __call__(self, tokens, images):
            pooled, seq = self.text(tokens)
            return self.visual(images), pooled, seq

    toks = tokenizer.tokenize(["", "a chair"])
    x = np.random.default_rng(5).standard_normal((2, 3, 28, 28)).astype(np.float32)
    jm = JJoint()
    params = seeded_like(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(toks), jnp.asarray(x))), seed=15)
    want = jax.jit(jm.apply)(params, jnp.asarray(toks), jnp.asarray(x))
    tm = OpenCLIPTextVisual(visual=CLIPVisionTower(**SMALL_VISION), **SMALL_CLIP)
    tm.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), tm))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(toks).long(), torch.from_numpy(x))
        pooled, seq = tm.encode_text(torch.from_numpy(toks).long())
        none = tm(torch.from_numpy(toks).long())
    for g, w in zip(got, want):
        assert rel_err(g.numpy(), np.asarray(w)) <= 1e-4
    assert torch.equal(seq, got[2]) and torch.equal(pooled, got[1]) and none[0] is None
    assert torch.equal(tm.encode_image(torch.from_numpy(x)), got[0])
    np.testing.assert_array_equal(VIT_MEAN, jclip.VIT_MEAN)
    np.testing.assert_array_equal(VIT_STD, jclip.VIT_STD)


def test_tokenizer_copy_equals_original():
    texts = ["a wooden chair, 3d asset", "An astronaut riding a horse!", "",
             "word " * 100, "ünïcode &amp; html"]
    np.testing.assert_array_equal(tokenizer.tokenize(texts), jtokenizer.tokenize(texts))
    assert tokenizer.SOT_TOKEN == jtokenizer.SOT_TOKEN and tokenizer.EOT_TOKEN == jtokenizer.EOT_TOKEN


def test_orbit_cameras_equal_original():
    for f, elev, dist in ((24, 15, 2.0), (8, 30, 1.5), (6, 0, 2.0)):
        np.testing.assert_array_equal(cameras.orbit_camera_for_t2v(f, elev, dist),
                                      jcameras.orbit_camera_for_t2v(f, elev, dist))


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))),
                         ids=os.path.basename)
def test_config_loader_equals_original(path, monkeypatch):
    monkeypatch.chdir(REPO)  # linked YAMLs (vldm_cfg) are repo-relative
    opts = ["seed", "5", "UNet.dim", "64"]
    assert load_config(path).to_dict() == jload_config(path).to_dict()
    assert (load_inference_config(path, opts=opts).to_dict()
            == jload_inference_config(path, opts=opts).to_dict())
    with pytest.raises(AssertionError):
        load_inference_config(path, opts=["NoSuchBlock.key", "1"])
