"""The weight bridge: a seeded JAX tree → ``state_dict_from_flax`` → port
module → port ``state_dict()`` → the JAX package's own converters in
``strict=True`` mode must give back the JAX tree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import flatten_tree, seeded_like, set_torch_threads
from videomv_tpu.models.autoencoder import AutoencoderKL as JVAE
from videomv_tpu.models.clip import CLIPTextTower as JCLIP
from videomv_tpu.models.clip import CLIPVisionTower as JVision
from videomv_tpu.models.unet_i2v import UNetSD_I2VGen as JUNetI2V
from videomv_tpu.models.unet_t2v import UNetSD_T2VBase as JUNet
from videomv_tpu.training.checkpoints import convert_open_clip, convert_unet, convert_vae
from videomv_tpu_torch.models import (
    AutoencoderKL,
    CLIPTextTower,
    CLIPVisionTower,
    OpenCLIPTextVisual,
    UNetSD_I2VGen,
    UNetSD_T2VBase,
)
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

UNET = dict(dim=64, y_dim=32, context_dim=32, dim_mult=(1, 2), num_heads=2, head_dim=32,
            num_res_blocks=1, dropout=0.0)


def _unet_shapes():
    x, t = jnp.zeros((1, 4, 2, 8, 8)), jnp.zeros((1,), jnp.int32)
    jm = JUNet(**UNET)
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, t, y=jnp.zeros((1, 5, 32)),
                                          camera_data=jnp.zeros((1, 2, 16))))


def _vae_shapes():
    jm = JVAE(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16))))


def _clip_shapes():
    jm = JCLIP(width=64, heads=2, layers=3, embed_dim=64)
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)))


def _unet_i2v_shapes():
    x, t = jnp.zeros((1, 4, 2, 8, 8)), jnp.zeros((1,), jnp.int32)
    jm = JUNetI2V(**UNET)
    return jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), x, t, y=jnp.zeros((1, 5, 32)), camera_data=jnp.zeros((1, 2, 16)),
        local_image=jnp.zeros((1, 4, 1, 8, 8)), image=jnp.zeros((1, 32))))


VISION = dict(image_size=28, patch_size=14, width=64, heads=2, layers=2, embed_dim=64)


def _joint_clip_shapes():
    """The joint tree as ``OpenCLIPTextVisual`` lays it out: ``text`` and
    ``visual`` subtrees (small towers)."""
    text = _clip_shapes()["params"]
    jv = JVision(**VISION)
    visual = jax.eval_shape(lambda: jv.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 3, 28, 28))))["params"]
    return {"params": {"text": text, "visual": visual}}


def _joint_clip():
    return OpenCLIPTextVisual(visual=CLIPVisionTower(**VISION), width=64, heads=2, layers=3,
                              embed_dim=64)


CASES = {
    "unet": (_unet_shapes, lambda: UNetSD_T2VBase(**UNET), convert_unet, lambda p: p),
    "unet_i2v": (_unet_i2v_shapes, lambda: UNetSD_I2VGen(**UNET), convert_unet, lambda p: p),
    "clip_joint": (_joint_clip_shapes, _joint_clip, convert_open_clip, lambda p: p),
    "vae": (_vae_shapes, lambda: AutoencoderKL(ch=32, ch_mult=(1, 2), num_res_blocks=1),
            convert_vae, lambda p: p),
    # convert_open_clip targets the joint tower, text under 'text'
    "clip": (_clip_shapes, lambda: CLIPTextTower(width=64, heads=2, layers=3, embed_dim=64),
             convert_open_clip, lambda p: {"params": {"text": p["params"]}}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_trip_through_jax_converters_is_exact(name):
    shapes_fn, port_fn, convert, wrap = CASES[name]
    params = seeded_like(shapes_fn(), seed=21)
    port = port_fn()
    port.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), port))
    torch_sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back, report = convert(torch_sd, wrap(params), strict=True)
    assert not (report["missing"] or report["unexpected"] or report["mismatched"])
    want, got = flatten_tree(wrap(params)), flatten_tree(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bridge_raises_on_missing_unexpected_and_mismatched():
    flat = flatten_tree(seeded_like(_unet_shapes(), seed=0)["params"])
    port = UNetSD_T2VBase(**UNET)
    missing = dict(flat)
    missing.pop(next(k for k in flat if k.endswith("kernel")))
    extra = dict(flat, **{"no_such_layer/kernel": np.zeros((2, 2), np.float32)})
    k0 = next(k for k in flat if k.endswith("bias"))
    bad = dict(flat, **{k0: np.zeros(flat[k0].shape[0] + 1, np.float32)})
    for broken in (missing, extra, bad):
        with pytest.raises(ValueError):
            state_dict_from_flax(broken, port)


def test_released_checkpoint_keys_load_directly():
    """A torch state dict with released key names (here: the port's own,
    plus a DDP prefix and an LGM entry) loads with the tolerant loader."""
    from videomv_tpu_torch.training.checkpoints import load_matched, rename_unet_key

    src = UNetSD_T2VBase(**UNET)
    sd = {"module." + k: v for k, v in src.state_dict().items()}
    sd["lgm_big.conv.weight"] = torch.zeros(3)
    dst = UNetSD_T2VBase(**UNET)
    report = load_matched(dst, sd, rename_unet_key)
    assert not report["missing"] and not report["unexpected"] and not report["mismatched"]
    for k, v in dst.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k


def test_joint_clip_keeps_released_key_names():
    """The joint module's keys are the released file's: the text tower at the
    top level, the visual tower under ``visual.``; the text-only rename drops
    the visual tower, the joint rename keeps it."""
    from videomv_tpu_torch.training.checkpoints import (
        load_matched, rename_clip_joint_key, rename_clip_key)

    joint = _joint_clip()
    keys = set(joint.state_dict())
    for k in ("token_embedding.weight", "positional_embedding", "text_projection",
              "transformer.resblocks.0.attn.in_proj_weight", "ln_final.bias",
              "visual.conv1.weight", "visual.class_embedding", "visual.positional_embedding",
              "visual.ln_pre.weight", "visual.transformer.resblocks.1.mlp.c_proj.bias",
              "visual.ln_post.bias", "visual.proj"):
        assert k in keys, k
    assert "visual.conv1.bias" not in keys
    released = {k: torch.full_like(v, 0.5) for k, v in joint.state_dict().items()}
    released["logit_scale"] = torch.tensor(4.6)
    assert rename_clip_key("visual.proj") is None and rename_clip_key("logit_scale") is None
    assert rename_clip_joint_key("visual.proj") == "visual.proj"
    report = load_matched(joint, released, rename_clip_joint_key)
    assert not (report["missing"] or report["unexpected"] or report["mismatched"])
    assert float(joint.visual.proj.detach().mean()) == 0.5
    text = CLIPTextTower(width=64, heads=2, layers=3, embed_dim=64)
    report = load_matched(text, released, rename_clip_key)
    assert not (report["missing"] or report["unexpected"] or report["mismatched"])
