"""Port parity: the PyTorch ``UNetSD_I2VGen`` and its adapter blocks against
the JAX package, fp32 on the CPU, with the same seeded weights (carried over
by ``state_dict_from_flax``) and the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import flatten_tree, rel_err, seeded_like, set_torch_threads
from videomv_tpu.models import unet_i2v as junet
from videomv_tpu_torch.models import unet_i2v as tunet
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

UNET_REL_TOL = 1e-4
BLOCK_REL_TOL = 1e-5

# the i2vgen_xl_infer_tiny.yaml widths, with a narrow context
TINY = dict(in_dim=4, dim=64, y_dim=48, context_dim=64, out_dim=4, dim_mult=(1, 2),
            num_heads=2, head_dim=32, num_res_blocks=1, attn_scales=(1.0, 0.5, 0.25),
            dropout=0.0)
B, F_, HW = 1, 6, 8


def _port(module, jax_params):
    module.load_state_dict(state_dict_from_flax(flatten_tree(jax_params["params"]), module))
    return module.eval()


def _inputs(seed=0):
    rs = np.random.default_rng(seed)
    return dict(
        x=rs.standard_normal((B, 4, F_, HW, HW)).astype(np.float32),
        t=np.array([981], np.int32),
        y=rs.standard_normal((B, 7, TINY["context_dim"])).astype(np.float32),
        cam=rs.standard_normal((B, F_, 16)).astype(np.float32),
        local=rs.standard_normal((B, 4, 1, HW, HW)).astype(np.float32),
        image=rs.standard_normal((B, TINY["y_dim"])).astype(np.float32))


@pytest.fixture(scope="module")
def tiny():
    jm = junet.UNetSD_I2VGen(**TINY)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 4, F_, HW, HW)), jnp.zeros((B,), jnp.int32),
        y=jnp.zeros((B, 7, TINY["context_dim"])), camera_data=jnp.zeros((B, F_, 16)),
        local_image=jnp.zeros((B, 4, 1, HW, HW)), image=jnp.zeros((B, TINY["y_dim"]))))
    params = seeded_like(shapes, seed=11)
    apply = jax.jit(lambda p, x, t, y, cam, local, image, fps: jm.apply(
        p, x, t, y=y, camera_data=cam, local_image=local, image=image, fps=fps))
    return jm, params, apply, _port(tunet.UNetSD_I2VGen(**TINY), params)


def _run_port(tm, i, **over):
    kw = dict(y=torch.from_numpy(i["y"]), camera_data=torch.from_numpy(i["cam"]),
              local_image=torch.from_numpy(i["local"]), image=torch.from_numpy(i["image"]))
    kw.update(over)
    with torch.no_grad():
        return tm(torch.from_numpy(i["x"]), torch.from_numpy(i["t"]).long(), **kw).numpy()


def test_forward_matches_jax(tiny):
    _, params, apply, tm = tiny
    i = _inputs()
    want = np.asarray(apply(params, i["x"], i["t"], i["y"], i["cam"], i["local"], i["image"],
                            None))
    got = _run_port(tm, i)
    assert got.shape == want.shape == (B, 4, F_, HW, HW) and got.dtype == np.float32
    assert np.abs(want).max() > 1e-2
    assert rel_err(got, want) <= UNET_REL_TOL


def test_fps_is_always_applied_and_defaults_to_8(tiny):
    _, params, apply, tm = tiny
    i = _inputs(1)
    default = _run_port(tm, i)
    np.testing.assert_array_equal(default, _run_port(tm, i, fps=torch.tensor([8])))
    other = _run_port(tm, i, fps=torch.tensor([24]))
    assert rel_err(other, default) > 1e-3  # seeded (nonzero) fps embedding acts
    want = np.asarray(apply(params, i["x"], i["t"], i["y"], i["cam"], i["local"], i["image"],
                            np.array([24], np.int32)))
    assert rel_err(other, want) <= UNET_REL_TOL


def test_image_conditioning_changes_the_output(tiny):
    """The global tokens (``image``) and the reference latent
    (``local_image``: concat plane and local tokens) both act."""
    tm = tiny[3]
    i = _inputs(2)
    base = _run_port(tm, i)
    assert rel_err(_run_port(tm, i, image=torch.zeros(B, TINY["y_dim"])), base) > 1e-3
    assert rel_err(_run_port(tm, i, local_image=torch.from_numpy(-i["local"])), base) > 1e-3
    # without the image embedding the context loses its 4 global tokens
    assert rel_err(_run_port(tm, i, image=None), base) > 1e-3


def test_concat_plane_is_doubled(tiny):
    """The input conv sees 2 × the adapter's plane (the reference's doubled
    add): feeding the conv the plane once, through a hook, changes the
    output, and feeding it twice the plane reproduces it."""
    tm = tiny[3]
    i = _inputs(3)
    base = _run_port(tm, i)
    seen = {}

    def hook(scale):
        def pre(mod, args):
            h = args[0].clone()
            seen["ratio"] = h[:, 4:]
            h[:, 4:] = h[:, 4:] * scale
            return (h,)
        return pre

    handle = tm.input_blocks[0][0].register_forward_pre_hook(hook(0.5))
    once = _run_port(tm, i)
    handle.remove()
    assert rel_err(once, base) > 1e-3
    # the plane the conv saw is exactly twice the temporal encoder's output
    captured = {}
    h2 = tm.local_temporal_encoder.register_forward_hook(
        lambda m, a, out: captured.__setitem__("xi", out.detach()))
    h3 = tm.input_blocks[0][0].register_forward_pre_hook(hook(1.0))
    _run_port(tm, i)
    h2.remove()
    h3.remove()
    xi = captured["xi"].reshape(B, HW, HW, F_, 4).permute(0, 3, 4, 1, 2).reshape(B * F_, 4, HW, HW)
    np.testing.assert_allclose(seen["ratio"].numpy(), 2.0 * xi.numpy(), rtol=0, atol=0)


def test_local_image_with_more_frames_uses_the_first(tiny):
    tm = tiny[3]
    i = _inputs(4)
    more = np.concatenate([i["local"], 3 * i["local"]], axis=2)
    np.testing.assert_array_equal(_run_port(tm, i, local_image=torch.from_numpy(more)),
                                  _run_port(tm, i))
    np.testing.assert_array_equal(
        _run_port(tm, i, local_image=torch.from_numpy(i["local"][:, :, 0])), _run_port(tm, i))


def test_state_dict_keys_are_checkpoint_keys(tiny):
    tm = tiny[3]
    keys = set(tm.state_dict())
    for k in ("input_blocks.0.0.weight", "local_image_concat.0.weight",
              "local_image_concat.4.bias", "local_temporal_encoder.layers.0.0.norm.weight",
              "local_temporal_encoder.layers.0.0.fn.to_qkv.weight",
              "local_temporal_encoder.layers.0.0.fn.to_out.0.bias",
              "local_temporal_encoder.layers.0.1.net.0.0.weight",
              "local_temporal_encoder.layers.0.1.net.2.bias",
              "local_image_embedding.0.weight", "local_image_embedding.3.weight",
              "local_image_embedding.5.bias", "context_embedding.0.weight",
              "context_embedding.2.bias", "fps_embedding.0.weight", "fps_embedding.2.bias",
              "camera_embedding.2.weight"):
        assert k in keys, k
    assert tm.input_blocks[0][0].weight.shape == (64, 8, 3, 3)  # in_dim + concat_dim
    assert "local_temporal_encoder.layers.0.0.fn.to_qkv.bias" not in keys


def test_fresh_unet_outputs_zero():
    """Zero-init layers (the out conv, the fps and camera MLP tails) make a
    fresh UNet output exactly 0, as in the JAX package."""
    from videomv_tpu_torch.training.checkpoints import init_weights

    tm = init_weights(tunet.UNetSD_I2VGen(**TINY), seed=0).eval()
    assert float(tm.fps_embedding[2].weight.detach().abs().max()) == 0.0
    assert np.abs(_run_port(tm, _inputs(5))).max() == 0.0


@pytest.mark.parametrize("dim,heads,dim_head", [(4, 2, 4), (8, 1, 8), (6, 3, 2)])
def test_prenorm_attention_matches_jax(dim, heads, dim_head):
    """Packed qkv; no output projection when heads == 1 and dim_head == dim."""
    jm = junet.PreNormAttention(dim, heads, dim_head)
    rs = np.random.default_rng(dim)
    x = rs.standard_normal((5, 7, dim)).astype(np.float32)
    params = seeded_like(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 3)
    tm = _port(tunet.PreNormAttention(dim, heads, dim_head), params)
    has_out = any(k.startswith("fn.to_out") for k in tm.state_dict())
    assert has_out == (not (heads == 1 and dim_head == dim))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert rel_err(got, np.asarray(jm.apply(params, jnp.asarray(x)))) <= BLOCK_REL_TOL


def test_transformer_v2_matches_jax():
    jm = junet.TransformerV2(dim=4, heads=2, dim_head=4, mlp_dim=4, depth=2)
    rs = np.random.default_rng(9)
    x = rs.standard_normal((10, 6, 4)).astype(np.float32)
    params = seeded_like(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 4)
    tm = _port(tunet.TransformerV2(dim=4, heads=2, dim_head=4, mlp_dim=4, depth=2), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert rel_err(got, np.asarray(jm.apply(params, jnp.asarray(x)))) <= BLOCK_REL_TOL


@pytest.mark.parametrize("hw,out", [((32, 32), (32, 32)), ((64, 64), (32, 32)),
                                    ((8, 8), (32, 32)), ((48, 40), (32, 32))])
def test_adaptive_avg_pool_matches_jax(hw, out):
    """Identity, block means, and the bilinear resize of the sizes that do
    not divide (up and down)."""
    rs = np.random.default_rng(hw[0])
    x = rs.standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(junet.adaptive_avg_pool_2d(jnp.asarray(x), out))
    got = tunet.adaptive_avg_pool_2d(torch.from_numpy(x).permute(0, 3, 1, 2), out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


def test_middle_block_keeps_its_temporal_transformer():
    """With ``temporal_attention=False`` the JAX I2V UNet still runs a
    temporal transformer in its middle block (unet_i2v.py:249-254), unlike
    the T2V UNet; the port builds the same blocks and gives the same output."""
    kw = dict(TINY, temporal_attention=False, attn_scales=(1.0,))
    jm = junet.UNetSD_I2VGen(**kw)
    i = _inputs(4)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 4, F_, HW, HW)), jnp.zeros((B,), jnp.int32),
        y=jnp.zeros((B, 7, TINY["context_dim"])), camera_data=jnp.zeros((B, F_, 16)),
        local_image=jnp.zeros((B, 4, 1, HW, HW)), image=jnp.zeros((B, TINY["y_dim"]))))
    params = seeded_like(shapes, seed=12)
    tm = _port(tunet.UNetSD_I2VGen(**kw), params)
    assert [type(m).__name__ for m in tm.middle_block] == [
        "ResBlock", "SpatialTransformer", "TemporalTransformer", "ResBlock"]
    want = np.asarray(jm.apply(params, i["x"], i["t"], y=i["y"], camera_data=i["cam"],
                               local_image=i["local"], image=i["image"]))
    assert rel_err(_run_port(tm, i), want) <= UNET_REL_TOL
