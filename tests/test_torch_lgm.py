"""The port's LGM against the JAX package: a small LGM's forward through
``state_dict_from_flax`` (fp32 on the CPU), the weight bridge's round trip
through ``convert_lgm(strict=True)``, the released key names, and the
attention gate at the call shapes of the shipped 'big' LGM."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videomv_tpu.ops.attention as jattn
from torch_port_helpers import flatten_tree, rel_err, seeded_like, set_torch_threads
from videomv_tpu.models.lgm import LGM as JLGM
from videomv_tpu.models.lgm import LGMOptions as JLGMOptions
from videomv_tpu.training.checkpoints import convert_lgm
from videomv_tpu_torch.models import lgm as tlgm
from videomv_tpu_torch.ops.attention import attention_eligible
from videomv_tpu_torch.training.checkpoints import rename_lgm_key, state_dict_from_flax

set_torch_threads()

# the small LGM of tests/test_refine_fn.py: two levels, attention at the
# second, 4 input views at 32²
SMALL = dict(input_size=32, down_channels=(32, 64), down_attention=(False, True),
             mid_attention=True, up_channels=(64, 32), up_attention=(True, False),
             splat_size=32, output_size=32, num_views=6, num_input_views=4)
# fp32 both sides; ~20 conv/GN/attention layers
REL_TOL = 1e-4


@pytest.fixture(scope="module")
def small():
    jm = JLGM(opt=JLGMOptions(**SMALL))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 4, 9, 32, 32))))
    params = seeded_like(shapes, seed=41)
    tm = tlgm.LGM(tlgm.LGMOptions(**SMALL))
    tm.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), tm))
    return jm, params, tm.eval()


def test_small_lgm_matches_jax(small):
    jm, params, tm = small
    x = np.random.default_rng(5).standard_normal((2, 4, 9, 32, 32)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4 * 32 * 32, 14)
    assert rel_err(got, want) <= REL_TOL
    # the rotation is normalised across all N Gaussians (dim 1)
    np.testing.assert_allclose(np.linalg.norm(got[..., 7:11], axis=1), 1.0, rtol=1e-5)


def test_round_trip_through_convert_lgm_is_exact(small):
    _, params, tm = small
    torch_sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back, report = convert_lgm(torch_sd, params, strict=True)
    assert not (report["missing"] or report["unexpected"] or report["mismatched"])
    for path, leaf in flatten_tree(back).items():
        np.testing.assert_array_equal(leaf, flatten_tree(params)[path], err_msg=path)


def test_released_keys_and_renamer():
    with torch.device("meta"):
        keys = set(tlgm.LGM(tlgm.LGMOptions.big()).state_dict())
    for k in ("unet.conv_in.weight", "unet.down_blocks.0.nets.0.norm1.weight",
              "unet.down_blocks.3.attns.0.attn.qkv.weight",
              "unet.down_blocks.3.attns.0.attn.proj.bias", "unet.down_blocks.0.downsample.weight",
              "unet.mid_block.attns.0.norm.weight", "unet.up_blocks.0.upsample.weight",
              "unet.up_blocks.4.nets.2.shortcut.weight", "unet.conv_out.weight", "conv.weight"):
        assert k in keys, k
    assert "unet.down_blocks.3.attns.0.attn.qkv.bias" not in keys
    assert rename_lgm_key("lgm_big.unet.conv_in.weight") == "unet.conv_in.weight"
    assert rename_lgm_key("lgm_big.lpips_loss.net.0.weight") is None


def test_attention_gate_at_the_big_lgm_call_shapes(monkeypatch):
    """Every MVAttention call of LGM 'big' at 4 × 256² (traced on the meta
    device): the port's gate and the JAX package's agree; 11 calls take the
    kernel (head_dim 64 at 16² and 8², and mid) and 5 stay plain (head_dim
    32 at 32², 4096 tokens)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    calls = []

    def record(q, k, v):
        calls.append(tuple(q.shape))
        return torch.empty_like(q)

    monkeypatch.setattr(tlgm, "dot_product_attention", record)
    for b2 in (1, 2):  # gs_refine_uncond shared / full
        calls.clear()
        with torch.device("meta"):
            out = tlgm.LGM(tlgm.LGMOptions.big())(torch.empty(b2, 4, 9, 256, 256))
        assert tuple(out.shape) == (b2, 4 * 128 * 128, 14)
        kernel = 0
        for shape in calls:
            js = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
            eligible = attention_eligible(shape, shape, torch.bfloat16, True)
            assert jattn._pallas_eligible(js, js) == eligible, shape
            kernel += eligible
        assert (kernel, len(calls) - kernel) == (11, 5)
        assert sorted(set(calls)) == [(b2, 256, 16, 64), (b2, 1024, 16, 64), (b2, 4096, 16, 32)]
