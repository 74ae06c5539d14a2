"""Port parity: the dormant temporal variants of the T2V UNet against the JAX
package, fp32 on the CPU, with the same seeded weights carried over by
``state_dict_from_flax`` and the same numpy inputs.

- ``rotary_rotate``, ``RelativePositionBias`` (exact), the rotary
  ``TemporalAttentionBlock`` under every mask combination,
  ``TemporalAttentionMultiBlock`` and ``TemporalTransformerAttemask``;
- ``DropPath`` (the overrides exactly, the drop rate within a binomial
  bound);
- the tiny UNet with ``temporal_block`` ``rotary`` and ``attemask`` against
  JAX ``UNetSD_T2VBase`` (forward with the masks, the round trip of its
  ``state_dict()`` through ``convert_unet(strict=True)``, and the gradient
  under ``use_checkpoint``);
- the ``dots`` and ``dots_no_batch`` remat policies against ``full`` in the
  port: the same gradients, and the ops each policy recomputes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_port_helpers import flatten_tree, rel_err, seeded_like, set_torch_threads
from videomv_tpu.inference.pipeline import unet_kwargs_from_cfg as junet_kwargs
from videomv_tpu.models import blocks as jblocks
from videomv_tpu.models import unet_t2v as junet
from videomv_tpu.training.checkpoints import convert_unet
from videomv_tpu_torch.inference.pipeline import unet_kwargs_from_cfg
from videomv_tpu_torch.models import blocks as tblocks
from videomv_tpu_torch.models import unet_t2v as tunet
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

# fp32 on both sides; sums run in other orders (XLA vs ATen)
BLOCK_REL_TOL = 1e-5
UNET_REL_TOL = 1e-4
# per parameter, relative to its largest entry (the slice's training bound)
GRAD_REL_TOL = 5e-3
# remat policies against full remat in the port: the same operations
REMAT_GRAD_TOL = 1e-6

# t2v_infer_tiny.yaml's widths with a narrow context; num_heads 2 gives the
# rotary blocks dim_head 32 at level 0 and 64 at level 1 (rotary_dim 32 <
# dim_head there)
TINY = dict(in_dim=4, dim=64, y_dim=64, context_dim=64, out_dim=4, dim_mult=(1, 2),
            num_heads=2, head_dim=32, num_res_blocks=1, attn_scales=(1.0, 0.5, 0.25),
            dropout=0.0)
B, F, HW = 2, 6, 8


def _port(module, params):
    module.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), module))
    return module.eval()


def _to_port(x):
    """[B, F, H, W, C] → the port's [B, C, F, H, W]."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


# ------------------------------------------------------------------ pieces


@pytest.mark.parametrize("rot,d", [(8, 16), (16, 16), (32, 40)])
def test_rotary_rotate_matches_jax(rot, d):
    x = np.random.default_rng(rot + d).standard_normal((3, 2, 24, d)).astype(np.float32)
    want = np.asarray(jblocks.rotary_rotate(jnp.asarray(x), rot))
    got = tblocks.rotary_rotate(torch.from_numpy(x), rot).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[..., rot:], x[..., rot:])


@pytest.mark.parametrize("n", [24, 40])
def test_relative_position_bias_is_exact(n):
    jmod = jblocks.RelativePositionBias(heads=4, max_distance=32)
    params = seeded_like(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), n)), seed=n)
    want = np.asarray(jmod.apply(params, n))
    tmod = _port(tblocks.RelativePositionBias(heads=4, max_distance=32), params)
    assert set(tmod.state_dict()) == {"relative_attention_bias.weight"}
    with torch.no_grad():
        got = tmod(n).numpy()
    assert got.shape == (4, n, n)
    np.testing.assert_array_equal(got, want)


# (video_mask, focus_present_mask, use_sim_mask, use_image_dataset)
MASKS = {
    "none": (False, False, False, False),
    "video_mask": (True, False, False, False),
    "focus_present": (False, True, False, False),
    "both": (True, True, False, False),
    "sim_mask": (False, False, True, False),
    "all_three": (True, True, True, False),
    "image_dataset": (True, False, False, True),
}


def _masks(rs, b, f):
    vm = rs.random((b, f)) > 0.3
    vm[0] = False  # an emptied row: JAX's uniform softmax, not NaN
    vm[1, :2] = True
    fpm = np.array([True] + [False] * (b - 1))
    return vm, fpm


@pytest.mark.parametrize("case", sorted(MASKS))
@pytest.mark.parametrize("heads,rot", [(2, 32), (1, 16)])
def test_temporal_attention_block_matches_jax(case, heads, rot):
    """C 64: dim_head 32 with rotary_dim 32 (all of it), and 64 with 16."""
    use_vm, use_fpm, sim_mask, image = MASKS[case]
    rs = np.random.default_rng(len(case) + heads)
    b, f, c = 2, 6, 64
    x = rs.standard_normal((b, f, 3, 3, c)).astype(np.float32)
    bias = rs.standard_normal((heads, f, f)).astype(np.float32)
    vm, fpm = _masks(rs, b, f)
    kw = dict(heads=heads, rotary_dim=rot, use_sim_mask=sim_mask, use_image_dataset=image)
    jmod = jblocks.TemporalAttentionBlock(c, **kw)
    jargs = (jnp.asarray(x), jnp.asarray(bias), jnp.asarray(fpm) if use_fpm else None,
             jnp.asarray(vm) if use_vm else None)
    params = seeded_like(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs)), 3)
    want = np.asarray(jax.jit(jmod.apply)(params, *jargs))
    tmod = _port(tblocks.TemporalAttentionBlock(c, **kw), params)
    with torch.no_grad():
        got = tmod(_to_port(x), torch.from_numpy(bias),
                   torch.from_numpy(fpm) if use_fpm else None,
                   torch.from_numpy(vm) if use_vm else None)
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert np.isfinite(got).all()
    if image:
        np.testing.assert_array_equal(got, x)
    assert rel_err(got, want) <= BLOCK_REL_TOL


def test_temporal_attention_multi_block_matches_jax():
    """``temporal_attn_times`` 2, with a bias and a video mask."""
    rs = np.random.default_rng(11)
    x = rs.standard_normal((2, 6, 2, 3, 64)).astype(np.float32)
    bias = rs.standard_normal((2, 6, 6)).astype(np.float32)
    vm, _ = _masks(rs, 2, 6)
    jmod = jblocks.TemporalAttentionMultiBlock(64, heads=2, rotary_dim=32, temporal_attn_times=2)
    jargs = (jnp.asarray(x), jnp.asarray(bias), None, jnp.asarray(vm))
    params = seeded_like(jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs)), 4)
    want = np.asarray(jax.jit(jmod.apply)(params, *jargs))
    tmod = _port(tblocks.TemporalAttentionMultiBlock(64, 2, 32, temporal_attn_times=2), params)
    assert any(k.startswith("att_layers.1.to_qkv") for k in tmod.state_dict())
    with torch.no_grad():
        got = tmod(_to_port(x), torch.from_numpy(bias), None, torch.from_numpy(vm))
    assert rel_err(got.permute(0, 2, 3, 4, 1).numpy(), want) <= BLOCK_REL_TOL


@pytest.mark.parametrize("heads,inner", [(2, 64), (4, 128)])
def test_temporal_transformer_attemask_matches_jax(heads, inner):
    rs = np.random.default_rng(heads + 20)
    x = rs.standard_normal((1, 6, 4, 4, 64)).astype(np.float32)
    jmod = jblocks.TemporalTransformerAttemask(64, heads, inner // heads)
    params = seeded_like(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=9)
    want = np.asarray(jax.jit(jmod.apply)(params, jnp.asarray(x)))
    tmod = _port(tblocks.TemporalTransformerAttemask(64, heads, inner // heads), params)
    with torch.no_grad():
        got = tmod(_to_port(x)).permute(0, 2, 3, 4, 1).numpy()
    assert rel_err(got, want) <= BLOCK_REL_TOL
    # the mask acts: the unmasked transformer on the same weights differs
    plain = _port(tblocks.TemporalTransformer(64, heads, inner // heads), params)
    with torch.no_grad():
        assert rel_err(plain(_to_port(x)).permute(0, 2, 3, 4, 1).numpy(), got) > 1e-3


def test_drop_path_overrides_and_rate():
    dp = tblocks.DropPath(0.3).train()
    x = torch.ones(4000, 3)
    gen = torch.Generator().manual_seed(0)
    out = dp(x, generator=gen)
    rows = out[:, 0]
    assert torch.equal(out, rows[:, None].expand_as(out))  # whole rows, no rescaling
    assert set(rows.unique().tolist()) <= {0.0, 1.0}
    # Binomial(4000, 0.3): sd 29; a 5-sigma bound
    assert abs(int((rows == 0).sum()) - 1200) <= 5 * (4000 * 0.3 * 0.7) ** 0.5
    zero = torch.zeros(4000, dtype=torch.bool)
    keep = torch.zeros(4000, dtype=torch.bool)
    zero[:10], keep[:20] = True, True  # zero wins where both are set
    out = dp(x, zero=zero, keep=keep, generator=gen)[:, 0]
    assert torch.equal(out[:10], torch.zeros(10)) and torch.equal(out[10:20], torch.ones(10))
    # the same generator state gives the same rows
    a = dp(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, dp(x, generator=torch.Generator().manual_seed(5)))
    assert torch.equal(dp.eval()(x), x)
    assert torch.equal(tblocks.DropPath(0.0).train()(x), x)


def test_drop_path_overrides_match_jax():
    """Rows forced by ``zero`` / ``keep`` are the JAX module's exactly."""
    x = np.ones((8, 3), np.float32)
    zero = np.array([1, 1, 0, 0, 0, 0, 0, 0], bool)
    keep = np.array([0, 1, 1, 1, 0, 0, 0, 0], bool)
    jmod = jblocks.DropPath(0.5)
    want = np.asarray(jmod.apply({}, jnp.asarray(x), jnp.asarray(zero), jnp.asarray(keep),
                                 deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)}))
    got = tblocks.DropPath(0.5).train()(torch.from_numpy(x), torch.from_numpy(zero),
                                        torch.from_numpy(keep),
                                        generator=torch.Generator().manual_seed(1)).numpy()
    np.testing.assert_array_equal(got[:4], want[:4])


# ------------------------------------------------------------------ the UNet

VARIANTS = {
    "rotary": dict(temporal_block="rotary", temporal_attn_times=2, use_sim_mask=True),
    "attemask": dict(temporal_block="attemask"),
}


@pytest.fixture(scope="module")
def unets():
    rs = np.random.default_rng(31)
    inputs = {"x": rs.standard_normal((B, 4, F, HW, HW)).astype(np.float32),
              "t": np.array([981, 41], np.int32),
              "y": rs.standard_normal((B, 5, 64)).astype(np.float32),
              "cam": rs.standard_normal((B, F, 16)).astype(np.float32)}
    inputs["vm"], inputs["fpm"] = _masks(rs, B, F)
    out = {}
    for name, kw in VARIANTS.items():
        jm = junet.UNetSD_T2VBase(**TINY, **kw)
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((B, 4, F, HW, HW)), jnp.zeros((B,), jnp.int32),
            y=jnp.zeros((B, 5, 64)), camera_data=jnp.zeros((B, F, 16))))
        params = seeded_like(shapes, seed=41)
        out[name] = (jm, params, _port(tunet.UNetSD_T2VBase(**TINY, **kw), params))
    return inputs, out


def _jax_forward(jm, params, inp, **masks):
    fn = jax.jit(lambda p, x, t, y, cam, vm, fpm: jm.apply(
        p, x, t, y=y, camera_data=cam, video_mask=vm, focus_present_mask=fpm))
    return np.asarray(fn(params, inp["x"], inp["t"], inp["y"], inp["cam"],
                         masks.get("vm"), masks.get("fpm")))


def _port_forward(tm, inp, **masks):
    with torch.no_grad():
        return tm(torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]).long(),
                  y=torch.from_numpy(inp["y"]), camera_data=torch.from_numpy(inp["cam"]),
                  video_mask=None if masks.get("vm") is None else torch.from_numpy(masks["vm"]),
                  focus_present_mask=(None if masks.get("fpm") is None
                                      else torch.from_numpy(masks["fpm"]))).numpy()


@pytest.mark.parametrize("name,masks", [("rotary", ()), ("rotary", ("vm",)),
                                        ("rotary", ("fpm",)), ("rotary", ("vm", "fpm")),
                                        ("attemask", ())])
def test_variant_unet_matches_jax(unets, name, masks):
    inp, models = unets
    jm, params, tm = models[name]
    kw = {m: inp[m] for m in masks}
    want = _jax_forward(jm, params, inp, **kw)
    got = _port_forward(tm, inp, **kw)
    assert got.shape == want.shape == (B, 4, F, HW, HW)
    assert np.abs(want).max() > 1e-2 and np.isfinite(got).all()
    assert rel_err(got, want) <= UNET_REL_TOL


def test_variant_unet_masks_change_the_output(unets):
    inp, models = unets
    plain = _port_forward(models["rotary"][2], inp)
    assert rel_err(_port_forward(models["rotary"][2], inp, vm=inp["vm"]), plain) > 1e-3
    assert rel_err(_port_forward(models["rotary"][2], inp, fpm=inp["fpm"]), plain) > 1e-3


def test_variant_unet_zero_y(unets):
    """``y=None`` conditions on ``zero_y``'s first token, as in JAX."""
    inp, models = unets
    jm, params, tm = models["rotary"]
    zy = np.random.default_rng(3).standard_normal((1, 5, 64)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x, t, cam, zy: jm.apply(
        p, x, t, camera_data=cam, zero_y=zy))(params, inp["x"], inp["t"], inp["cam"], zy))
    with torch.no_grad():
        got = tm(torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]).long(),
                 camera_data=torch.from_numpy(inp["cam"]), zero_y=torch.from_numpy(zy)).numpy()
    assert rel_err(got, want) <= UNET_REL_TOL


def test_use_image_dataset_matches_jax():
    """Every temporal block and temporal conv the identity (f = 1 rows)."""
    kw = dict(TINY, temporal_block="rotary", use_image_dataset=True)
    jm = junet.UNetSD_T2VBase(**kw)
    rs = np.random.default_rng(2)
    x = rs.standard_normal((2, 4, 1, HW, HW)).astype(np.float32)
    t, y = np.array([5, 700], np.int32), rs.standard_normal((2, 5, 64)).astype(np.float32)
    cam = rs.standard_normal((2, 1, 16)).astype(np.float32)
    params = seeded_like(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), y=jnp.asarray(y),
        camera_data=jnp.asarray(cam))), seed=6)
    want = np.asarray(jax.jit(lambda p: jm.apply(p, x, t, y=y, camera_data=cam))(params))
    tm = _port(tunet.UNetSD_T2VBase(**kw), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t).long(), y=torch.from_numpy(y),
                 camera_data=torch.from_numpy(cam)).numpy()
    assert rel_err(got, want) <= UNET_REL_TOL


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_state_dict_round_trips_through_convert_unet(unets, name):
    _, params, tm = unets[1][name]
    torch_sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    if name == "rotary":
        assert "time_rel_pos_bias.relative_attention_bias.weight" in torch_sd
        assert "input_blocks.0.1.att_layers.1.to_qkv.weight" in torch_sd
    back, report = convert_unet(torch_sd, params, strict=True)
    assert not (report["missing"] or report["unexpected"] or report["mismatched"])
    want, got = flatten_tree(params), flatten_tree(back)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_checkpointed_variant_gradient_matches_jax(unets, name):
    """d mean((out - target)²) / d params with per-block recompute on both
    sides (JAX ``nn.remat``, the port's non-reentrant checkpoint), dropout
    off (JAX deterministic, the port in eval mode)."""
    inp, models = unets
    kw = VARIANTS[name]
    jm = junet.UNetSD_T2VBase(**TINY, **kw, use_checkpoint=True)
    params = models[name][1]
    target = np.random.default_rng(8).standard_normal(inp["x"].shape).astype(np.float32)
    masks = dict(vm=inp["vm"], fpm=inp["fpm"]) if name == "rotary" else {}

    def loss(p):
        out = jm.apply(p, inp["x"], inp["t"], y=inp["y"], camera_data=inp["cam"],
                       video_mask=masks.get("vm"), focus_present_mask=masks.get("fpm"))
        return jnp.mean((out - target) ** 2)

    want = flatten_tree(jax.jit(jax.grad(loss))(params)["params"])
    tm = _port(tunet.UNetSD_T2VBase(**TINY, **kw, use_checkpoint=True), params)
    out = tm(torch.from_numpy(inp["x"]), torch.from_numpy(inp["t"]).long(),
             y=torch.from_numpy(inp["y"]), camera_data=torch.from_numpy(inp["cam"]),
             video_mask=torch.from_numpy(inp["vm"]) if masks else None,
             focus_present_mask=torch.from_numpy(inp["fpm"]) if masks else None)
    (out - torch.from_numpy(target)).square().mean().backward()
    grads = state_dict_from_flax(want, tm)
    worst = max(rel_err(p.grad.numpy(), grads[k].numpy()) for k, p in tm.named_parameters())
    assert worst <= GRAD_REL_TOL


# ------------------------------------------------------------ remat policies


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = func.overloadpacket.__name__
        self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _remat_run(policy, block):
    """One training-mode forward and backward of the tiny UNet (dropout 0.1
    acting) under ``policy``; returns the gradients and the ops the backward
    ran (recomputation included)."""
    torch.manual_seed(0)
    tm = tunet.UNetSD_T2VBase(**dict(TINY, dropout=0.1), temporal_block=block,
                              use_checkpoint=True, remat_policy=policy)
    from videomv_tpu_torch.training.checkpoints import init_weights

    init_weights(tm, seed=3, zero_init=False).train()
    rs = np.random.default_rng(4)
    x = torch.from_numpy(rs.standard_normal((B, 4, F, HW, HW)).astype(np.float32))
    y = torch.from_numpy(rs.standard_normal((B, 5, 64)).astype(np.float32))
    cam = torch.from_numpy(rs.standard_normal((B, F, 16)).astype(np.float32))
    torch.manual_seed(1)
    out = tm(x, torch.tensor([10, 900]), y=y, camera_data=cam)
    with _OpCounter() as ops:
        out.square().mean().backward()
    return {k: p.grad.clone() for k, p in tm.named_parameters()}, ops.counts


@pytest.fixture(scope="module")
def remat_runs():
    return {(policy, block): _remat_run(policy, block)
            for policy in ("full", "dots_no_batch", "dots")
            for block in ("transformer", "rotary")}


@pytest.mark.parametrize("policy", ["dots_no_batch", "dots"])
@pytest.mark.parametrize("block", ["transformer", "rotary"])
def test_remat_policy_gradients_match_full(remat_runs, policy, block):
    """The same dropout masks (the RNG state restored) and the same
    gradients as ``full``."""
    want, _ = remat_runs["full", block]
    got, _ = remat_runs[policy, block]
    assert want.keys() == got.keys()
    for k in want:
        assert (got[k] - want[k]).abs().max() <= REMAT_GRAD_TOL * max(
            want[k].abs().max(), 1e-30), k


@pytest.mark.parametrize("block", ["transformer", "rotary"])
def test_remat_policies_recompute_what_jax_recomputes(remat_runs, block):
    """``dots_no_batch`` keeps the 2-D products (no forward ``addmm`` runs
    again in the backward), ``dots`` also the batched ones (fewer ``bmm``);
    both recompute every convolution, as ``full`` does."""
    full, nb, dots = (remat_runs[p, block][1] for p in ("full", "dots_no_batch", "dots"))
    assert full.get("addmm", 0) > 0 and nb.get("addmm", 0) == 0 == dots.get("addmm", 0)
    assert dots.get("bmm", 0) < nb.get("bmm", 0) == full.get("bmm", 0)
    assert full["convolution"] == nb["convolution"] == dots["convolution"] > 0


def test_unknown_variant_options_raise():
    with pytest.raises(ValueError, match="temporal_block"):
        tunet.UNetSD_T2VBase(**TINY, temporal_block="conv")
    with pytest.raises(ValueError, match="remat_policy"):
        tunet.UNetSD_T2VBase(**TINY, remat_policy="offload")


@pytest.mark.parametrize("cfg", [
    {"temporal_block": "attemask"},
    {"use_temporal_transformer": False, "temporal_attn_times": 2, "use_sim_mask": True},
    {"remat_policy": "dots_no_batch", "use_checkpoint": True},
])
def test_unet_kwargs_from_cfg_match_jax(cfg):
    assert unet_kwargs_from_cfg(cfg) == junet_kwargs(cfg)
