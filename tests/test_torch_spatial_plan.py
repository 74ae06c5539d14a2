"""The host side of kernel 5 (csrc/fused_spatial.cu): which shapes its gate
sends to the kernel and which to the module path, the tiling and the TMA tensor maps the
wrapper describes, held against the limits of the hardware and against the
CUDA source; the fp32 twin against the JAX package at the new kernel's tile
edges (128-key K/V tiles, ragged contexts); and the fp32 copies of the norm
vectors that the module keeps for the kernel."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videomv_tpu.ops.fused_spatial as jfs
from torch_port_helpers import flatten_tree, seeded_like, set_torch_threads
from videomv_tpu.models.blocks import SpatialTransformer as JSpatialTransformer
from videomv_tpu_torch.models.blocks import SpatialTransformer
from videomv_tpu_torch.ops import _build
from videomv_tpu_torch.ops import fused_spatial as tfs
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

# (R, S, C, L, Cc, heads, inner) of the served calls: the I2V context (145
# tokens) at 48 and 24 rows, the T2V context (77 tokens)
SERVED = [(48, 1024, 320, 145, 1024, 5, 1280), (24, 1024, 320, 145, 1024, 5, 1280),
          (48, 1024, 320, 77, 1024, 5, 1280), (24, 1024, 320, 77, 1024, 5, 1280)]
# other shapes: the CPU tests' size, one 64-token tile, the widest C the JAX
# rule admits, a wider context, an odd head count
OTHER_SHAPES = [(2, 512, 128, 7, 96, 2, 512), (3, 64, 64, 64, 32, 1, 256),
                   (1, 1024, 384, 145, 1024, 6, 1536), (2, 576, 320, 1, 1536, 5, 1280),
                   (2, 1024, 192, 129, 64, 3, 768)]


def _source():
    with open(os.path.join(_build.CSRC_DIR, "fused_spatial.cu")) as f:
        return f.read()


def _gate(shape):
    """The gate on a bf16 CUDA call of ``shape``, as the module asks it."""
    r, s, c, kv_len, cc, heads, inner_ff = shape
    return tfs.spatial_fused_eligible(s, c, heads * 64, heads, cc, torch.bfloat16, True)


@pytest.mark.parametrize("shape", SERVED)
def test_served_shapes_take_the_wgmma_kernel(shape, monkeypatch):
    monkeypatch.setenv(tfs.ENV_FLAG, "1")
    assert _gate(shape)
    monkeypatch.delenv(tfs.ENV_FLAG)
    assert not _gate(shape)


@pytest.mark.parametrize("shape", OTHER_SHAPES)
def test_other_shapes_take_the_module_path(shape, monkeypatch):
    """With the switch on, the gate refuses them: the module composes the
    block from kernels 1, 2 and PyTorch ops."""
    monkeypatch.setenv(tfs.ENV_FLAG, "1")
    assert not _gate(shape)


def test_spatial_plan_fits_the_sm():
    plan = tfs.spatial_plan()
    for key in ("block_smem_bytes", "front_smem_bytes", "ctx_smem_bytes"):
        assert plan[key] <= tfs.MAX_DYNAMIC_SMEM, key
    # phase C: alignment slack + residual + operand + ring + g tiles + barriers
    assert plan["block_smem_bytes"] == (1024 + plan["residual_bytes"] + plan["operand_bytes"]
                                        + plan["stages"] * plan["stage_bytes"] + plan["g_bytes"]
                                        + plan["barrier_bytes"])
    # every tile a wgmma or TMA touches starts on a 1024-byte boundary
    for key in ("residual_bytes", "operand_bytes", "stage_bytes", "g_bytes", "kv_stage_bytes"):
        assert plan[key] % 1024 == 0, key
    # the residual rows are padded by 8 floats: the epilogues' float2 stores of
    # 8 rows x 4 columns fall on distinct banks
    assert plan["residual_bytes"] == plan["rows"] * (320 + 8) * 4 and (320 + 8) % 32 == 8
    # an attention's K/V stages alias the weight ring and the g tiles, and the
    # split head's (m, l, O) of 128 threads fit the ring
    assert plan["kv_stages"] * plan["kv_stage_bytes"] <= (plan["stages"] * plan["stage_bytes"]
                                                          + plan["g_bytes"])
    assert plan["kv_stages"] >= 2 and 36 * 128 * 4 <= plan["stages"] * plan["stage_bytes"]
    # two warpgroups split the 320 output columns into two m64n80 wgmmas each
    assert plan["warpgroups"] * plan["columns_per_warpgroup"] == 320
    assert plan["columns_per_warpgroup"] == 2 * plan["wgmma_n"]
    assert plan["wgmma_n"] % 8 == 0 and plan["wgmma_n"] <= 256
    assert plan["stage_bytes"] == plan["warpgroups"] * plan["wgmma_n"] * 128
    # a W1 stage of the feed-forward (each warpgroup's lin and gate rows of a
    # 64-column chunk) fits a stage
    assert 2 * 2 * plan["ffn_lin_cols"] * 128 <= plan["stage_bytes"]
    assert 2 * plan["ffn_lin_cols"] == plan["ffn_chunk"]
    # two warpgroups and no producer: a thread may hold 255 registers
    assert plan["threads"] == 128 * plan["warpgroups"]
    assert plan["accumulator_registers"] < plan["register_cap"] - 80


@pytest.mark.parametrize("c,cc", [(640, 1024), (384, 1024), (320, 768)])
def test_spatial_plan_refuses_other_shapes(c, cc):
    with pytest.raises(ValueError):
        tfs.spatial_plan(c, cc)


def test_spatial_plan_matches_the_source():
    src = _source()
    plan = tfs.spatial_plan()
    for name, value in (("kSpC", 320), ("kSpThreads", plan["threads"]), ("kSpN", plan["wgmma_n"]),
                        ("kSpStages", plan["stages"]), ("kSpKeys", plan["keys"]),
                        ("kSpKvStages", plan["kv_stages"]), ("kSpBarBytes", plan["barrier_bytes"]),
                        ("kSpLG", plan["ffn_lin_cols"]), ("kSpCc", tfs.WGMMA_CC)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    # the C entry point checks the same shape rule the wrapper applies
    assert "if (C != kSpC || Cc != kSpCc) return int(cudaErrorInvalidValue);" in src
    for kernel in ("spatial_ctx_kv_wgmma_kernel", "spatial_front_kv_wgmma_kernel",
                   "spatial_block_wgmma_kernel"):
        assert f"{kernel}(" in src, kernel


@pytest.mark.parametrize("r", [1, 24, 48])
@pytest.mark.parametrize("kv_len", [1, 77, 145])
def test_spatial_tensor_maps(r, kv_len):
    s, c, cc, inner = 1024, 320, 1024, 1280
    maps = tfs.spatial_tensor_maps(r, s, c, kv_len, cc, inner)
    tensors = {"ctx": torch.empty((r * kv_len, cc)), "w1": torch.empty((2 * inner, c)),
               "w2": torch.empty((c, inner)), "wk2": torch.empty((c, cc)),
               "wv2": torch.empty((c, cc))}
    for n in ("win", "wq1", "wk1", "wv1", "wo1", "wq2", "wo2", "wpo"):
        tensors[n] = torch.empty((c, c))
    for n, t in tensors.items():   # 2-D: [rows, columns], innermost first
        tm = maps[n]
        assert tm["dims"] == tuple(reversed(t.shape)), n
        assert tm["strides_bytes"] == (2 * t.stride(0),), n
        assert tm["dims"][0] % 64 == 0, n   # whole K blocks of 64
    # the weights' output rows come in whole boxes: 80 per wgmma, 32 lin / gate
    for n in tensors:
        if n != "ctx":
            assert maps[n]["dims"][1] % maps[n]["box"][1] == 0, n
    assert maps["w1"]["box"] == (64, 32) and inner % 64 == 0
    # K/V of both attentions read in place as [R, tokens, heads, 64]
    for n, tokens in (("k1", s), ("v1", s), ("k2", kv_len), ("v2", kv_len)):
        tm = maps[n]
        t = torch.empty((r, tokens, c // 64, 64))
        assert tm["dims"] == (64, c // 64, tokens, r)
        assert tm["strides_bytes"] == tuple(2 * t.stride(i) for i in (2, 1, 0))
        assert tm["box"] == (64, 1, 128, 1) and tm["box"][2] == tfs.spatial_plan()["keys"]
        # ceil(tokens / 128) boxes cover a row; keys past the end arrive as
        # zeros and are masked, and never reach the next row (the row is a
        # dimension of its own)
        assert -(-tokens // 128) * 128 >= tokens
    for tm in maps.values():
        assert tm["box"][0] * 2 == 128                     # one 128-byte swizzle row
        assert all(1 <= b <= 256 for b in tm["box"])
        assert all(x % 16 == 0 and x < 2 ** 40 for x in tm["strides_bytes"])
        assert all(1 <= d < 2 ** 32 for d in tm["dims"])


# ---- the fp32 twin against the JAX package at the new kernel's tile edges

R, C, HEADS, CC = 1, 128, 2, 96


@pytest.fixture(scope="module")
def block():
    jmod = JSpatialTransformer(in_channels=C, n_heads=HEADS, d_head=64, depth=1, context_dim=CC,
                               dropout=0.0)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((R, 16, 32, C)), jnp.zeros((R, 7, CC))))
    jparams = seeded_like(shapes, seed=11)
    tmod = SpatialTransformer(C, HEADS, 64, depth=1, context_dim=CC).eval()
    tmod.load_state_dict(state_dict_from_flax(flatten_tree(jparams["params"]), tmod))
    return jparams, tmod


def _inputs(s, kv_len):
    rs = np.random.default_rng(s + kv_len)
    x = (0.5 * rs.standard_normal((R, s, C))).astype(np.float32)
    ctx = (0.5 * rs.standard_normal((R, kv_len, CC))).astype(np.float32)
    return x, ctx


@pytest.mark.parametrize("s", [512, 1024])
@pytest.mark.parametrize("kv_len", [1, 77, 128, 129, 145])
def test_twin_matches_jax_reference_at_tile_edges(block, s, kv_len):
    """Self-attention over 4 and 8 tiles of 128 keys; contexts of one key,
    under one tile, one tile exactly, one key past it, and the I2V context."""
    jparams, tmod = block
    x, ctx = _inputs(s, kv_len)
    want = np.asarray(jfs.spatial_block_reference(jnp.asarray(x), jnp.asarray(ctx),
                                                  jparams["params"], HEADS))
    with torch.no_grad():
        got = tfs.spatial_block_reference(torch.from_numpy(x), torch.from_numpy(ctx),
                                          tfs.kernel_params(tmod), HEADS).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_len", [77, 129])
def test_twin_matches_jax_kernel_in_interpret_mode_ragged(block, monkeypatch, kv_len):
    """The Pallas kernel (interpret mode; it multiplies in bf16: the JAX
    test's own tolerance) over a context that ends inside a 128-key tile and
    one key past a whole tile."""
    jparams, tmod = block
    monkeypatch.setattr(jfs, "INTERPRET", True)
    x, ctx = _inputs(512, kv_len)
    want = np.asarray(jfs._fst_impl(jnp.asarray(x), jnp.asarray(ctx), jparams["params"], HEADS),
                      np.float32)
    with torch.no_grad():
        got = tfs.spatial_block_reference(torch.from_numpy(x), torch.from_numpy(ctx),
                                          tfs.kernel_params(tmod), HEADS).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=3e-2)


# ---- the fp32 norm vectors the module keeps for the kernel

def _bf16_block():
    torch.manual_seed(0)
    mod = SpatialTransformer(C, HEADS, 64, depth=1, context_dim=CC).eval()
    for prm in mod.parameters():
        torch.nn.init.normal_(prm, std=0.5)
    return mod.to(torch.bfloat16)


def test_kernel_params_equal_a_fresh_cast_and_are_kept():
    mod = _bf16_block()
    got = tfs.kernel_params(mod)
    want = tfs.spatial_params(mod, vector_dtype=torch.float32)
    assert set(got) == set(tfs.PARAM_NAMES)
    for n in tfs.PARAM_NAMES:
        assert got[n].dtype == want[n].dtype and torch.equal(got[n], want[n]), n
        if n.startswith("w"):   # the matrices are the module's own tensors
            assert got[n] is tfs.spatial_params(mod)[n], n
    again = tfs.kernel_params(mod)
    for n in tfs.PARAM_NAMES:   # no new cast while nothing changed
        assert again[n] is got[n], n


def test_kernel_params_follow_load_state_dict_and_to():
    mod = _bf16_block()
    before = {k: v.clone() for k, v in tfs.kernel_params(mod).items()}
    sd = {k: v * 2 for k, v in mod.state_dict().items()}
    mod.load_state_dict(sd)  # copies in place: same storage, new version
    after = tfs.kernel_params(mod)
    for n in tfs.PARAM_NAMES:
        assert torch.equal(after[n], tfs.spatial_params(mod, vector_dtype=torch.float32)[n]), n
        assert torch.equal(after[n].float(), before[n].float() * 2), n
    with torch.no_grad():
        mod.norm.weight.add_(1.0)  # an in-place update of one vector
    assert torch.equal(tfs.kernel_params(mod)["gn_s"], mod.norm.weight.float())
    mod.to(torch.float32)  # new storage
    moved = tfs.kernel_params(mod)
    assert all(moved[n].dtype == torch.float32 for n in tfs.PARAM_NAMES)
    assert torch.equal(moved["ln2_b"], mod.transformer_blocks[0].norm2.bias)
