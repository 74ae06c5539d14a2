"""The host side of the two wgmma kernels (flash attention, GEGLU FFN): which
hand-written kernel serves a shape, the tiling and the TMA tensor maps the
wrappers describe, held against the constraints of the hardware and against
the CUDA sources; and the kernels' plain twins against the JAX package
(Pallas in interpret mode, or its plain reference where the Pallas kernel
does not take the shape) at the ragged sizes of the kernels' tile edges."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videomv_tpu.ops.flash_attention as jfa
import videomv_tpu.ops.fused_ffn as jff
from torch_port_helpers import set_torch_threads
from videomv_tpu_torch.ops import _build
from videomv_tpu_torch.ops import flash_attention as tfa
from videomv_tpu_torch.ops import fused_ffn as tff

set_torch_threads()

# fp32 on both sides: summation order and the gelu's erf (exact vs
# Abramowitz-Stegun, < 1.5e-7) are all that differ
ATOL = RTOL = 2e-5

# the shapes the served and trained paths give the kernels
SERVED_ATTN = [(48, 1024, 5, 64), (48, 256, 10, 64), (24, 1024, 5, 64), (24, 256, 10, 64),
               (1, 1024, 16, 64), (1, 256, 16, 64)]
SERVED_FFN = [(49152, 320, 1280), (12288, 640, 2560), (49152, 512, 2048),
              (24576, 320, 1280), (6144, 640, 2560), (24576, 512, 2048)]


def _source(name):
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        return f.read()


@pytest.mark.parametrize("shape", SERVED_ATTN)
def test_served_attention_shapes_take_the_wgmma_kernel(shape):
    """All but the LGM's 16² call, whose grid would be 32 blocks."""
    want = tfa.VARIANT_MMA if shape == (1, 256, 16, 64) else tfa.VARIANT_WGMMA
    assert tfa.attention_variant(*shape) == want


@pytest.mark.parametrize("shape,variant", [
    ((1, 64, 1, 64), tfa.VARIANT_MMA),     # one 64-key tile: S % 128 != 0
    ((2, 192, 3, 64), tfa.VARIANT_MMA),
    ((1, 128, 1, 64), tfa.VARIANT_MMA),    # one block: too small a grid
    ((64, 128, 1, 64), tfa.VARIANT_WGMMA),  # 64 blocks of one tile each
    ((63, 128, 1, 64), tfa.VARIANT_MMA),
    ((64, 64, 1, 64), tfa.VARIANT_MMA),    # 64 blocks, but shorter than a 128-key tile
    ((1, 1024, 16, 64), tfa.VARIANT_WGMMA),  # 128 blocks
    ((2, 512, 4, 128), tfa.VARIANT_MMA),   # head_dim 128
    ((1, 1024, 1, 128), tfa.VARIANT_MMA),
])
def test_attention_variant_by_shape(shape, variant):
    assert tfa.attention_variant(*shape) == variant
    assert set(tfa.VARIANT_NAMES) == {tfa.VARIANT_MMA, tfa.VARIANT_WGMMA}


@pytest.mark.parametrize("shape", SERVED_ATTN + [(1, 128, 1, 64)])
def test_attention_tensor_map_reads_bshd_in_place(shape):
    b, s, h, d = shape
    tm = tfa.attention_tensor_map(*shape)
    assert tm["dims"] == (d, h, s, b)
    # the strides of a contiguous [B, S, H, D] bf16 tensor, innermost first
    t = torch.empty(shape, dtype=torch.bfloat16)
    assert tm["strides_bytes"] == tuple(2 * t.stride(i) for i in (2, 1, 0))
    assert all(x % 16 == 0 and x < 2 ** 40 for x in tm["strides_bytes"])
    # one box: one head's 128 tokens, one 128-byte swizzle row each
    assert tm["box"] == (64, 1, tfa.WGMMA_KEYS, 1) and tm["box"][0] * 2 == 128
    assert all(bx <= 256 for bx in tm["box"])
    assert s % tm["box"][2] == 0


def test_attention_plan_matches_the_source():
    src = _source("flash_attention.cu")
    for name, value in (("kWgQRows", tfa.WGMMA_Q_ROWS), ("kWgKeys", tfa.WGMMA_KEYS),
                        ("kWgStages", tfa.WGMMA_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    # alignment slack + Q tile + stages of (K, V) tiles of 16 KB + barriers
    assert tfa.WGMMA_SMEM_BYTES == 1024 + 16384 * (1 + 2 * tfa.WGMMA_STAGES) + 1024
    assert tfa.WGMMA_SMEM_BYTES <= tff.MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("t,c,inner", SERVED_FFN)
def test_served_ffn_shapes_take_the_wgmma_kernel(t, c, inner):
    assert tff.ffn_variant(t, c, inner) == tff.VARIANT_WGMMA
    assert tff.ffn_eligible(t, c, inner, torch.bfloat16, True)


@pytest.mark.parametrize("c,variant", [(64, tff.VARIANT_MMA), (96, tff.VARIANT_MMA),
                                       (320, tff.VARIANT_WGMMA), (512, tff.VARIANT_WGMMA),
                                       (640, tff.VARIANT_WGMMA), (1024, tff.VARIANT_MMA)])
def test_ffn_variant_by_width(c, variant):
    for t in (1, 333, 49152):
        assert tff.ffn_variant(t, c, 4 * c) == variant
    src = _source("fused_ffn.cu")
    # the C entry point instantiates the wgmma kernel for exactly these widths
    assert (f"launch_ffn_wgmma<{c}>" in src) == (variant == tff.VARIANT_WGMMA)


@pytest.mark.parametrize("c", tff.WGMMA_WIDTHS)
def test_ffn_plan_fits_the_sm(c):
    plan = tff.ffn_plan(c)
    assert plan["smem_bytes"] <= tff.MAX_DYNAMIC_SMEM
    assert plan["stages"] >= 4 and plan["stage_bytes"] % 1024 == 0
    # a chunk's lin / gate columns and the output columns split evenly between
    # the two consumer warpgroups
    assert 2 * plan["lin_cols"] == plan["chunk"] and plan["w1_stages"] * 64 == c
    assert plan["w2_stages"] * 2 * plan["w2_rows"] == c
    assert plan["w2_rows"] % 8 == 0 and plan["w2_rows"] <= 256   # a legal wgmma N
    # a stage holds the larger of a W1 stage (16 KB) and a W2 stage
    assert plan["stage_bytes"] == max(16384, 2 * plan["w2_rows"] * 128)
    # the accumulators of both products stay in registers: with a producer
    # warpgroup a thread has 168, without it 255
    assert plan["accumulator_registers"] == c // 4 + plan["lin_cols"]
    assert plan["accumulator_registers"] < (168 if plan["producer_warpgroup"] else 255) - 40
    assert plan["threads"] == 256 + 128 * plan["producer_warpgroup"]
    with pytest.raises(ValueError):
        tff.ffn_plan(c + 64)


@pytest.mark.parametrize("t,c,inner", SERVED_FFN + [(1, 320, 1280), (333, 640, 2560)])
def test_ffn_tensor_maps(t, c, inner):
    maps = tff.ffn_tensor_maps(t, c, inner)
    x, w1, w2 = (torch.empty(s, dtype=torch.bfloat16)
                 for s in ((t, c), (2 * inner, c), (c, inner)))
    for name, tensor in (("x", x), ("w1", w1), ("w2", w2)):
        tm = maps[name]
        assert tm["dims"] == tuple(reversed(tensor.shape))
        assert tm["strides_bytes"] == (2 * tensor.stride(0),)
        assert tm["strides_bytes"][0] % 16 == 0
        assert tm["box"][0] * 2 == 128 and tm["box"][1] <= 256   # one swizzle row wide
        assert tm["dims"][0] % tm["box"][0] == 0                  # K blocks of 64 tile C and I
    plan = tff.ffn_plan(c)
    assert maps["x"]["box"][1] == plan["rows"]                    # rows past T arrive as zeros
    # lin rows [j0, j0 + n) and gate rows [I + j0, ...) are whole boxes of W1
    assert inner % plan["chunk"] == 0 and plan["chunk"] % maps["w1"]["box"][1] == 0
    assert (c // 2) % maps["w2"]["box"][1] == 0


# ---- the twins against the JAX package at the kernels' tile edges

@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)
    monkeypatch.setattr(jff, "INTERPRET", True)


@pytest.mark.parametrize("s,d", [(64, 64), (128, 64), (192, 64), (128, 128)])
def test_attention_twin_matches_jax_at_tile_edges(interpret_kernels, s, d):
    """B·H = 1 at one 64-key tile, one 128-key tile and one and a half; the
    Pallas kernel (interpret mode) where the sequence is a multiple of its
    128-lane tile, the JAX package's plain reference otherwise."""
    rs = np.random.default_rng(s + d)
    q, k, v = (rs.standard_normal((1, s, 1, d)).astype(np.float32) for _ in range(3))
    jax_fn = jfa._flash_fwd if s % 128 == 0 else jfa._reference
    want = np.asarray(jax_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tfa.attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_attention_twin_large_logits_match_jax():
    """Logits of the order of 80 and one of 648: the softmax of the twin and
    of the JAX reference subtract the row maximum alike."""
    rs = np.random.default_rng(3)
    q, k, v = (rs.standard_normal((1, 192, 2, 64)).astype(np.float32) for _ in range(3))
    q, k = q * 3.2, k * 3.2
    q[:, 5], k[:, 189] = 9.0, 9.0
    want = np.asarray(jfa._reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tfa.attention_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t", [1, 127, 129, 333])
@pytest.mark.parametrize("c", [64, 128])
def test_ffn_twin_matches_jax_at_tile_edges(t, c):
    """Token counts below, one short of and one past a multiple of the
    kernel's 64-row tile, against the JAX package's plain reference (its
    Pallas kernel pads T to its own 1024-row tile: tests/test_torch_ops.py
    holds the twin against it at T = 700 and 1024)."""
    inner = 4 * c
    rs = np.random.default_rng(t + c)
    x = (rs.standard_normal((t, c)) * 0.5).astype(np.float32)
    w1 = (rs.standard_normal((c, 2 * inner)) * 0.05).astype(np.float32)  # JAX [C, 2I]
    b1 = (rs.standard_normal(2 * inner) * 0.1).astype(np.float32)
    w2 = (rs.standard_normal((inner, c)) * 0.05).astype(np.float32)      # JAX [I, C]
    b2 = (rs.standard_normal(c) * 0.1).astype(np.float32)
    want = np.asarray(jff.geglu_ffn_reference(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2))))
    args = [torch.from_numpy(a) for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    np.testing.assert_allclose(tff.geglu_ffn_reference(*args).numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tff.geglu_ffn(*args).numpy(),
                                  tff.geglu_ffn_reference(*args).numpy())


@pytest.mark.parametrize("t", [129, 4100])
def test_ffn_twin_matches_jax_kernel_ragged(interpret_kernels, t):
    """The Pallas kernel in interpret mode at token counts that are not a
    multiple of either kernel's tile."""
    c, inner = 128, 512
    rs = np.random.default_rng(t)
    x = (rs.standard_normal((t, c)) * 0.5).astype(np.float32)
    w1 = (rs.standard_normal((c, 2 * inner)) * 0.05).astype(np.float32)
    b1 = (rs.standard_normal(2 * inner) * 0.1).astype(np.float32)
    w2 = (rs.standard_normal((inner, c)) * 0.05).astype(np.float32)
    b2 = (rs.standard_normal(c) * 0.1).astype(np.float32)
    want = np.asarray(jff._ffn_fwd(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2))))
    args = [torch.from_numpy(a) for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    np.testing.assert_allclose(tff.geglu_ffn_reference(*args).numpy(), want, rtol=RTOL, atol=ATOL)
