"""Port parity for the two kernel modules: each plain PyTorch twin against
the JAX package's Pallas kernel run in interpret mode on the CPU (as
tests/test_pallas_kernels.py runs them), and the port's dispatch gates
against the JAX gates with the backend substituted (TPU ↔ CUDA)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videomv_tpu.ops.attention as jattn
import videomv_tpu.ops.flash_attention as jfa
import videomv_tpu.ops.fused_ffn as jff
from torch_port_helpers import set_torch_threads
from videomv_tpu_torch import ops
from videomv_tpu_torch.ops.attention import attention_eligible, dot_product_attention
from videomv_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from videomv_tpu_torch.ops.fused_ffn import ffn_eligible, geglu_ffn, geglu_ffn_reference

set_torch_threads()

# fp32 on both sides: the twins and the interpret-mode kernels differ only in
# summation order and the gelu's erf (exact vs Abramowitz-Stegun, < 1.5e-7)
ATOL = RTOL = 2e-5


@pytest.fixture()
def interpret_kernels(monkeypatch):
    monkeypatch.setattr(jfa, "INTERPRET", True)
    monkeypatch.setattr(jff, "INTERPRET", True)


def _qkv(rs, b, sq, sk, h, d):
    return tuple(rs.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 256, 256, 2, 64), (2, 128, 77, 2, 64)])
def test_attention_twin_matches_jax_kernel(interpret_kernels, b, sq, sk, h, d):
    """Self-attention at S=256, D=64, and cross-attention with KV 77 (the
    JAX kernel's pad-to-128 + mask path)."""
    q, k, v = _qkv(np.random.default_rng(sq + sk), b, sq, sk, h, d)
    want = np.asarray(jfa._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_attention_wrapper_on_cpu_runs_the_twin():
    q, k, v = (torch.from_numpy(a) for a in _qkv(np.random.default_rng(1), 1, 256, 256, 2, 64))
    ops.reset_launch_counts()
    np.testing.assert_array_equal(flash_attention(q, k, v).numpy(),
                                  attention_reference(q, k, v).numpy())
    np.testing.assert_array_equal(dot_product_attention(q, k, v).numpy(),
                                  attention_reference(q, k, v).numpy())
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                   "geglu_ffn": 0, "splat_composite": 0,
                                   "splat_composite_bwd": 0, "fused_spatial": 0}
    assert ops.launch_counts_by_shape() == {"flash_attention": {}, "flash_attention_bwd": {},
                                            "geglu_ffn": {}, "fused_spatial": {}}


def test_launch_counts_by_shape_reset_with_the_totals():
    from videomv_tpu_torch.utils import profiling

    ops.reset_launch_counts()
    profiling.count("launch.flash_attention", 3, shape=(1, 256, 2, 64))
    profiling.count("launch.flash_attention_bwd", 1, shape=(1, 256, 2, 64))
    profiling.count("launch.geglu_ffn", 2, shape=(4096, 320, 1280))
    profiling.count("launch.fused_spatial", 5, shape=(48, 1024, 320, 145))
    assert ops.launch_counts_by_shape() == {"flash_attention": {(1, 256, 2, 64): 3},
                                            "flash_attention_bwd": {(1, 256, 2, 64): 1},
                                            "geglu_ffn": {(4096, 320, 1280): 2},
                                            "fused_spatial": {(48, 1024, 320, 145): 5}}
    assert ops.launch_counts() == {"flash_attention": 3, "flash_attention_bwd": 1,
                                   "geglu_ffn": 2, "splat_composite": 0,
                                   "splat_composite_bwd": 0, "fused_spatial": 5}
    ops.reset_launch_counts()
    assert ops.launch_counts_by_shape() == {"flash_attention": {}, "flash_attention_bwd": {},
                                            "geglu_ffn": {}, "fused_spatial": {}}
    assert not any(ops.launch_counts().values())


def test_attention_mask_and_bias_match_jax():
    rs = np.random.default_rng(2)
    q, k, v = _qkv(rs, 2, 16, 16, 2, 32)
    bias = rs.standard_normal((2, 16, 16)).astype(np.float32)
    mask = np.tril(np.ones((16, 16), bool))[None, None]
    want = np.asarray(jattn._reference_attention(q, k, v, bias=bias, mask=mask))
    got = dot_product_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                bias=torch.from_numpy(bias), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t,c,inner", [(1024, 256, 1024), (700, 128, 512)])
def test_ffn_twin_matches_jax_kernel(interpret_kernels, t, c, inner):
    """Includes a token count that is not a tile multiple (700)."""
    rs = np.random.default_rng(t)
    x = (rs.standard_normal((t, c)) * 0.5).astype(np.float32)
    w1 = (rs.standard_normal((c, 2 * inner)) * 0.05).astype(np.float32)  # JAX [C, 2I]
    b1 = (rs.standard_normal(2 * inner) * 0.1).astype(np.float32)
    w2 = (rs.standard_normal((inner, c)) * 0.05).astype(np.float32)  # JAX [I, C]
    b2 = (rs.standard_normal(c) * 0.1).astype(np.float32)
    want = np.asarray(jff._ffn_fwd(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2))))
    # the port takes nn.Linear layouts: w1 [2I, C], w2 [C, I]
    args = [torch.from_numpy(a) for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    np.testing.assert_allclose(geglu_ffn_reference(*args).numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(geglu_ffn(*args).numpy(), geglu_ffn_reference(*args).numpy())


def test_attention_function_backward_matches_jax_grad(monkeypatch):
    """The autograd.Function the CUDA path uses (the forward kernel with its
    log-sum-exp, the backward kernel on the saved q, k, v, o, lse), with the
    two kernels' twins standing in for the launches, against ``jax.grad`` of
    the JAX package's reference: the counterpart of its ``custom_vjp``."""
    import videomv_tpu_torch.ops.flash_attention as tfa

    monkeypatch.setattr(tfa, "_launch", lambda q, k, v, with_lse: tfa.attention_lse_reference(
        q, k, v))
    monkeypatch.setattr(tfa, "_launch_bwd", tfa.attention_backward_reference)
    rs = np.random.default_rng(11)
    q, k, v = _qkv(rs, 2, 64, 64, 2, 32)
    go = rs.standard_normal(q.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jfa._reference(*a) * go), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa._FlashAttention.apply(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(go))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    # on a CPU tensor the public wrapper differentiates the twin directly
    got_cpu = torch.autograd.grad(flash_attention(tq, tk, tv), (tq, tk, tv), torch.from_numpy(go))
    for g, w in zip(got_cpu, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_ffn_function_backward_matches_jax_grad(monkeypatch):
    import videomv_tpu_torch.ops.fused_ffn as tff

    monkeypatch.setattr(tff, "_launch", geglu_ffn_reference)
    rs = np.random.default_rng(12)
    t, c, inner = 64, 32, 128
    x = (rs.standard_normal((t, c)) * 0.5).astype(np.float32)
    w1 = (rs.standard_normal((c, 2 * inner)) * 0.05).astype(np.float32)  # JAX [C, 2I]
    b1 = (rs.standard_normal(2 * inner) * 0.1).astype(np.float32)
    w2 = (rs.standard_normal((inner, c)) * 0.05).astype(np.float32)      # JAX [I, C]
    b2 = (rs.standard_normal(c) * 0.1).astype(np.float32)
    go = rs.standard_normal((t, c)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jff.geglu_ffn_reference(*a) * go),
                    argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    got = torch.autograd.grad(tff._GegluFFN.apply(*args), args, torch.from_numpy(go))
    want = [np.asarray(w) for w in want]
    want[1], want[3] = want[1].T, want[3].T  # to the nn.Linear layouts
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


# One CFG forward of the shipped UNet at 24 views (48 rows): every call shape
# that reaches a gate, with its count per forward. The 31 eligible calls are
# the main path's kernel launches; the rest stay plain on both backends.
ATTN_CALLS = [  # (q_shape, k_shape, calls, eligible)
    ((48, 1024, 5, 64), (48, 1024, 5, 64), 5, True),    # 32² spatial self
    ((48, 256, 10, 64), (48, 256, 10, 64), 5, True),    # 16² spatial self
    ((48, 1024, 5, 64), (48, 77, 5, 64), 5, False),     # 32² cross (77 tokens)
    ((48, 256, 10, 64), (48, 77, 10, 64), 5, False),    # 16² cross
    ((48, 64, 20, 64), (48, 64, 20, 64), 5, False),     # 8² self (64 tokens)
    ((48, 64, 20, 64), (48, 77, 20, 64), 5, False),     # 8² cross
    ((48, 16, 20, 64), (48, 16, 20, 64), 1, False),     # middle self
    ((48, 16, 20, 64), (48, 77, 20, 64), 1, False),     # middle cross
    ((2048, 24, 8, 64), (2048, 24, 8, 64), 2, False),   # init temporal (24 tokens)
    ((2048, 24, 5, 64), (2048, 24, 5, 64), 10, False),  # 32² temporal, attn1+attn2
    ((512, 24, 10, 64), (512, 24, 10, 64), 10, False),  # 16² temporal
    ((128, 24, 20, 64), (128, 24, 20, 64), 10, False),  # 8² temporal
    ((32, 24, 20, 64), (32, 24, 20, 64), 2, False),     # middle temporal
]
FFN_CALLS = [  # (tokens, C, inner, calls, eligible)
    (49152, 320, 1280, 5, True),    # 32² spatial
    (49152, 320, 1280, 5, True),    # 32² temporal
    (49152, 512, 2048, 1, True),    # init temporal, inner 512 != C
    (12288, 640, 2560, 5, True),    # 16² spatial
    (12288, 640, 2560, 5, True),    # 16² temporal
    (3072, 1280, 5120, 10, False),  # 8² spatial + temporal: C = 1280
    (768, 1280, 5120, 2, False),    # middle
    (2048, 320, 1280, 1, False),    # a short sequence: T < 4096
]


def test_gates_agree_with_jax(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    bf16 = torch.bfloat16
    n_attn = n_ffn = 0
    for qs, ks, calls, eligible in ATTN_CALLS:
        jq, jk = jax.ShapeDtypeStruct(qs, jnp.bfloat16), jax.ShapeDtypeStruct(ks, jnp.bfloat16)
        assert jattn._pallas_eligible(jq, jk) == eligible, (qs, ks)
        assert attention_eligible(qs, ks, bf16, True) == eligible, (qs, ks)
        assert not attention_eligible(qs, ks, bf16, False)      # CPU: plain
        assert not attention_eligible(qs, ks, torch.float32, True)  # fp32: plain
        n_attn += calls * eligible
    for t, c, inner, calls, eligible in FFN_CALLS:
        assert jff.ffn_eligible(t, c, inner, jnp.bfloat16) == eligible, (t, c, inner)
        assert ffn_eligible(t, c, inner, bf16, True) == eligible, (t, c, inner)
        assert not ffn_eligible(t, c, inner, bf16, False)
        assert not ffn_eligible(t, c, inner, torch.float32, True)
        assert jff.ffn_eligible(t, c, inner, jnp.float32) is False
        n_ffn += calls * eligible
    assert (n_attn, n_ffn) == (10, 21)
