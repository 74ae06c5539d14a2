"""The fused spatial-transformer block of the port: its plain twin against
the JAX package's oracle, the module composition and the Pallas kernel in
interpret mode; the wrapper on CPU tensors; the backward of its
``autograd.Function``; the gate. fp32, the sizes of
``tests/test_pallas_kernels.py::TestFusedSpatial``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videomv_tpu.ops.fused_spatial as jfs
from torch_port_helpers import flatten_tree, seeded_like, set_torch_threads
from videomv_tpu.models.blocks import SpatialTransformer as JSpatialTransformer
from videomv_tpu_torch import ops
from videomv_tpu_torch.models.blocks import SpatialTransformer
from videomv_tpu_torch.ops import fused_spatial as tfs
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

R, HH, WW, C, HEADS, L, CC = 2, 16, 32, 128, 2, 7, 96
S = HH * WW


@pytest.fixture(scope="module")
def block():
    """One set of seeded weights in both packages, and numpy inputs."""
    jmod = JSpatialTransformer(in_channels=C, n_heads=HEADS, d_head=64, depth=1, context_dim=CC,
                               dropout=0.0)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros((R, HH, WW, C)), jnp.zeros((R, L, CC))))
    jparams = seeded_like(shapes, seed=5)
    tmod = SpatialTransformer(C, HEADS, 64, depth=1, context_dim=CC).eval()
    tmod.load_state_dict(state_dict_from_flax(flatten_tree(jparams["params"]), tmod))
    rs = np.random.default_rng(5)
    x = (0.5 * rs.standard_normal((R, S, C))).astype(np.float32)
    ctx = (0.5 * rs.standard_normal((R, L, CC))).astype(np.float32)
    return jmod, jparams, tmod, x, ctx


def _twin(tmod, x, ctx):
    with torch.no_grad():
        return tfs.spatial_block_reference(torch.from_numpy(x), torch.from_numpy(ctx),
                                           tfs.spatial_params(tmod), HEADS).numpy()


def test_twin_matches_jax_reference(block):
    jmod, jparams, tmod, x, ctx = block
    want = np.asarray(jfs.spatial_block_reference(jnp.asarray(x), jnp.asarray(ctx),
                                                  jparams["params"], HEADS))
    np.testing.assert_allclose(_twin(tmod, x, ctx), want, rtol=1e-5, atol=1e-5)


def test_twin_matches_the_ports_module(block):
    """The twin equals the module composition (NCHW around it)."""
    _, _, tmod, x, ctx = block
    x4 = torch.from_numpy(x).reshape(R, HH, WW, C).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = tmod(x4, torch.from_numpy(ctx)).permute(0, 2, 3, 1).reshape(R, S, C).numpy()
    np.testing.assert_allclose(_twin(tmod, x, ctx), want, rtol=1e-5, atol=1e-5)


def test_twin_matches_jax_kernel_in_interpret_mode(block, monkeypatch):
    """The Pallas kernel multiplies in bf16: the JAX test's own tolerance."""
    _, jparams, tmod, x, ctx = block
    monkeypatch.setattr(jfs, "INTERPRET", True)
    want = np.asarray(jfs._fst_impl(jnp.asarray(x), jnp.asarray(ctx), jparams["params"], HEADS),
                      np.float32)
    np.testing.assert_allclose(_twin(tmod, x, ctx), want, rtol=2e-2, atol=3e-2)


def test_twin_computes_in_fp32_whatever_the_dtype(block):
    """bf16 inputs and weights are upcast: the result is the fp32 result of
    the rounded inputs, cast to bf16."""
    _, _, tmod, x, ctx = block
    p16 = {k: v.detach().to(torch.bfloat16) for k, v in tfs.spatial_params(tmod).items()}
    x16, c16 = torch.from_numpy(x).bfloat16(), torch.from_numpy(ctx).bfloat16()
    got = tfs.spatial_block_reference(x16, c16, p16, HEADS)
    want = tfs.spatial_block_reference(x16.float(), c16.float(),
                                       {k: v.float() for k, v in p16.items()}, HEADS)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


def test_wrapper_on_cpu_runs_the_twin(block):
    _, _, tmod, x, ctx = block
    ops.reset_launch_counts()
    with torch.no_grad():
        got = tfs.fused_spatial_transformer(torch.from_numpy(x), torch.from_numpy(ctx),
                                            tfs.spatial_params(tmod), HEADS).numpy()
    np.testing.assert_array_equal(got, _twin(tmod, x, ctx))
    assert ops.launch_counts()["fused_spatial"] == 0
    assert ops.launch_counts_by_shape()["fused_spatial"] == {}


def test_backward_of_the_function_is_the_twins(block, monkeypatch):
    """The ``autograd.Function`` (its forward stood in for by the twin, the
    kernel needing a card): the backward recomputes through the twin on the
    saved inputs, so its gradients equal autograd of the twin."""
    _, _, tmod, x, ctx = block
    monkeypatch.setattr(tfs, "_launch", lambda x, c, p, h: tfs.spatial_block_reference(
        x.detach(), c.detach(), {k: v.detach() for k, v in p.items()}, h))
    rs = np.random.default_rng(6)
    go = torch.from_numpy(rs.standard_normal((R, S, C)).astype(np.float32))

    def grads(fn):
        xs = torch.from_numpy(x).requires_grad_()
        cs = torch.from_numpy(ctx).requires_grad_()
        ps = {k: v.detach().clone().requires_grad_() for k, v in tfs.spatial_params(tmod).items()}
        out = fn(xs, cs, ps)
        assert out.requires_grad
        return torch.autograd.grad(out, [xs, cs, *ps.values()], go)

    got = grads(lambda xs, cs, ps: tfs._FusedSpatial.apply(
        HEADS, xs, cs, *[ps[n] for n in tfs.PARAM_NAMES]))
    want = grads(lambda xs, cs, ps: tfs.spatial_block_reference(xs, cs, ps, HEADS))
    assert len(got) == 2 + len(tfs.PARAM_NAMES)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)


def test_backward_matches_jax_vjp(block):
    """d/dx and d/dctx of the twin against the JAX custom_vjp's rule (the VJP
    of the JAX oracle)."""
    _, jparams, tmod, x, ctx = block
    rs = np.random.default_rng(7)
    go = rs.standard_normal((R, S, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jfs.spatial_block_reference(a, b, jparams["params"], HEADS),
                     jnp.asarray(x), jnp.asarray(ctx))
    want = vjp(jnp.asarray(go))
    xs, cs = torch.from_numpy(x).requires_grad_(), torch.from_numpy(ctx).requires_grad_()
    out = tfs.spatial_block_reference(xs, cs, tfs.spatial_params(tmod), HEADS)
    got = torch.autograd.grad(out, [xs, cs], torch.from_numpy(go))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


BF16 = torch.bfloat16
GATE_CASES = {
    # name: (env flag, (s, c, inner, heads, cc, dtype, is_cuda), eligible)
    "the served shape": ("1", (1024, 320, 320, 5, 1024, BF16, True), True),
    "no env flag": (None, (1024, 320, 320, 5, 1024, BF16, True), False),
    "a CPU tensor": ("1", (1024, 320, 320, 5, 1024, BF16, False), False),
    "fp32": ("1", (1024, 320, 320, 5, 1024, torch.float32, True), False),
    "S = 256": ("1", (256, 320, 320, 5, 1024, BF16, True), False),
    "C = 640": ("1", (1024, 640, 640, 10, 1024, BF16, True), False),
    "inner != C": ("1", (1024, 320, 512, 8, 1024, BF16, True), False),
    "head_dim 32": ("1", (1024, 320, 320, 10, 1024, BF16, True), False),
    "a 768-wide context": ("1", (1024, 320, 320, 5, 768, BF16, True), False),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate(case, monkeypatch):
    flag, args, want = GATE_CASES[case]
    if flag is None:
        monkeypatch.delenv(tfs.ENV_FLAG, raising=False)
    else:
        monkeypatch.setenv(tfs.ENV_FLAG, flag)
    assert tfs.spatial_fused_eligible(*args) is want


def test_gate_matches_jax_shape_rule(monkeypatch):
    """With the flag set and the backend test taken out, the port's gate is
    the JAX package's shape rule held to the shape the kernel takes (C = 320,
    a 1024-wide context): it agrees with JAX at C = 320 and refuses C = 128
    and 384, which JAX admits."""
    monkeypatch.setenv(tfs.ENV_FLAG, "1")
    monkeypatch.setattr(jfs.jax, "default_backend", lambda: "tpu")
    for s, c, inner, heads in [(1024, 320, 320, 5), (512, 128, 128, 2), (256, 320, 320, 5),
                               (1024, 640, 640, 10), (1024, 384, 384, 6), (1024, 320, 512, 8)]:
        jax_rule = jfs.spatial_fused_eligible(s, c, inner, heads)
        assert tfs.spatial_fused_eligible(s, c, inner, heads, 1024, BF16, True) == \
            (jax_rule and c == 320), (s, c, inner, heads)
        assert not tfs.spatial_fused_eligible(s, c, inner, heads, 768, BF16, True)
    for s, c, inner, heads in [(512, 128, 128, 2), (1024, 384, 384, 6)]:
        assert jfs.spatial_fused_eligible(s, c, inner, heads)
        assert not tfs.spatial_fused_eligible(s, c, inner, heads, 1024, BF16, True)


def test_module_takes_the_plain_path_on_cpu_with_the_flag_set(block, monkeypatch):
    """The flag alone does not reach the kernel: a CPU tensor (and fp32)
    stays on the module composition, and nothing is launched."""
    _, _, tmod, x, ctx = block
    x4 = torch.from_numpy(x).reshape(R, HH, WW, C).permute(0, 3, 1, 2)
    with torch.no_grad():
        want = tmod(x4, torch.from_numpy(ctx))
        monkeypatch.setenv(tfs.ENV_FLAG, "1")
        ops.reset_launch_counts()
        got = tmod(x4, torch.from_numpy(ctx))
    assert torch.equal(got, want)
    assert ops.launch_counts()["fused_spatial"] == 0


def test_cuda_checks_raise_on_a_cpu_call_of_the_launcher(block):
    """The launcher takes CUDA tensors only: it raises, it never falls back."""
    _, _, tmod, x, ctx = block
    with pytest.raises(ValueError, match="must be on"):
        tfs._launch(torch.from_numpy(x).bfloat16(), torch.from_numpy(ctx).bfloat16(),
                    tfs.spatial_params(tmod), HEADS)
