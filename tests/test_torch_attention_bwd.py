"""The attention backward's plain twins and the fp32 logits of the port's
plain attention sites, against the JAX package on the CPU.

``attention_lse_reference`` and ``attention_backward_reference`` are the
plain versions of the CUDA forward (with its log-sum-exp) and backward
kernels; here they are held to ``jax.nn.logsumexp`` of the JAX reference's
fp32 logits and to ``jax.vjp`` of ``videomv_tpu.ops.flash_attention._reference``
(the JAX package's ``_bwd``): in fp32 to 1e-5, in bf16 within twice JAX's own
bf16 error plus 2e-3. ``_FlashAttention`` is driven with both twins standing in
for the launches. The three plain sites that form attention logits
(``attention_reference``, the I2V ``_PackedAttention``, the VAE's
``AttnBlock``) keep them in fp32 as JAX's ``preferred_element_type`` does:
in bf16 each is no farther from fp32 than the JAX counterpart's own bf16
result plus one rounding of the output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videomv_tpu.ops.attention as jattn
import videomv_tpu.ops.flash_attention as jfa
from torch_port_helpers import flatten_tree, rel_err, seeded_like, set_torch_threads
from videomv_tpu.models import autoencoder as jvae
from videomv_tpu.models import unet_i2v as junet
from videomv_tpu_torch.models import autoencoder as tvae
from videomv_tpu_torch.models import unet_i2v as tunet
from videomv_tpu_torch.ops import flash_attention as tfa
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

# fp32 on both sides: the same function in another summation order
FP32_TOL = 1e-5
# bf16: a gradient's error against fp32 (max |d| / max |ref|) may not exceed
# twice JAX's own bf16 error plus this (the kernels' bound)
BF16_EPS = 2e-3
SHAPES = [(2, 64, 2, 32), (2, 256, 2, 64), (1, 192, 3, 64)]


def _qkv(seed, shape, qk_scale=1.0):
    rs = np.random.default_rng(seed)
    q, k, v, g = (rs.standard_normal(shape).astype(np.float32) for _ in range(4))
    return q * qk_scale, k * qk_scale, v, g


def _bf16(a):
    """bf16 values as fp32 numpy (the bf16 inputs both packages get)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _jax_lse(q, k):
    logits = jnp.einsum("bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32)
    return jax.nn.logsumexp(logits * q.shape[-1] ** -0.5, axis=-1)


@pytest.mark.parametrize("shape", SHAPES)
def test_lse_twin_matches_jax_logsumexp(shape):
    q, k, v, _ = _qkv(sum(shape), shape)
    o, lse = tfa.attention_lse_reference(*(torch.from_numpy(a) for a in (q, k, v)))
    assert lse.dtype == torch.float32 and lse.shape == (shape[0], shape[2], shape[1])
    np.testing.assert_allclose(lse.numpy(), np.asarray(_jax_lse(q, k)),
                               rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jfa._reference(q, k, v)),
                               rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_twin_matches_jax_vjp(shape):
    q, k, v, g = _qkv(sum(shape) + 1, shape)
    _, vjp = jax.vjp(jfa._reference, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = tfa.attention_lse_reference(tq, tk, tv)
    got = tfa.attention_backward_reference(tq, tk, tv, o, lse, tg)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FP32_TOL, atol=FP32_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("shape", [(2, 256, 2, 64), (2, 128, 2, 32)])
def test_twins_in_bf16_within_jax_bf16_error(shape):
    """q and k drawn x2, so the logits are large enough for their rounding to
    show. Each output's error against the fp32 computation on the same bf16
    values, relative to its largest entry."""
    q, k, v, g = (_bf16(a) for a in _qkv(0, shape, qk_scale=2.0))
    ref_o, vjp32 = jax.vjp(jfa._reference, *(jnp.asarray(a) for a in (q, k, v)))
    ref = (ref_o, *vjp32(jnp.asarray(g)))
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g)]
    jax_o, vjp16 = jax.vjp(jfa._reference, *jb[:3])
    jax16 = (jax_o, *vjp16(jb[3]))
    tq, tk, tv, tg = (torch.from_numpy(a).bfloat16() for a in (q, k, v, g))
    o, lse = tfa.attention_lse_reference(tq, tk, tv)
    assert o.dtype == torch.bfloat16
    port = (o, *tfa.attention_backward_reference(tq, tk, tv, o, lse, tg))
    for name, p, j, r in zip(("o", "dq", "dk", "dv"), port, jax16, ref):
        r = np.asarray(r, np.float32)
        p_err = rel_err(p.float().numpy(), r)
        j_err = rel_err(np.asarray(j, np.float32), r)
        assert p_err <= 2 * j_err + BF16_EPS, (name, p_err, j_err)


def test_function_runs_both_twins_with_a_cast_contiguous_gradient(monkeypatch):
    """``_FlashAttention`` saves the forward's o and lse and hands the
    backward launch a contiguous gradient in q's dtype, whatever autograd
    delivers (here a transposed view); the gradients are ``jax.grad``'s."""
    calls = []

    def fwd(q, k, v, with_lse):
        assert with_lse
        calls.append("fwd")
        return tfa.attention_lse_reference(q, k, v)

    def bwd(q, k, v, o, lse, grad):
        calls.append(("bwd", grad.dtype, grad.is_contiguous()))
        return tfa.attention_backward_reference(q, k, v, o, lse, grad)

    monkeypatch.setattr(tfa, "_launch", fwd)
    monkeypatch.setattr(tfa, "_launch_bwd", bwd)
    shape = (2, 64, 2, 32)
    q, k, v, g = _qkv(5, shape)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa._FlashAttention.apply(tq, tk, tv)
    gt = torch.from_numpy(g).transpose(1, 2).contiguous()  # [B, H, S, D]
    got = torch.autograd.grad((out.transpose(1, 2) * gt).sum(), (tq, tk, tv))
    assert calls == ["fwd", ("bwd", torch.float32, True)]
    want = jax.grad(lambda *a: jnp.sum(jfa._reference(*a) * g), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FP32_TOL, atol=FP32_TOL)


def test_fp32_logits_hold_off_autocast():
    """Under autocast a plain product would come back bf16; the logits stay
    fp32 and equal the upcast product."""
    rs = np.random.default_rng(3)
    a, b = (torch.from_numpy(rs.standard_normal((2, 16, 8)).astype(np.float32)).bfloat16()
            for _ in range(2))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = tfa.fp32_logits("bqc,bkc->bqk", a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.einsum("bqc,bkc->bqk", a.float(), b.float()))


def _load(module, params):
    module.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), module))
    return module.eval()


def _doubled_bf16_weights(params):
    """Weights x2 and rounded to bf16, biases 0: JAX adds a bias after
    rounding its bf16 product where PyTorch's linear and conv round once, a
    difference outside the site under test."""
    def leaf(path, a):
        if str(getattr(path[-1], "key", "")) == "bias":
            return jnp.zeros_like(a)
        return jnp.asarray(_bf16(np.asarray(a) * 2))
    return jax.tree_util.tree_map_with_path(leaf, params)


def _site_reference_attention():
    shape = (2, 256, 2, 64)
    q, k, v, _ = (_bf16(a) for a in _qkv(0, shape, qk_scale=2.0))

    def jax_fn(dtype):
        return jattn._reference_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)))

    with torch.no_grad():
        port = tfa.attention_reference(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    return jax_fn(jnp.float32), jax_fn(jnp.bfloat16), port


def _site_packed_attention():
    """The I2V adapter's packed-qkv attention behind its LayerNorm (64
    channels, 2 heads of 32, 256 tokens)."""
    dim, heads, dim_head = 64, 2, 32
    x = _bf16(np.random.default_rng(1).standard_normal((2, 256, dim)).astype(np.float32))
    jm = junet.PreNormAttention(dim, heads, dim_head)
    params = seeded_like(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 4)
    params = _doubled_bf16_weights(params)
    jm16 = junet.PreNormAttention(dim, heads, dim_head, dtype=jnp.bfloat16)
    tm = _load(tunet.PreNormAttention(dim, heads, dim_head), params).bfloat16()
    with torch.no_grad():
        port = tm(torch.from_numpy(x).bfloat16())
    return (jm.apply(params, jnp.asarray(x)),
            jm16.apply(params, jnp.asarray(x, jnp.bfloat16)), port)


def _site_vae_attention():
    """The VAE's mid-block single-head attention (64 channels over 16²)."""
    c = 64
    x = _bf16(np.random.default_rng(2).standard_normal((2, 16, 16, c)).astype(np.float32))
    jm = jvae.VAEAttnBlock(c)
    params = seeded_like(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 5)
    params = _doubled_bf16_weights(params)
    jm16 = jvae.VAEAttnBlock(c, dtype=jnp.bfloat16)
    tm = _load(tvae.AttnBlock(c), params).bfloat16()
    with torch.no_grad():
        port = tm(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()).permute(0, 2, 3, 1)
    return (jm.apply(params, jnp.asarray(x)),
            jm16.apply(params, jnp.asarray(x, jnp.bfloat16)), port)


SITES = {"attention_reference": _site_reference_attention,
         "i2v_packed_attention": _site_packed_attention,
         "vae_attn_block": _site_vae_attention}


@pytest.mark.parametrize("site", sorted(SITES))
def test_plain_site_keeps_fp32_logits(site):
    """bf16 port vs JAX's bf16 counterpart, each against fp32 on the same
    bf16 values and weights (weights and q·k drawn x2 so that rounding the
    logits to bf16 would show): the port may be farther from fp32 than JAX
    by one bf16 rounding of the output (its largest entry's unit in the
    last place), as two accumulation orders can round a value apart."""
    ref, jax16, port = SITES[site]()
    ref = np.asarray(ref, np.float32)
    p_err = rel_err(port.float().numpy(), ref)
    j_err = rel_err(np.asarray(jax16, np.float32), ref)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7) / np.abs(ref).max()
    assert p_err <= j_err + ulp, (site, p_err, j_err, ulp)
