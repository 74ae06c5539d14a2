"""The splat composite's backward in the port, fp32 on the CPU:
``composite_backward_reference`` (the plain twin of the CUDA kernel
``csrc/splat_composite_bwd.cu``) against autograd through the forward twin
and against the JAX package's Pallas backward kernel run in interpret mode
on the same payload and tile lists, with and without the culled kernel's
masks (``cull_masks``: the twin with every point outside them forced dead);
the gradient of a loss with respect to the Gaussians through the binned
render against ``jax.grad`` through the JAX dense rasterizer; and the packed
payload under grad, which raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videomv_tpu.ops.splat_pallas as jsp
from test_torch_splat import IMG, TAN, _jproj, _scene
from torch_port_helpers import set_torch_threads
from videomv_tpu.ops import gaussian_splat as jgs
from videomv_tpu_torch import ops
from videomv_tpu_torch.ops import gaussian_splat as tgs
from videomv_tpu_torch.ops import splat

set_torch_threads()

NTS = IMG // splat.TILE
# fp32 on both sides. The twin and the Pallas kernel take the same sums in
# another order (64-pair chunks from each tile's start against 512-pair
# chunks on global boundaries), so they agree to a few ulps of the largest
# entry of each gradient row.
REL_TOL = 2e-5


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(jsp, "INTERPRET", True)


@pytest.fixture(scope="module")
def binned():
    """One view of the 192-Gaussian scene of ``test_torch_splat.py`` binned
    by the JAX package (16-row payload), its forward output, and a seeded
    gradient of that output."""
    g, cv, cvp = _scene(192, seed=0)
    payload, ts, tc, nts = jsp._bin_pairs(
        *(jnp.asarray(a) for a in _jproj(g, cv[1], cvp[1])), img_size=IMG, max_pairs=1 << 12,
        max_span=splat.MAX_SPAN)
    assert nts == NTS
    tp, tts, ttc = (torch.from_numpy(np.array(a))[None] for a in (payload, ts, tc))
    saved = splat.composite_reference(tp, tts, ttc, NTS)
    grad = torch.from_numpy(
        np.random.default_rng(5).standard_normal(tuple(saved.shape)).astype(np.float32))
    return (payload, ts, tc), (tp, tts, ttc), saved, grad


def _rel_by_row(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| of a payload row relative to that row's largest
    |want| (rows differ by orders of magnitude), over the rows that carry a
    gradient."""
    worst = 0.0
    for r in range(10):
        scale = np.abs(want[..., r, :]).max()
        assert scale > 0, r
        worst = max(worst, float(np.abs(got[..., r, :] - want[..., r, :]).max() / scale))
    return worst


def test_backward_twin_matches_autograd_of_forward_twin(binned):
    _, (tp, tts, ttc), saved, grad = binned
    p = tp.clone().requires_grad_()
    (want,) = torch.autograd.grad(splat.composite_reference(p, tts, ttc, NTS, chunk=32), p, grad)
    got = splat.composite_backward_reference(tp, tts, ttc, saved, grad, NTS)
    assert got.shape == tp.shape
    assert _rel_by_row(got.numpy(), want.numpy()) <= REL_TOL
    # the padding rows and every pair outside a segment get exactly zero
    assert float(got[:, 10:].abs().max()) == 0.0
    live = int(ttc.sum())
    assert live < tp.shape[-1] and float(got[..., live:].abs().max()) == 0.0
    # another chunking gives the same gradient
    other = splat.composite_backward_reference(tp, tts, ttc, saved, grad, NTS, chunk=17)
    assert _rel_by_row(other.numpy(), got.numpy()) <= REL_TOL


def test_backward_twin_matches_pallas_backward_interpret(binned, interpret):
    (payload, ts, tc), (tp, tts, ttc), saved, grad = binned
    out_tiles = jsp._composite_call(payload, ts, tc, NTS)
    np.testing.assert_allclose(saved[0].numpy(), np.asarray(out_tiles), rtol=1e-5, atol=1e-5)
    want = np.asarray(jsp._composite_bwd_call(payload, ts, tc, out_tiles,
                                              jnp.asarray(grad[0].numpy()), NTS))
    got = splat.composite_backward_reference(tp, tts, ttc, saved, grad, NTS)[0].numpy()
    assert np.abs(want).max() > 1.0  # a gradient worth comparing
    assert _rel_by_row(got, want) <= REL_TOL
    np.testing.assert_array_equal(got[10:], want[10:])


def _planted(binned):
    """The binned view with a NaN opacity and a degenerate (indefinite, finite)
    conic planted in the busiest segment, its forward output recomputed: the
    pairs the culling must keep on every block."""
    (payload, ts, tc), _, _, grad = binned
    pay, ts_, tc_ = np.array(payload), np.array(ts), np.array(tc)
    s0 = int(ts_[int(tc_.argmax())])
    pay[8, s0 + 5] = np.nan                  # a NaN opacity
    pay[2:5, s0 + 9] = [1.0, 2.0, 1.0]       # det < 0
    tp, tts, ttc = (torch.from_numpy(a)[None] for a in (pay, ts_, tc_))
    saved = splat.composite_reference(tp, tts, ttc, NTS)
    return (jnp.asarray(pay), ts, tc), (tp, tts, ttc), saved, grad, (s0 + 5, s0 + 9)


@pytest.mark.parametrize("planted", [False, True])
def test_masked_backward_twin_is_bit_equal_and_matches_pallas_interpret(binned, interpret,
                                                                        planted):
    """With the culled kernel's masks the backward twin drops only dead
    points: bit-equal to the unmasked twin (NaNs in the same places) and
    within ``REL_TOL`` of the Pallas backward; a mask that drops alive blocks
    changes the gradient. With a NaN opacity in the view (which both
    packages' forwards spread over its tile) the Pallas kernel also carries
    NaNs into the neighbouring tiles' columns of its shared 512-pair chunks:
    every NaN of the twin is one of the Pallas kernel's, and the rest agree."""
    if planted:
        (payload, ts, tc), (tp, tts, ttc), saved, grad, at = _planted(binned)
    else:
        (payload, ts, tc), (tp, tts, ttc), saved, grad = binned
    masks = splat.cull_masks(tp, tts, ttc, NTS)
    if planted:
        assert [masks[0, i].item() for i in at] == [255, 255]
    assert 0 < (masks > 0).sum() and (masks[:, :int(ttc.sum())] != 255).any()
    plain = splat.composite_backward_reference(tp, tts, ttc, saved, grad, NTS)
    masked = splat.composite_backward_reference(tp, tts, ttc, saved, grad, NTS, masks=masks)
    np.testing.assert_array_equal(masked.numpy(), plain.numpy())  # NaN where NaN
    assert plain.isnan().any() == planted
    out_tiles = jsp._composite_call(payload, ts, tc, NTS)
    want = np.asarray(jsp._composite_bwd_call(payload, ts, tc, out_tiles,
                                              jnp.asarray(grad[0].numpy()), NTS))
    got = masked[0].numpy()
    assert not (np.isnan(got) & ~np.isnan(want)).any()
    fin = np.isfinite(want)
    compared = 0
    for r in range(10):
        scale = np.abs(np.where(fin[r], want[r], 0.0)).max()
        if scale > 0:
            compared += 1
            assert np.abs(got[r][fin[r]] - want[r][fin[r]]).max() / scale <= REL_TOL, r
    assert compared >= (6 if planted else 10)
    np.testing.assert_array_equal(got[10:], want[10:])
    # a mask that leaves out alive blocks does change the gradient
    dropped = splat.composite_backward_reference(tp, tts, ttc, saved, grad, NTS,
                                                 masks=masks & 0xF0)
    both = ~plain.isnan() & ~dropped.isnan()
    assert not torch.equal(dropped[both], plain[both])


def test_backward_variants_on_cpu_run_the_twin(binned):
    """On CPU tensors every backward variant is the twin."""
    _, (tp, tts, ttc), saved, grad = binned
    want = splat.composite_backward_reference(tp, tts, ttc, saved, grad, NTS)
    for variant in splat.BWD_VARIANT_NAMES:
        got = splat.composite_backward(tp, tts, ttc, saved, grad, NTS, variant=variant)
        assert torch.equal(got, want)


def test_composite_function_backward_runs_the_twin_on_cpu(binned):
    """``composite`` is the autograd.Function: on CPU tensors its backward is
    ``composite_backward_reference`` on the saved forward output, and no
    kernel is launched."""
    _, (tp, tts, ttc), saved, grad = binned
    ops.reset_launch_counts()
    p = tp.clone().requires_grad_()
    out = splat.composite(p, tts, ttc, NTS)
    np.testing.assert_array_equal(out.detach().numpy(), saved.numpy())
    (got,) = torch.autograd.grad(out, p, grad)
    want = splat.composite_backward_reference(tp, tts, ttc, saved, grad, NTS)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert ops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                   "geglu_ffn": 0, "splat_composite": 0,
                                   "splat_composite_bwd": 0, "fused_spatial": 0}


def _loss(img, alpha, depth):
    return (img ** 2).sum() + alpha.sum() + 0.3 * (depth ** 2).sum()


def test_render_grads_match_jax_dense():
    """d loss / d Gaussians through the port's binned render (projection,
    binning gather and the composite's backward twin) against ``jax.grad``
    through the JAX dense rasterizer: the scene and the tolerance of the JAX
    package's own ``test_splat_pallas_grads_match_dense``."""
    size = 16
    g, cv, cvp = _scene(64, seed=3, views=1)
    bg = np.zeros(3, np.float32)

    def jloss(gg):
        return _loss(*jgs.rasterize_dense(gg, jnp.asarray(cv[0]), jnp.asarray(cvp[0]), size,
                                          TAN, jnp.asarray(bg)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(g)))
    tg = torch.from_numpy(g)[None].requires_grad_()
    out = tgs.render_gaussians(tg, torch.from_numpy(cv)[None], torch.from_numpy(cvp)[None],
                               bg_color=torch.from_numpy(bg), img_size=size, backend="binned")
    (got,) = torch.autograd.grad(_loss(out["image"], out["alpha"], out["depth"]), tg)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-3, atol=1e-4)
    # the dense oracle of the port differentiates to the same gradient
    td = torch.from_numpy(g)[None].requires_grad_()
    out = tgs.render_gaussians(td, torch.from_numpy(cv)[None], torch.from_numpy(cvp)[None],
                               bg_color=torch.from_numpy(bg), img_size=size, backend="dense")
    (dense,) = torch.autograd.grad(_loss(out["image"], out["alpha"], out["depth"]), td)
    np.testing.assert_allclose(dense[0].numpy(), want, rtol=1e-3, atol=1e-4)


def test_packed_payload_under_grad_raises():
    g, cv, cvp = _scene(64, seed=3, views=1)
    args = (torch.from_numpy(cv)[None], torch.from_numpy(cvp)[None])
    tg = torch.from_numpy(g)[None].requires_grad_()
    with pytest.raises(ValueError, match="packed"):
        tgs.render_gaussians(tg, *args, img_size=16, backend="binned", packed=True)
    # without a gradient the packed payload renders
    out = tgs.render_gaussians(tg.detach(), *args, img_size=16, backend="binned", packed=True)
    assert torch.isfinite(out["image"]).all()
    with pytest.raises(ValueError, match="16-row"):
        payload = torch.zeros(1, 8, 64)
        lists = torch.zeros(1, 1, dtype=torch.int32)
        tiles = torch.zeros(1, 1, 5, 256)
        splat.composite_backward(payload, lists, lists, tiles, tiles, 1)
