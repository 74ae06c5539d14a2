"""The port's diffusion training algebra against the JAX package's, fp32 on
the CPU: the forward-process and posterior moments, the regression target
of every ``mean_type``, the variance split of every ``var_type``,
``p_mean_variance`` (guidance, ``clamp``, ``percentile``,
``prediction_is_x0``), the variational bound and its helpers, the training
loss of every ``loss_type`` (with the learned-variance bound, the weight and
the diversity term), and ``ddim_sample_loop`` with eta > 0 (the JAX
sampler's per-step noise replayed), clamp and percentile. Both sides get the
same numpy inputs and the same stub denoiser."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import set_torch_threads
from videomv_tpu.diffusion import GaussianDiffusion as JDiffusion
from videomv_tpu.diffusion import gaussian as jgaussian
from videomv_tpu.diffusion import samplers as jsamplers
from videomv_tpu_torch.diffusion import GaussianDiffusion as TDiffusion
from videomv_tpu_torch.diffusion import gaussian as tgaussian
from videomv_tpu_torch.diffusion import samplers as tsamplers

set_torch_threads()

SCHEDULE = dict(schedule="linear_sd",
                schedule_param=dict(num_timesteps=1000, init_beta=0.00085, last_beta=0.012))
MEAN_TYPES = ["eps", "x0", "x_{t-1}", "v"]
VAR_TYPES = ["learned", "learned_range", "fixed_large", "fixed_small"]
LOSS_TYPES = ["mse", "rescaled_mse", "l1", "rescaled_l1", "kl", "rescaled_kl", "charbonnier"]
# fp32 elementwise algebra on both sides: relative to the largest entry
TOL = 1e-5
SHAPE = (3, 4, 3, 4, 4)      # B, C, F, H, W
T = np.asarray([0, 417, 999])


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, float(np.abs(got - want).max()) / scale


def _inputs(seed=0, channels=4):
    rs = np.random.default_rng(seed)
    x0 = np.tanh(rs.standard_normal(SHAPE)).astype(np.float32)
    xt = rs.standard_normal(SHAPE).astype(np.float32)
    noise = rs.standard_normal(SHAPE).astype(np.float32)
    return x0, xt, noise


def _out_channels(var_type):
    return 8 if var_type.startswith("learned") else 4


def _stub(lib, var_type):
    """A smooth, t-dependent model output of the width ``var_type`` needs
    (mean channels, then the variance channels in [-1, 1])."""
    def fn(xt, t):
        tf = t.astype(jnp.float32) if lib is jnp else t.float()
        s = lib.sin(tf / 100.0).reshape(-1, 1, 1, 1, 1)
        mean = lib.tanh(xt) * 0.8 + 0.1 * s
        if not var_type.startswith("learned"):
            return mean
        var = lib.tanh(0.5 * xt + 0.2 * s) * 0.9
        return (jnp.concatenate if lib is jnp else torch.cat)([mean, var], 1)
    return fn


def _pair(var_type, **kw):
    cfg = dict(SCHEDULE, var_type=var_type, **kw)
    return JDiffusion(**cfg), TDiffusion(**cfg)


def test_q_moments_and_posterior_match_jax():
    jd, td = _pair("fixed_small")
    x0, xt, _ = _inputs(1)
    for got, want in zip(td.q_mean_variance(torch.from_numpy(x0), torch.from_numpy(T)),
                         jd.q_mean_variance(jnp.asarray(x0), jnp.asarray(T))):
        _close(got.numpy(), want)
    for got, want in zip(
            td.q_posterior_mean_variance(torch.from_numpy(x0), torch.from_numpy(xt),
                                         torch.from_numpy(T)),
            jd.q_posterior_mean_variance(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(T))):
        _close(got.numpy(), want)


@pytest.mark.parametrize("mean_type", MEAN_TYPES)
def test_target_and_prediction_algebra_match_jax(mean_type):
    jd, td = _pair("fixed_small", mean_type=mean_type)
    x0, xt, noise = _inputs(2)
    t = T[1:]  # the x_{t-1} inversion divides by posterior_mean_coef1, 0 at t = 0
    args = [a[1:] for a in (x0, xt, noise)]
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    _close(td.target(*(torch.from_numpy(a) for a in args[:2]), tt, torch.from_numpy(args[2])),
           jd.target(jnp.asarray(args[0]), jnp.asarray(args[1]), jt, jnp.asarray(args[2])))
    _close(td.pred_to_x0(torch.from_numpy(args[2]), torch.from_numpy(args[1]), tt),
           jd.pred_to_x0(jnp.asarray(args[2]), jnp.asarray(args[1]), jt), tol=5e-5)


@pytest.mark.parametrize("var_type", VAR_TYPES)
def test_split_variance_matches_jax(var_type):
    jd, td = _pair(var_type)
    _, xt, _ = _inputs(3)
    out = np.random.default_rng(3).uniform(-1, 1, (3, _out_channels(var_type)) + SHAPE[2:])
    out = out.astype(np.float32)
    got = td._split_variance(torch.from_numpy(out), torch.from_numpy(xt), torch.from_numpy(T))
    want = jd._split_variance(jnp.asarray(out), jnp.asarray(xt), jnp.asarray(T))
    for g, w in zip(got, want):
        _close(g.expand(np.broadcast_shapes(g.shape, w.shape)).numpy(),
               np.broadcast_to(np.asarray(w), np.broadcast_shapes(g.shape, w.shape)))


@pytest.mark.parametrize("var_type", VAR_TYPES)
@pytest.mark.parametrize("mode", ["plain", "guided", "clamp", "percentile", "x0"])
def test_p_mean_variance_matches_jax(var_type, mode):
    jd, td = _pair(var_type)
    _, xt, _ = _inputs(4)
    kw = {"plain": {}, "guided": dict(guide_scale=4.0), "clamp": dict(clamp=0.5),
          "percentile": dict(percentile=0.9), "x0": dict(prediction_is_x0=True)}[mode]
    jfn, tfn = _stub(jnp, var_type), _stub(torch, var_type)
    if mode == "guided":  # a (cond, uncond) pair
        jfn0, tfn0 = jfn, tfn
        jfn = lambda x, t: (jfn0(x, t), 0.5 * jfn0(x, t))  # noqa: E731
        tfn = lambda x, t: (tfn0(x, t), 0.5 * tfn0(x, t))  # noqa: E731
    got = td.p_mean_variance(tfn, torch.from_numpy(xt), torch.from_numpy(T), **kw)
    want = jd.p_mean_variance(jfn, jnp.asarray(xt), jnp.asarray(T), **kw)
    for g, w in zip(got, want):
        shape = np.broadcast_shapes(g.shape, w.shape)
        _close(g.expand(shape).numpy(), np.broadcast_to(np.asarray(w), shape), tol=5e-5)


def test_vlb_helpers_match_jax():
    rs = np.random.default_rng(5)
    a, b, c, d = (rs.standard_normal(SHAPE).astype(np.float32) for _ in range(4))
    x0 = np.clip(a, -1, 1)  # both tails of the discretised likelihood
    x0.flat[:3] = [-1.0, 1.0, 0.0]
    _close(tgaussian.kl_divergence(*(torch.from_numpy(v) for v in (a, b, c, d))),
           jgaussian.kl_divergence(*(jnp.asarray(v) for v in (a, b, c, d))))
    _close(tgaussian.standard_normal_cdf(torch.from_numpy(a)),
           jgaussian.standard_normal_cdf(jnp.asarray(a)))
    # unit-scale bins: the log of a difference of two fp32 CDFs near 0.5
    # keeps ~1e-5 of its value (a log_scale far below 0 makes the bin mass
    # a cancellation of nearly equal CDFs in both frameworks alike)
    mean, log_scale = x0 + 0.1 * b, -0.5 + 0.1 * c
    _close(tgaussian.discretized_gaussian_log_likelihood(
        torch.from_numpy(x0), torch.from_numpy(mean), torch.from_numpy(log_scale)),
        jgaussian.discretized_gaussian_log_likelihood(
            jnp.asarray(x0), jnp.asarray(mean), jnp.asarray(log_scale)), tol=5e-5)


@pytest.mark.parametrize("var_type", VAR_TYPES)
def test_variational_lower_bound_matches_jax(var_type):
    jd, td = _pair(var_type)
    x0, xt, _ = _inputs(6)
    got, gx0 = td.variational_lower_bound(torch.from_numpy(x0), torch.from_numpy(xt),
                                          torch.from_numpy(T), _stub(torch, var_type))
    want, wx0 = jd.variational_lower_bound(jnp.asarray(x0), jnp.asarray(xt), jnp.asarray(T),
                                           _stub(jnp, var_type))
    _close(got.numpy(), want, tol=1e-4)
    _close(gx0.numpy(), wx0, tol=5e-5)


@pytest.mark.parametrize("loss_type", LOSS_TYPES)
@pytest.mark.parametrize("var_type,mean_type", [("fixed_small", "eps"), ("learned_range", "v"),
                                                ("learned", "x0")])
def test_loss_matches_jax(loss_type, var_type, mean_type):
    jd, td = _pair(var_type, mean_type=mean_type, loss_type=loss_type)
    x0, _, noise = _inputs(7)
    weight = np.asarray([0.5, 1.0, 2.0], np.float32)
    if loss_type == "charbonnier":  # its weight multiplies the elementwise error
        weight = weight.reshape(-1, 1, 1, 1, 1)
    for kw in (dict(), dict(weight=weight), dict(use_div_loss=True)):
        want, waux = jd.loss(jax.random.PRNGKey(0), _stub(jnp, var_type), jnp.asarray(x0),
                             jnp.asarray(T), noise=jnp.asarray(noise),
                             **{k: jnp.asarray(v) if k == "weight" else v for k, v in kw.items()})
        got, aux = td.loss(_stub(torch, var_type), torch.from_numpy(x0), torch.from_numpy(T),
                           noise=torch.from_numpy(noise),
                           **{k: torch.from_numpy(v) if k == "weight" else v
                              for k, v in kw.items()})
        assert got.shape == (3,)
        _close(got.numpy(), want, tol=1e-4)
        _close(aux["xt"].numpy(), waux["xt"])


def test_loss_draws_its_noise_from_the_generator():
    td = TDiffusion(**dict(SCHEDULE, var_type="fixed_small"))
    x0 = torch.zeros(SHAPE)
    t = torch.from_numpy(T)
    a, aux = td.loss(_stub(torch, "fixed_small"), x0, t,
                     generator=torch.Generator().manual_seed(3))
    b, _ = td.loss(_stub(torch, "fixed_small"), x0, t,
                   generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and aux["noise"].std() > 0.5


def _jax_step_noise(rng, n, shape):
    """The per-step draws of the JAX sampler's ``step_z``: split, then normal."""
    out = []
    for _ in range(n):
        rng, noise_rng = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(noise_rng, shape, jnp.float32)))
    return out


@pytest.mark.parametrize("kw", [dict(eta=0.5), dict(eta=0.5, clamp=1.0),
                                dict(percentile=0.95), dict(clamp=0.8, guide_scale=None),
                                dict(eta=0.5, percentile=0.9, mean_type="v")])
def test_ddim_with_eta_clamp_and_percentile_matches_jax(kw):
    kw = dict(kw)
    mean_type = kw.pop("mean_type", "eps")
    guide = kw.pop("guide_scale", 6.0)
    cfg = dict(SCHEDULE, mean_type=mean_type, var_type="fixed_small")
    steps = 10
    noise = np.random.default_rng(8).standard_normal((2, 4, 3, 4, 4)).astype(np.float32)
    rng = jax.random.PRNGKey(9)

    def jfn(x, t):
        o = _stub(jnp, "fixed_small")(x, t)
        return (o, 0.5 * x) if guide is not None else o

    def tfn(x, t):
        o = _stub(torch, "fixed_small")(x, t)
        return (o, 0.5 * x) if guide is not None else o

    want = jsamplers.ddim_sample_loop(JDiffusion(**cfg), jfn, jnp.asarray(noise),
                                      ddim_timesteps=steps, guide_scale=guide, rng=rng, **kw)
    z = [torch.from_numpy(a) for a in _jax_step_noise(rng, steps, noise.shape)]
    got = tsamplers.ddim_sample_loop(TDiffusion(**cfg), tfn, torch.from_numpy(noise),
                                     ddim_timesteps=steps, guide_scale=guide, step_noise=z, **kw)
    _close(got.numpy(), want)
    if kw.get("eta"):
        # the port's own draws come from the caller's generator
        a = tsamplers.ddim_sample_loop(TDiffusion(**cfg), tfn, torch.from_numpy(noise),
                                       ddim_timesteps=steps, guide_scale=guide,
                                       generator=torch.Generator().manual_seed(1), **kw)
        b = tsamplers.ddim_sample_loop(TDiffusion(**cfg), tfn, torch.from_numpy(noise),
                                       ddim_timesteps=steps, guide_scale=guide,
                                       generator=torch.Generator().manual_seed(1), **kw)
        assert torch.equal(a, b) and not torch.allclose(a, got)
