"""The port's DDIM inversion, DDPM and PLMS samplers against the JAX
package's ``lax.scan`` samplers, fp32 on the CPU, with the same numpy noise
and the same stub denoiser on both sides. DDPM replays the JAX sampler's
key splits, so the port gets the same per-step draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import rel_err, set_torch_threads
from videomv_tpu.diffusion import GaussianDiffusion as JDiffusion
from videomv_tpu.diffusion import samplers as jsamplers
from videomv_tpu_torch import diffusion as tdiffusion
from videomv_tpu_torch.diffusion import GaussianDiffusion as TDiffusion

set_torch_threads()

# fp32 on both sides, the same operations in the same order per step
SAMPLE_REL_TOL = 1e-5
# PLMS under guidance is ill-conditioned in fp32: its Adams-Bashforth
# combination (coefficients up to 59/24) of guided eps reaches x0 through
# sqrt(1/alphas_cumprod) (14 at t = 951), so one rounding of the noise or of
# the model's output moves the JAX sampler's own result by 1.5e-5 (10 steps,
# CFG 6, v) to 1e-4 (20 steps, CFG 9). The port, which rounds every step in
# another order than XLA's fused loop, is held to twice the largest such move
# measured in the case (two roundings), where that exceeds SAMPLE_REL_TOL
NUDGE = 1.2e-7
LINEAR_SD = dict(schedule="linear_sd",
                 schedule_param=dict(num_timesteps=1000, init_beta=0.00085, last_beta=0.012),
                 mean_type="eps", var_type="fixed_small")
SHAPE = (2, 4, 3, 4, 4)


def _stub(lib, guided, learned=False):
    """A smooth, t-dependent prediction (a (cond, uncond) pair when
    ``guided``), with variance channels in [-1, 1] when ``learned``."""
    cat = jnp.concatenate if lib is jnp else torch.cat

    def one(xt, s, a):
        mean = lib.tanh(xt) * a + 0.1 * s
        return cat([mean, lib.tanh(0.5 * xt + 0.2 * s) * 0.9], 1) if learned else mean

    def fn(xt, t):
        tf = t.astype(jnp.float32) if lib is jnp else t.float()
        s = lib.sin(tf / 100.0).reshape(-1, 1, 1, 1, 1)
        return (one(xt, s, 0.8), one(0.5 * xt, -0.5 * s, 0.6)) if guided else one(xt, s, 0.8)
    return fn


def _noise(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_samplers_are_exported():
    for name in ("ddim_reverse_sample_loop", "ddpm_sample_loop", "plms_sample_loop"):
        assert name in tdiffusion.__all__ and callable(getattr(tdiffusion, name))


@pytest.mark.parametrize("steps,guide,mean_type", [(20, 9.0, "eps"), (5, None, "eps"),
                                                   (10, 6.0, "v")])
def test_plms_matches_jax(steps, guide, mean_type):
    """Within SAMPLE_REL_TOL of JAX, or within twice the JAX sampler's own
    move when its noise, or every output of its model, is scaled by
    1 ± NUDGE, whichever is larger."""
    cfg = dict(LINEAR_SD, mean_type=mean_type)
    noise = _noise(steps)

    def jax_sample(x, scale=1.0):
        stub = _stub(jnp, guide is not None)

        def model(xt, t):
            out = stub(xt, t)
            return tuple(o * scale for o in out) if guide is not None else out * scale

        return np.asarray(jax.jit(lambda n: jsamplers.plms_sample_loop(
            JDiffusion(**cfg), model, n, plms_timesteps=steps, guide_scale=guide))(x))

    want = jax_sample(noise)
    conditioning = max(rel_err(jax_sample(noise * np.float32(1 + NUDGE)), want),
                       *(rel_err(jax_sample(noise, 1 + d), want) for d in (NUDGE, -NUDGE)))
    calls = []

    def model(xt, t):
        calls.append(int(t[0]))
        return _stub(torch, guide is not None)(xt, t)

    got = tdiffusion.plms_sample_loop(TDiffusion(**cfg), model, torch.from_numpy(noise),
                                      plms_timesteps=steps, guide_scale=guide)
    assert np.isfinite(got.numpy()).all()
    assert rel_err(got.numpy(), want) <= max(SAMPLE_REL_TOL, 2 * conditioning)
    # the bootstrap's second call at clamp(t - stride, 0), then one a step
    stride = 1000 // steps
    assert len(calls) == steps + 1 and calls[1] == max(calls[0] - stride, 0)


@pytest.mark.parametrize("steps,guide,clamp", [(20, 9.0, None), (10, None, 1.0)])
def test_ddim_inversion_matches_jax(steps, guide, clamp):
    x0 = np.tanh(_noise(steps + 1))
    want = jax.jit(lambda x: jsamplers.ddim_reverse_sample_loop(
        JDiffusion(**LINEAR_SD), _stub(jnp, guide is not None), x, ddim_timesteps=steps,
        guide_scale=guide, clamp=clamp))(x0)
    got = tdiffusion.ddim_reverse_sample_loop(
        TDiffusion(**LINEAR_SD), _stub(torch, guide is not None), torch.from_numpy(x0),
        ddim_timesteps=steps, guide_scale=guide, clamp=clamp)
    assert np.isfinite(got.numpy()).all()
    assert rel_err(got.numpy(), np.asarray(want)) <= SAMPLE_REL_TOL


def _jax_ddpm_draws(seed, steps, shape):
    """The per-step normals of JAX ``ddpm_sample_loop``'s scan: one split a
    step, the second key drawn from."""
    rng, draws = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, key = jax.random.split(rng)
        draws.append(np.array(jax.random.normal(key, shape, jnp.float32)))
    return draws


@pytest.mark.parametrize("var_type,guide,clamp", [("fixed_small", 9.0, None),
                                                  ("learned_range", None, 1.0),
                                                  ("fixed_large", 6.0, None)])
def test_ddpm_matches_jax_with_its_draws(var_type, guide, clamp):
    cfg = dict(LINEAR_SD, var_type=var_type,
               schedule_param=dict(num_timesteps=50, init_beta=0.00085, last_beta=0.012))
    learned = var_type.startswith("learned")
    noise = _noise(7)
    want = jax.jit(lambda n: jsamplers.ddpm_sample_loop(
        JDiffusion(**cfg), _stub(jnp, guide is not None, learned), n, guide_scale=guide,
        clamp=clamp, rng=jax.random.PRNGKey(5)))(noise)
    draws = [torch.from_numpy(d) for d in _jax_ddpm_draws(5, 50, SHAPE)]
    got = tdiffusion.ddpm_sample_loop(TDiffusion(**cfg), _stub(torch, guide is not None, learned),
                                      torch.from_numpy(noise), guide_scale=guide, clamp=clamp,
                                      step_noise=draws)
    assert np.isfinite(got.numpy()).all()
    assert rel_err(got.numpy(), np.asarray(want)) <= SAMPLE_REL_TOL


def test_ddpm_draws_from_its_generator():
    cfg = dict(LINEAR_SD, schedule_param=dict(num_timesteps=20, init_beta=0.00085,
                                              last_beta=0.012))
    td, noise = TDiffusion(**cfg), torch.from_numpy(_noise(1))

    def run(seed):
        return tdiffusion.ddpm_sample_loop(td, _stub(torch, False), noise,
                                           generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with pytest.raises(ValueError, match="step_noise"):
        tdiffusion.ddpm_sample_loop(td, _stub(torch, False), noise, step_noise=[noise] * 3)
