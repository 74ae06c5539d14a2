"""Port parity for the diffusion layer: schedules (a numpy copy), the
DDIM step sequence, the per-timestep tables, and ``ddim_sample_loop`` with
classifier-free guidance on a stub denoiser, against the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import rel_err, set_torch_threads
from videomv_tpu.diffusion import GaussianDiffusion as JDiffusion
from videomv_tpu.diffusion import samplers as jsamplers
from videomv_tpu.diffusion import schedules as jschedules
from videomv_tpu_torch.diffusion import GaussianDiffusion as TDiffusion
from videomv_tpu_torch.diffusion import samplers as tsamplers
from videomv_tpu_torch.diffusion import schedules as tschedules

set_torch_threads()

LINEAR_SD = dict(schedule="linear_sd",
                 schedule_param=dict(num_timesteps=1000, init_beta=0.00085, last_beta=0.012),
                 mean_type="eps", var_type="fixed_small")
# fp32 algebra on both sides, elementwise only: bound relative to the latents
SAMPLE_REL_TOL = 1e-5


@pytest.mark.parametrize("name,kw", [
    ("linear_sd", dict(init_beta=0.00085, last_beta=0.012)),
    ("linear", dict(init_beta=None, last_beta=None)),
    ("quadratic", {}),
    ("cosine", {}),
    ("logsnr_cosine_interp", {}),
])
@pytest.mark.parametrize("zts", [False, True])
def test_schedules_equal_jax(name, kw, zts):
    want = jschedules.beta_schedule(name, 1000, zero_terminal_snr=zts, **kw)
    got = tschedules.beta_schedule(name, 1000, zero_terminal_snr=zts, **kw)
    np.testing.assert_array_equal(got, want)


def test_ddim_timestep_seq_and_tables_equal_jax():
    for steps in (10, 20, 50, 7):
        np.testing.assert_array_equal(tsamplers.ddim_timestep_seq(1000, steps),
                                      jsamplers.ddim_timestep_seq(1000, steps))
    jd, td = JDiffusion(**LINEAR_SD), TDiffusion(**LINEAR_SD)
    for name in ("alphas_cumprod", "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"):
        # float64 tables cast on gather == the JAX package's float32 tables
        t = torch.arange(1000)
        got = td._bcast(name, t, torch.zeros(1000, 1)).reshape(-1).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(jd.params, name)))


def _stub_jax(xt, t):
    """A smooth, t-dependent (cond, uncond) pair."""
    s = jnp.sin(t.astype(jnp.float32) / 100.0).reshape(-1, 1, 1, 1, 1)
    return jnp.tanh(xt) * 0.8 + 0.1 * s, 0.5 * xt - 0.05 * s


def _stub_torch(xt, t):
    s = torch.sin(t.float() / 100.0).reshape(-1, 1, 1, 1, 1)
    return torch.tanh(xt) * 0.8 + 0.1 * s, 0.5 * xt - 0.05 * s


@pytest.mark.parametrize("mean_type,steps", [("eps", 10), ("eps", 50), ("v", 20)])
def test_ddim_cfg_loop_matches_jax(mean_type, steps):
    cfg = dict(LINEAR_SD, mean_type=mean_type)
    noise = np.random.default_rng(steps).standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    want = jax.jit(lambda n: jsamplers.ddim_sample_loop(
        JDiffusion(**cfg), _stub_jax, n, ddim_timesteps=steps, guide_scale=9.0))(noise)
    got = tsamplers.ddim_sample_loop(TDiffusion(**cfg), _stub_torch, torch.from_numpy(noise),
                                     ddim_timesteps=steps, guide_scale=9.0)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), np.asarray(want)) <= SAMPLE_REL_TOL


# the I2V schedule (configs/i2vgen_xl_train.yaml): cosine betas rescaled to a
# zero terminal SNR, v-prediction
COSINE_ZTS_V = dict(schedule="cosine",
                    schedule_param=dict(num_timesteps=1000, cosine_s=0.008,
                                        zero_terminal_snr=True),
                    mean_type="v", var_type="fixed_small")


@pytest.mark.parametrize("steps,first_t", [(10, 901), (50, 981)])
def test_ddim_cfg_loop_matches_jax_at_the_i2v_schedule(steps, first_t):
    """alphas_cumprod is 0 at t = 999 under the zero terminal SNR; the DDIM
    sequences start below it, so nothing divides by it."""
    seq = tsamplers.ddim_timestep_seq(1000, steps)
    assert int(seq.max()) == first_t
    td = TDiffusion(**COSINE_ZTS_V)
    t999 = torch.tensor([999])
    assert float(td._bcast("alphas_cumprod", t999, torch.zeros(1, 1))) == 0.0
    noise = np.random.default_rng(steps).standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    want = jax.jit(lambda n: jsamplers.ddim_sample_loop(
        JDiffusion(**COSINE_ZTS_V), _stub_jax, n, ddim_timesteps=steps, guide_scale=6.0))(noise)
    got = tsamplers.ddim_sample_loop(td, _stub_torch, torch.from_numpy(noise),
                                     ddim_timesteps=steps, guide_scale=6.0)
    assert np.isfinite(got.numpy()).all()
    assert rel_err(got.numpy(), np.asarray(want)) <= SAMPLE_REL_TOL


def test_unported_mean_type_raises():
    with pytest.raises(NotImplementedError):
        TDiffusion(**dict(LINEAR_SD, mean_type="x_{t-1}"))


def test_q_sample_and_offset_noise_match_jax():
    """The forward process on the same noise, and the offset noise's shape
    and statistics (the two frameworks' generators never agree on values)."""
    rs = np.random.default_rng(4)
    x0 = rs.standard_normal((3, 4, 5, 6, 6)).astype(np.float32)
    noise = rs.standard_normal(x0.shape).astype(np.float32)
    t = np.asarray([0, 417, 999])
    want = JDiffusion(**LINEAR_SD).q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = TDiffusion(**LINEAR_SD).q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                                           torch.from_numpy(noise))
    assert rel_err(got.numpy(), np.asarray(want)) <= SAMPLE_REL_TOL

    plain = TDiffusion(**LINEAR_SD)
    offset = TDiffusion(noise_strength=0.5, **LINEAR_SD)
    big = torch.zeros(8, 4, 6, 32, 32)
    a = plain.sample_noise(big, torch.Generator().manual_seed(1))
    b = offset.sample_noise(big, torch.Generator().manual_seed(1))
    assert torch.equal(a, plain.sample_noise(big, torch.Generator().manual_seed(1)))
    assert a.shape == b.shape == big.shape
    # the same first draw, plus one offset per (batch, channel, frame)
    per_frame = (b - a).reshape(8 * 4 * 6, -1)
    assert float((per_frame - per_frame[:, :1]).abs().max()) <= 1e-6
    assert 0.3 < float(per_frame[:, 0].std()) < 0.7        # 0.5 · N(0, 1)
    assert abs(float(a.std()) - 1.0) < 0.01
    jb = JDiffusion(noise_strength=0.5, **LINEAR_SD).sample_noise(
        jax.random.PRNGKey(0), jnp.zeros(big.shape))
    assert abs(float(jb.std()) - float(b.std())) < 0.02     # sqrt(1 + 0.25) on both
