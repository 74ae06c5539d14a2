"""Gaussian diffusion algebra on torch tensors.

Port of ``videomv_tpu/diffusion/gaussian.py``: the per-timestep constants
(``DiffusionParams``), the forward process (``sample_noise`` with the
per-frame offset noise, ``q_sample``, ``q_mean_variance``,
``q_posterior_mean_variance``), the prediction algebra (``pred_to_x0``,
``x0_to_eps``, ``target``, ``scale_timesteps``), the reverse step's
distribution (``p_mean_variance`` with guidance, ``clamp`` and
``percentile``), the training loss (``loss``: mse, l1, charbonnier and their
``rescaled_`` forms, plus the variational bound for the learned variance
types and the diversity term) and the variational bound itself, for every
``mean_type`` and ``var_type`` of the JAX package.

The schedule tables are computed in float64 numpy exactly as the JAX
package computes them, kept in float64, and cast to the working dtype on
gather (``_bcast``); a float64 → float32 cast on gather rounds like the JAX
package's float32 tables, so both packages see bit-identical coefficients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .schedules import beta_schedule

__all__ = ["DiffusionParams", "GaussianDiffusion", "discretized_gaussian_log_likelihood",
           "kl_divergence", "standard_normal_cdf"]

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DiffusionParams:
    """Per-timestep diffusion constants (all float64 numpy, shape [T])."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return self.alphas_cumprod.shape[0]

    @classmethod
    def create(cls, betas: np.ndarray) -> "DiffusionParams":
        betas = np.asarray(betas, dtype=np.float64)
        if not (betas.min() > 0 and betas.max() <= 1):
            raise ValueError("betas must lie in (0, 1]")
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        # the clamp keeps zero-terminal-SNR schedules finite at t = T-1
        # (same limit argument as the JAX package's DiffusionParams)
        acp_safe = np.maximum(alphas_cumprod, 1e-12)
        return cls(
            betas=betas,
            alphas_cumprod=alphas_cumprod,
            sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
            log_one_minus_alphas_cumprod=np.log(1.0 - alphas_cumprod),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp_safe),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp_safe - 1.0),
            posterior_variance=posterior_variance,
            posterior_log_variance_clipped=np.log(np.maximum(posterior_variance, 1e-20)),
            posterior_mean_coef1=betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
            posterior_mean_coef2=((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                  / (1.0 - alphas_cumprod)),
        )


def _f32(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32)


class GaussianDiffusion:
    """Static diffusion configuration plus the diffusion algebra."""

    def __init__(
        self,
        schedule: str = "linear_sd",
        schedule_param: Optional[dict] = None,
        mean_type: str = "eps",
        var_type: str = "fixed_small",
        loss_type: str = "mse",
        epsilon: float = 1e-12,
        rescale_timesteps: bool = False,
        noise_strength: float = 0.0,
        **unused,
    ):
        """Takes the config's ``Diffusion`` block (other keys are accepted
        and unused)."""
        if mean_type not in ("eps", "v", "x0", "x_{t-1}"):
            raise ValueError(f"unknown mean_type {mean_type!r}")
        if var_type not in {"learned", "learned_range", "fixed_large", "fixed_small"}:
            raise ValueError(f"unknown var_type {var_type!r}")
        if loss_type not in {"mse", "rescaled_mse", "kl", "rescaled_kl", "l1", "rescaled_l1",
                             "charbonnier"}:
            raise ValueError(f"unknown loss_type {loss_type!r}")
        self.params = DiffusionParams.create(beta_schedule(schedule, **dict(schedule_param or {})))
        self.num_timesteps = int(self.params.num_timesteps)
        self.mean_type = mean_type
        self.var_type = var_type
        self.loss_type = loss_type
        self.epsilon = float(epsilon)
        self.rescale_timesteps = rescale_timesteps
        self.noise_strength = float(noise_strength)
        p = self.params
        # Tables the JAX package derives from its float32 constants, derived
        # here the same way (float32 arithmetic on the float32-rounded
        # tables) so that both packages gather the same coefficients.
        self._derived = {
            "one_minus_alphas_cumprod": np.float32(1.0) - _f32(p.alphas_cumprod),
            "log_betas": np.log(_f32(p.betas)),
            "fixed_large_variance": np.concatenate(
                [_f32(p.posterior_variance)[1:2], _f32(p.betas)[1:]]),
            "recip_posterior_mean_coef1": np.float32(1.0) / _f32(p.posterior_mean_coef1),
            "posterior_mean_coef_ratio": (_f32(p.posterior_mean_coef2)
                                          / _f32(p.posterior_mean_coef1)),
        }
        self._derived["log_fixed_large_variance"] = np.log(self._derived["fixed_large_variance"])
        self._tables: Dict[tuple, torch.Tensor] = {}

    def _bcast(self, name: str, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Gather table ``name`` at ``t`` and broadcast to ``x``'s batch
        shape (B, 1, 1, ...), cast to ``x.dtype``. The table is copied to
        ``t``'s device once and cached there: the float64 constants (a
        float64 → float32 cast on gather rounds like the JAX package's
        float32 tables) or a float32 derived table."""
        key = (name, t.device)
        vec = self._tables.get(key)
        if vec is None:
            arr = self._derived.get(name)
            if arr is None:
                arr = np.asarray(getattr(self.params, name), np.float64)
            vec = torch.as_tensor(arr).to(t.device)
            self._tables[key] = vec
        out = vec.index_select(0, t.long()).to(x.dtype)
        return out.reshape(t.shape + (1,) * (x.ndim - 1))

    # ------------------------------------------------------------------ q(.)

    def sample_noise(self, x0: torch.Tensor, generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
        """Gaussian noise shaped like ``x0 [B, C, F, ...]`` from an explicit
        generator, plus ``noise_strength`` times one draw per (batch,
        channel, frame) broadcast over the frame's pixels (the reference's
        offset noise, diffusion_ddim.py:71-78)."""
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=x0.dtype)
        if self.noise_strength > 0:
            b, c, f = x0.shape[:3]
            offset = torch.randn((b, c, f) + (1,) * (x0.ndim - 3), generator=generator,
                                 device=x0.device, dtype=x0.dtype)
            noise = noise + self.noise_strength * offset
        return noise

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Sample from q(x_t | x_0)."""
        return (self._bcast("sqrt_alphas_cumprod", t, x0) * x0
                + self._bcast("sqrt_one_minus_alphas_cumprod", t, x0) * noise)

    def q_mean_variance(self, x0: torch.Tensor, t: torch.Tensor):
        """Mean, variance and log-variance of q(x_t | x_0)."""
        return (self._bcast("sqrt_alphas_cumprod", t, x0) * x0,
                self._bcast("one_minus_alphas_cumprod", t, x0),
                self._bcast("log_one_minus_alphas_cumprod", t, x0))

    def q_posterior_mean_variance(self, x0: torch.Tensor, xt: torch.Tensor, t: torch.Tensor):
        """Mean, variance and clipped log-variance of q(x_{t-1} | x_t, x_0)."""
        mu = (self._bcast("posterior_mean_coef1", t, xt) * x0
              + self._bcast("posterior_mean_coef2", t, xt) * xt)
        return (mu, self._bcast("posterior_variance", t, xt),
                self._bcast("posterior_log_variance_clipped", t, xt))

    # ------------------------------------------------------- prediction math

    def pred_to_x0(self, out: torch.Tensor, xt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Convert the model's raw prediction (per ``mean_type``) to x0."""
        if self.mean_type == "x0":
            return out
        if self.mean_type == "eps":
            return (self._bcast("sqrt_recip_alphas_cumprod", t, xt) * xt
                    - self._bcast("sqrt_recipm1_alphas_cumprod", t, xt) * out)
        if self.mean_type == "v":
            return (self._bcast("sqrt_alphas_cumprod", t, xt) * xt
                    - self._bcast("sqrt_one_minus_alphas_cumprod", t, xt) * out)
        return (self._bcast("recip_posterior_mean_coef1", t, xt) * out  # "x_{t-1}"
                - self._bcast("posterior_mean_coef_ratio", t, xt) * xt)

    def x0_to_eps(self, x0: torch.Tensor, xt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return ((self._bcast("sqrt_recip_alphas_cumprod", t, xt) * xt - x0)
                / self._bcast("sqrt_recipm1_alphas_cumprod", t, xt))

    def target(self, x0: torch.Tensor, xt: torch.Tensor, t: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
        """Regression target for the configured ``mean_type``."""
        if self.mean_type == "eps":
            return noise
        if self.mean_type == "x0":
            return x0
        if self.mean_type == "x_{t-1}":
            return self.q_posterior_mean_variance(x0, xt, t)[0]
        return (self._bcast("sqrt_alphas_cumprod", t, xt) * noise  # "v"
                - self._bcast("sqrt_one_minus_alphas_cumprod", t, xt) * x0)

    def scale_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        if self.rescale_timesteps:
            return t.float() * 1000.0 / self.num_timesteps
        return t

    # ------------------------------------------------------------------ p(.)

    def _split_variance(self, out: torch.Tensor, xt: torch.Tensor, t: torch.Tensor):
        """The mean channels of the raw output, and the variance and
        log-variance per ``var_type``."""
        if self.var_type == "learned":
            out, log_var = out.chunk(2, dim=1)
            return out, torch.exp(log_var), log_var
        if self.var_type == "learned_range":
            out, fraction = out.chunk(2, dim=1)
            min_log = self._bcast("posterior_log_variance_clipped", t, xt)
            max_log = self._bcast("log_betas", t, xt)
            fraction = (fraction + 1) / 2.0
            log_var = fraction * max_log + (1 - fraction) * min_log
            return out, torch.exp(log_var), log_var
        if self.var_type == "fixed_large":
            return (out, self._bcast("fixed_large_variance", t, xt),
                    self._bcast("log_fixed_large_variance", t, xt))
        return (out, self._bcast("posterior_variance", t, xt),  # "fixed_small"
                self._bcast("posterior_log_variance_clipped", t, xt))

    def p_mean_variance(self, model_fn: ModelFn, xt: torch.Tensor, t: torch.Tensor,
                        guide_scale: Optional[float] = None, clamp: Optional[float] = None,
                        percentile: Optional[float] = None, prediction_is_x0: bool = False):
        """Distribution of p(x_{t-1} | x_t): ``(mu, var, log_var, x0)``.

        ``model_fn(xt, t)`` returns the raw prediction or, with
        ``guide_scale``, a ``(cond, uncond)`` pair mixed as ``u + s·(c − u)``
        on the mean channels. ``prediction_is_x0`` takes the (guided) output
        as x0 itself (the Gaussian-splat refine). ``percentile`` rescales x0
        by its per-sample quantile of |x0| (at least 1); else ``clamp``
        clips it."""
        if guide_scale is None:
            out = model_fn(xt, self.scale_timesteps(t))
        else:
            y_out, u_out = model_fn(xt, self.scale_timesteps(t))
            dim = y_out.shape[1] if self.var_type.startswith("fixed") else y_out.shape[1] // 2
            mixed = u_out[:, :dim] + guide_scale * (y_out[:, :dim] - u_out[:, :dim])
            out = torch.cat([mixed, y_out[:, dim:]], dim=1)
        out, var, log_var = self._split_variance(out, xt, t)
        x0 = out if prediction_is_x0 else self.pred_to_x0(out, xt, t)
        x0 = clip_x0(x0, clamp, percentile)
        mu, _, _ = self.q_posterior_mean_variance(x0, xt, t)
        return mu, var, log_var, x0

    # ---------------------------------------------------------------- losses

    def loss(self, model_fn: ModelFn, x0: torch.Tensor, t: torch.Tensor,
             noise: Optional[torch.Tensor] = None, weight: Optional[torch.Tensor] = None,
             use_div_loss: bool = False, generator: Optional[torch.Generator] = None):
        """Per-sample training loss ``(loss [B], aux)`` (reference
        diffusion_ddim.py:377-466); ``noise`` defaults to a draw from
        ``generator``. For the learned variance types the variational bound
        of the (frozen) mean and the learned variance is added, scaled by
        T / 1000 for the ``rescaled_`` losses."""
        if noise is None:
            noise = self.sample_noise(x0, generator)
        xt = self.q_sample(x0, t, noise)
        out = model_fn(xt, self.scale_timesteps(t))

        loss_vlb = 0.0
        if self.var_type in ("learned", "learned_range"):
            out, var = out.chunk(2, dim=1)
            frozen = torch.cat([out.detach(), var], dim=1)
            loss_vlb, _ = self.variational_lower_bound(x0, xt, t, lambda *a, **k: frozen)
            if self.loss_type.startswith("rescaled_"):
                loss_vlb = loss_vlb * self.num_timesteps / 1000.0

        target = self.target(x0, xt, t, noise)
        if self.loss_type == "charbonnier":
            err = torch.sqrt((out - target) ** 2 + self.epsilon)
            if weight is not None:
                err = err * weight
            loss = err.reshape(err.shape[0], -1).mean(dim=1)
        else:
            power = 1 if self.loss_type.endswith("l1") else 2
            err = (out - target).abs() ** power
            loss = err.reshape(err.shape[0], -1).mean(dim=1)
            if weight is not None:
                loss = loss * weight
            if use_div_loss and self.mean_type == "eps" and x0.shape[2] > 1:
                # diversity regulariser over the frame axis
                x0_ = self.pred_to_x0(out, xt, t)
                spread = x0_.std(dim=2, correction=0).reshape(x0.shape[0], -1).mean(dim=1)
                loss = loss + 0.001 / (spread + 1e-4)
        return loss + loss_vlb, {"xt": xt, "pred": out, "noise": noise}

    # ------------------------------------------------------------------- VLB

    def variational_lower_bound(self, x0: torch.Tensor, xt: torch.Tensor, t: torch.Tensor,
                                model_fn: ModelFn, clamp: Optional[float] = None,
                                percentile: Optional[float] = None):
        """Per-sample bound in bits: the KL of the posterior against the
        model's step, or at t = 0 the discretised decoder NLL."""
        mu1, _, log_var1 = self.q_posterior_mean_variance(x0, xt, t)
        mu2, _, log_var2, pred_x0 = self.p_mean_variance(model_fn, xt, t, clamp=clamp,
                                                         percentile=percentile)
        kl = kl_divergence(mu1, log_var1, mu2, log_var2)
        kl = kl.reshape(kl.shape[0], -1).mean(dim=1) / math.log(2.0)
        nll = -discretized_gaussian_log_likelihood(x0, mean=mu2, log_scale=0.5 * log_var2)
        nll = nll.reshape(nll.shape[0], -1).mean(dim=1) / math.log(2.0)
        return torch.where(t == 0, nll, kl), pred_x0


def clip_x0(x0: torch.Tensor, clamp: Optional[float] = None,
            percentile: Optional[float] = None) -> torch.Tensor:
    """Dynamic thresholding: with ``percentile`` each sample is clipped to,
    and divided by, the ``percentile`` quantile of its |x0| (at least 1);
    else ``clamp`` clips to [-clamp, clamp]."""
    if percentile is not None:
        if not 0 < percentile <= 1:
            raise ValueError(f"percentile must lie in (0, 1], got {percentile}")
        flat = x0.reshape(x0.shape[0], -1).abs()
        s = torch.quantile(flat, percentile, dim=1).clamp_min(1.0)
        s = s.reshape((-1,) + (1,) * (x0.ndim - 1))
        return torch.minimum(torch.maximum(x0, -s), s) / s
    if clamp is not None:
        return x0.clamp(-clamp, clamp)
    return x0


# ------------------------------------------------------------------- helpers
# (reference tools/modules/diffusions/losses.py)


def kl_divergence(mu1, log_var1, mu2, log_var2):
    return 0.5 * (-1.0 + log_var2 - log_var1 + torch.exp(log_var1 - log_var2)
                  + ((mu1 - mu2) ** 2) * torch.exp(-log_var2))


def standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x0, mean, log_scale):
    """Log-likelihood of x0 under a Gaussian discretised to 1/255 bins."""
    centered_x = x0 - mean
    inv_stdv = torch.exp(-log_scale)
    cdf_plus = standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp_min(1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp_min(1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp_min(1e-12))
    return torch.where(x0 < -0.999, log_cdf_plus,
                       torch.where(x0 > 0.999, log_one_minus_cdf_min, log_cdf_delta))
