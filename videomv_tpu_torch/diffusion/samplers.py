"""Diffusion samplers on torch tensors.

Port of ``videomv_tpu/diffusion/samplers.py``: DDIM (deterministic with eta
0, or stochastic) with classifier-free guidance, x0 clamping or percentile
thresholding and the Gaussian-splat refine at fixed loop indices; the
deterministic DDIM inversion x0 → xT; ancestral DDPM over every timestep;
and PLMS, whose first step is the improved-Euler bootstrap and whose later
steps climb the Adams–Bashforth ladder over the last three eps (the JAX
package's repair of the reference's PLMS). A Python loop over the step
sequence replaces ``lax.scan``. The latents stay float32; the denoiser casts
to its own dtype. DDIM traces each step (span ``sampler.step``, counter
``sampler.steps``) and each plain step's CFG forward (``sampler.forward``,
``sampler.forwards``) through ``utils.profiling``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils import profiling
from .gaussian import GaussianDiffusion, clip_x0

__all__ = ["ddim_reverse_sample_loop", "ddim_sample_loop", "ddim_timestep_seq",
           "ddpm_sample_loop", "plms_sample_loop"]

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim_timestep_seq(num_timesteps: int, ddim_timesteps: int) -> np.ndarray:
    """The reference's descending DDIM step sequence
    (diffusion_ddim.py:253): ``(1 + arange(0, T, T//S)).clamp(0, T-1)[::-1]``."""
    stride = num_timesteps // ddim_timesteps
    steps = 1 + np.arange(0, num_timesteps, stride)
    steps = np.clip(steps, 0, num_timesteps - 1)
    return steps[::-1].copy()


def _guided_prediction(diffusion: GaussianDiffusion, model_fn: ModelFn,
                       xt: torch.Tensor, t: torch.Tensor,
                       guide_scale: Optional[float],
                       forward_span: Optional[str] = None) -> torch.Tensor:
    """Raw (possibly guided) model prediction; guidance mixes
    ``u + s·(c − u)`` on the mean channels only. ``forward_span`` names a
    span around the model call."""
    with profiling.span(forward_span) if forward_span else contextlib.nullcontext():
        out = model_fn(xt, diffusion.scale_timesteps(t))
    if guide_scale is None:
        return out
    y_out, u_out = out
    dim = y_out.shape[1] if diffusion.var_type.startswith("fixed") else y_out.shape[1] // 2
    mixed = u_out[:, :dim] + guide_scale * (y_out[:, :dim] - u_out[:, :dim])
    return torch.cat([mixed, y_out[:, dim:]], dim=1)


def _pred_x0(diffusion: GaussianDiffusion, out: torch.Tensor, xt: torch.Tensor,
             t: torch.Tensor, clamp: Optional[float], percentile: Optional[float],
             prediction_is_x0: bool) -> torch.Tensor:
    """x0 from the raw prediction (its mean channels), or the prediction
    itself with ``prediction_is_x0``, then clamped or thresholded."""
    if not diffusion.var_type.startswith("fixed"):
        out = out.chunk(2, dim=1)[0]
    x0 = out if prediction_is_x0 else diffusion.pred_to_x0(out, xt, t)
    return clip_x0(x0, clamp, percentile)


def _ddim_update(diffusion: GaussianDiffusion, x0: torch.Tensor, xt: torch.Tensor,
                 t: torch.Tensor, stride: int, eta: float,
                 noise: Optional[torch.Tensor]) -> torch.Tensor:
    """One DDIM update from the predicted x0 (``alphas_prev`` at
    ``clip(t - stride, 0)``); with eta > 0 it adds ``sigma · noise`` except
    where t = 0."""
    eps = diffusion.x0_to_eps(x0, xt, t)
    alphas_prev = diffusion._bcast("alphas_cumprod", (t - stride).clamp_min(0), xt)
    if eta == 0:
        return torch.sqrt(alphas_prev) * x0 + torch.sqrt(1 - alphas_prev) * eps
    alphas = diffusion._bcast("alphas_cumprod", t, xt)
    sigmas = eta * torch.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    direction = torch.sqrt(1 - alphas_prev - sigmas ** 2) * eps
    mask = (t != 0).to(xt.dtype).reshape((-1,) + (1,) * (xt.ndim - 1))
    return torch.sqrt(alphas_prev) * x0 + direction + mask * sigmas * noise


@torch.no_grad()
def ddim_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    noise: torch.Tensor,
    *,
    ddim_timesteps: int = 20,
    eta: float = 0.0,
    guide_scale: Optional[float] = None,
    clamp: Optional[float] = None,
    percentile: Optional[float] = None,
    refine_fn: Optional[ModelFn] = None,
    refine_steps: Sequence[int] = (20, 30, 40),
    generator: Optional[torch.Generator] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """DDIM sampling from ``noise`` [B, C, F, H, W].

    ``model_fn(xt, t)`` returns the raw prediction, or a ``(cond, uncond)``
    pair when ``guide_scale`` is set. ``refine_fn`` (the Gaussian-splat
    refine, same signature) takes the place of ``model_fn`` at the loop
    indices in ``refine_steps``; its (guided) output is taken as x0, and no
    plain forward runs at those steps. With ``eta`` > 0 each step draws its
    noise like ``xt`` from ``generator``, or takes entry i of
    ``step_noise`` at loop index i (to replay another sampler's draws)."""
    T = diffusion.num_timesteps
    stride = T // ddim_timesteps
    b = noise.shape[0]
    steps = ddim_timestep_seq(T, ddim_timesteps)
    if eta > 0 and step_noise is not None and len(step_noise) < len(steps):
        raise ValueError(f"step_noise holds {len(step_noise)} draws for {len(steps)} steps")
    refine_at = ({int(i) for i in refine_steps if 0 <= int(i) < len(steps)}
                 if refine_fn is not None else set())
    xt = noise
    for i, step in enumerate(steps):
        refine = i in refine_at
        with profiling.span("sampler.step", index=i, refine=refine):
            profiling.count("sampler.steps")
            t = torch.full((b,), int(step), dtype=torch.long, device=noise.device)
            z = None
            if eta > 0:
                z = (step_noise[i].to(xt) if step_noise is not None else
                     torch.randn(xt.shape, generator=generator, device=xt.device,
                                 dtype=xt.dtype))
            if refine:
                out = _guided_prediction(diffusion, refine_fn, xt, t, guide_scale)
            else:
                profiling.count("sampler.forwards")
                out = _guided_prediction(diffusion, model_fn, xt, t, guide_scale,
                                         "sampler.forward")
            x0 = _pred_x0(diffusion, out, xt, t, clamp, percentile, refine)
            xt = _ddim_update(diffusion, x0, xt, t, stride, eta, z)
    return xt


def _steps_tensor(step: int, b: int, device) -> torch.Tensor:
    return torch.full((b,), int(step), dtype=torch.long, device=device)


@torch.no_grad()
def ddim_reverse_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    x0: torch.Tensor,
    *,
    ddim_timesteps: int = 20,
    guide_scale: Optional[float] = None,
    clamp: Optional[float] = None,
    percentile: Optional[float] = None,
) -> torch.Tensor:
    """Deterministic DDIM inversion x0 → xT (diffusion_ddim.py:262-293):
    over t = 0, stride, ..., each step moves the predicted x0 and eps to
    ``alphas_cumprod`` at ``t + stride`` (clipped to T, where the cumprod is
    padded with a 0)."""
    T = diffusion.num_timesteps
    stride = T // ddim_timesteps
    b = x0.shape[0]
    xt = x0
    for step in range(0, T, stride):
        t = _steps_tensor(step, b, x0.device)
        out = _guided_prediction(diffusion, model_fn, xt, t, guide_scale)
        pred_x0 = _pred_x0(diffusion, out, xt, t, clamp, percentile, False)
        eps = diffusion.x0_to_eps(pred_x0, xt, t)
        nxt = t + stride
        a_next = diffusion._bcast("alphas_cumprod", nxt.clamp_max(T - 1), xt)
        a_next = torch.where((nxt < T).reshape(a_next.shape), a_next, torch.zeros_like(a_next))
        xt = torch.sqrt(a_next) * pred_x0 + torch.sqrt(1 - a_next) * eps
    return xt


@torch.no_grad()
def ddpm_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    noise: torch.Tensor,
    *,
    guide_scale: Optional[float] = None,
    clamp: Optional[float] = None,
    percentile: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Ancestral sampling of p(x_{t-1} | x_t) over all T steps
    (diffusion_ddim.py:106-136): ``mu + exp(log_var / 2) · z`` except at
    t = 0. Loop index i (timestep T - 1 - i) draws its ``z`` like the
    latents from ``generator``, or takes ``step_noise[i]`` (to replay
    another sampler's draws)."""
    T = diffusion.num_timesteps
    b = noise.shape[0]
    if step_noise is not None and len(step_noise) < T:
        raise ValueError(f"step_noise holds {len(step_noise)} draws for {T} steps")
    xt = noise
    for i, step in enumerate(range(T - 1, -1, -1)):
        t = _steps_tensor(step, b, noise.device)
        mu, _, log_var, _ = diffusion.p_mean_variance(
            model_fn, xt, t, guide_scale=guide_scale, clamp=clamp, percentile=percentile)
        z = (step_noise[i].to(xt) if step_noise is not None else
             torch.randn(xt.shape, generator=generator, device=xt.device, dtype=xt.dtype))
        mask = (t != 0).to(xt.dtype).reshape((-1,) + (1,) * (xt.dim() - 1))
        xt = mu + mask * torch.exp(0.5 * log_var) * z
    return xt


@torch.no_grad()
def plms_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    noise: torch.Tensor,
    *,
    plms_timesteps: int = 20,
    guide_scale: Optional[float] = None,
    clamp: Optional[float] = None,
    percentile: Optional[float] = None,
) -> torch.Tensor:
    """Pseudo linear multistep sampling over the DDIM step sequence: the
    first step averages its eps with the eps at the next step's estimate
    (two model calls, the improved-Euler bootstrap at ``clamp(t - stride,
    0)``); the later ones take the 2nd-, 3rd- and 4th-order Adams–Bashforth
    combination of this eps and the last three (diffusion_ddim.py:338-374)."""
    T = diffusion.num_timesteps
    stride = T // plms_timesteps
    b = noise.shape[0]

    def compute_eps(xt, t):
        out = _guided_prediction(diffusion, model_fn, xt, t, guide_scale)
        x0 = _pred_x0(diffusion, out, xt, t, clamp, percentile, False)
        return diffusion.x0_to_eps(x0, xt, t)

    def step_to_prev(eps, xt, t):
        x0 = (diffusion._bcast("sqrt_recip_alphas_cumprod", t, xt) * xt
              - diffusion._bcast("sqrt_recipm1_alphas_cumprod", t, xt) * eps)
        alphas_prev = diffusion._bcast("alphas_cumprod", (t - stride).clamp_min(0), xt)
        return torch.sqrt(alphas_prev) * x0 + torch.sqrt(1 - alphas_prev) * eps

    history = []  # the last three eps, oldest first
    xt = noise
    for step in ddim_timestep_seq(T, plms_timesteps):
        t = _steps_tensor(step, b, noise.device)
        eps = compute_eps(xt, t)
        if not history:
            eps_next = compute_eps(step_to_prev(eps, xt, t), (t - stride).clamp_min(0))
            eps_prime = (eps + eps_next) / 2.0
        elif len(history) == 1:
            eps_prime = (3 * eps - history[-1]) / 2.0
        elif len(history) == 2:
            eps_prime = (23 * eps - 16 * history[-1] + 5 * history[-2]) / 12.0
        else:
            eps_prime = (55 * eps - 59 * history[-1] + 37 * history[-2]
                         - 9 * history[-3]) / 24.0
        xt = step_to_prev(eps_prime, xt, t)
        history = (history + [eps])[-3:]
    return xt
