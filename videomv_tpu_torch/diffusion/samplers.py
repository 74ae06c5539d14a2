"""DDIM sampling on torch tensors.

Port of ``ddim_sample_loop`` from ``videomv_tpu/diffusion/samplers.py``:
deterministic (eta 0) or stochastic (eta > 0) DDIM with classifier-free
guidance, x0 clamping or percentile thresholding, and the Gaussian-splat
refine at fixed loop indices. A Python loop over the descending step
sequence replaces ``lax.scan``. The latents stay float32; the denoiser casts
to its own dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .gaussian import GaussianDiffusion, clip_x0

__all__ = ["ddim_timestep_seq", "ddim_sample_loop"]

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
                       guide_scale: Optional[float]) -> torch.Tensor:
    """Raw (possibly guided) model prediction; guidance mixes
    ``u + s·(c − u)`` on the mean channels only."""
    if guide_scale is None:
        return model_fn(xt, diffusion.scale_timesteps(t))
    y_out, u_out = model_fn(xt, diffusion.scale_timesteps(t))
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
        t = torch.full((b,), int(step), dtype=torch.long, device=noise.device)
        z = None
        if eta > 0:
            z = (step_noise[i].to(xt) if step_noise is not None else
                 torch.randn(xt.shape, generator=generator, device=xt.device, dtype=xt.dtype))
        refine = i in refine_at
        out = _guided_prediction(diffusion, refine_fn if refine else model_fn, xt, t,
                                 guide_scale)
        x0 = _pred_x0(diffusion, out, xt, t, clamp, percentile, refine)
        xt = _ddim_update(diffusion, x0, xt, t, stride, eta, z)
    return xt
