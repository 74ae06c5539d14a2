"""DDIM sampling on torch tensors.

Port of ``ddim_sample_loop`` from ``videomv_tpu/diffusion/samplers.py`` for
the deterministic sampler the pipeline runs (eta 0, no x0 clamping), with
the Gaussian-splat refine at fixed loop indices: a Python loop over the
descending step sequence replaces ``lax.scan``. The latents stay float32;
the denoiser casts to its own dtype.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .gaussian import GaussianDiffusion

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


def _ddim_update(diffusion: GaussianDiffusion, out: torch.Tensor, xt: torch.Tensor,
                 t: torch.Tensor, stride: int, prediction_is_x0: bool = False) -> torch.Tensor:
    """One deterministic (eta 0) DDIM update from the raw prediction, or
    from x0 itself with ``prediction_is_x0`` (``alphas_prev`` at
    ``clip(t - stride, 0)``)."""
    if not diffusion.var_type.startswith("fixed"):
        out = out.chunk(2, dim=1)[0]
    x0 = out if prediction_is_x0 else diffusion.pred_to_x0(out, xt, t)
    eps = diffusion.x0_to_eps(x0, xt, t)
    alphas_prev = diffusion._bcast("alphas_cumprod", (t - stride).clamp_min(0), xt)
    return torch.sqrt(alphas_prev) * x0 + torch.sqrt(1 - alphas_prev) * eps


@torch.no_grad()
def ddim_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: ModelFn,
    noise: torch.Tensor,
    *,
    ddim_timesteps: int = 20,
    guide_scale: Optional[float] = None,
    refine_fn: Optional[ModelFn] = None,
    refine_steps: Sequence[int] = (20, 30, 40),
) -> torch.Tensor:
    """Deterministic DDIM sampling from ``noise`` [B, C, F, H, W].

    ``model_fn(xt, t)`` returns the raw prediction, or a ``(cond, uncond)``
    pair when ``guide_scale`` is set. ``refine_fn`` (the Gaussian-splat
    refine, same signature) takes the place of ``model_fn`` at the loop
    indices in ``refine_steps``; its (guided) output is taken as x0, and no
    plain forward runs at those steps."""
    T = diffusion.num_timesteps
    stride = T // ddim_timesteps
    b = noise.shape[0]
    steps = ddim_timestep_seq(T, ddim_timesteps)
    refine_at = ({int(i) for i in refine_steps if 0 <= int(i) < len(steps)}
                 if refine_fn is not None else set())
    xt = noise
    for i, step in enumerate(steps):
        t = torch.full((b,), int(step), dtype=torch.long, device=noise.device)
        refine = i in refine_at
        out = _guided_prediction(diffusion, refine_fn if refine else model_fn, xt, t,
                                 guide_scale)
        xt = _ddim_update(diffusion, out, xt, t, stride, prediction_is_x0=refine)
    return xt
