"""The EDM side of Stable Video 3D's sampling (``sv3d_p``).

From ``sgm/modules/diffusionmodules`` (Stability-AI/generative-models), at
``scripts/sampling/configs/sv3d_p.yaml``'s settings:

- ``edm_sigmas``: ``EDMDiscretization`` (σ_min 0.002, σ_max 700, ρ 7), the
  steps' σ from σ_max down to σ_min, then 0.
- ``v_scaling``: ``Denoiser`` with ``VScalingWithEDMcNoise``: ``c_skip =
  1/(σ²+1)``, ``c_out = −σ/√(σ²+1)``, ``c_in = 1/√(σ²+1)``, ``c_noise =
  ¼·ln σ``; the denoised estimate is ``D = c_skip·x + c_out·F(c_in·x,
  c_noise)``.
- ``triangle_scale``: ``TrianglePredictionGuider``'s per-frame CFG scale, a
  triangle wave of ``period`` over the frames from ``min_scale`` to
  ``max_scale`` (period 1, minimum 1: 1.0 at the first and last frame, the
  maximum at the middle one).
- ``GuidedDenoiser``: the CFG denoiser as ``EulerEDMSampler`` calls it,
  ``D_u + s_f·(D_c − D_u)`` for frame f, from one batched forward of the
  network over ``[cond; uncond]`` rows.
- ``euler_sample_loop``: ``EulerEDMSampler`` without churn: ``x₀ =
  n·√(1+σ₀²)``, then ``x ← x + (σ_{i+1} − σ_i)·(x − D)/σ_i``, in float32.

Each step is traced as the DDIM loop's are (``utils.profiling``): the span
``sampler.step`` (attrs ``index`` and ``sigma``) around it and
``sampler.forward`` around its denoiser call, counted by ``sampler.steps``
and ``sampler.forwards``, so the benchmark's generic sampler readers read
either loop.
"""

from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch
from torch import nn

from ..utils import profiling

__all__ = ["GuidedDenoiser", "edm_sigmas", "euler_sample_loop", "triangle_scale", "v_scaling"]


def edm_sigmas(steps: int, sigma_min: float = 0.002, sigma_max: float = 700.0,
               rho: float = 7.0) -> List[float]:
    """``steps`` σ from ``sigma_max`` down to ``sigma_min`` (Karras et al.
    2022, ``EDMDiscretization``), then 0: ``steps + 1`` floats."""
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    ramp = [i / (steps - 1) for i in range(steps)] if steps > 1 else [0.0]
    return [(hi + r * (lo - hi)) ** rho for r in ramp] + [0.0]


def v_scaling(sigma: float) -> Tuple[float, float, float, float]:
    """``(c_skip, c_out, c_in, c_noise)`` of ``VScalingWithEDMcNoise``."""
    s2 = sigma * sigma + 1.0
    return 1.0 / s2, -sigma / math.sqrt(s2), 1.0 / math.sqrt(s2), 0.25 * math.log(sigma)


def triangle_scale(frames: int, max_scale: float, min_scale: float = 1.0,
                   period: float = 1.0) -> torch.Tensor:
    """The per-frame guidance scale ``[frames]`` of
    ``TrianglePredictionGuider``: ``min + (max − min)·tri(f / (frames − 1))``
    with ``tri(v) = 2·|v/period − floor(v/period + ½)|``."""
    v = torch.linspace(0, 1, frames, dtype=torch.float64) / period
    tri = 2 * (v - torch.floor(v + 0.5)).abs()
    return (tri * (max_scale - min_scale) + min_scale).float()


class GuidedDenoiser(nn.Module):
    """``D(x, σ)`` under the triangle CFG: ``network(cat[c_in·x, concat],
    c_noise, context, y)`` over ``[cond; uncond]`` rows, each half's ``D =
    c_skip·x + c_out·F``, mixed per frame as ``D_u + s_f·(D_c − D_u)``.

    ``forward(x [T, 4, h, w] fp32, sigma, context, concat, y)``: ``x`` is
    the sampler's state, ``sigma`` a float; ``context``, ``concat`` and ``y``
    hold the 2T rows, cond first (the pipeline builds them once a
    request); ``scale`` [T] lives on x's device. Returns D in float32."""

    def __init__(self, network: nn.Module, scale: torch.Tensor):
        super().__init__()
        self.network = network
        self.register_buffer("scale", scale.float(), persistent=False)

    def forward(self, x: torch.Tensor, sigma: float, context: torch.Tensor,
                concat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        c_skip, c_out, c_in, c_noise = v_scaling(float(sigma))
        t = x.shape[0]
        xin = torch.cat([(x * c_in).repeat(2, 1, 1, 1), concat.float()], dim=1)
        c_noise = torch.full((2 * t,), c_noise, dtype=torch.float32, device=x.device)
        out = self.network(xin, c_noise, context, y).float()
        out_c, out_u = out[:t], out[t:]
        guided = out_u + self.scale[:, None, None, None] * (out_c - out_u)
        return c_skip * x + c_out * guided


def euler_sample_loop(denoise: Callable[[torch.Tensor, float], torch.Tensor],
                      noise: torch.Tensor, sigmas: List[float]) -> torch.Tensor:
    """Euler over ``sigmas`` (``edm_sigmas``) from ``noise`` in float32:
    ``denoise(x, σ)`` is the guided D; ``len(sigmas) − 1`` steps."""
    x = noise.float() * math.sqrt(1.0 + sigmas[0] ** 2)
    for i in range(len(sigmas) - 1):
        s0, s1 = sigmas[i], sigmas[i + 1]
        with profiling.span("sampler.step", index=i, sigma=s0):
            profiling.count("sampler.steps")
            profiling.count("sampler.forwards")
            with profiling.span("sampler.forward"):
                d = denoise(x, s0)
            x = x + (s1 - s0) * (x - d) / s0
    return x
