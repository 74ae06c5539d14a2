"""Gaussian diffusion algebra for DDIM sampling and the forward process, on
torch tensors.

Port of what DDIM sampling and the LGM-refine finetune need from
``videomv_tpu/diffusion/gaussian.py``: the per-timestep constants
(``DiffusionParams``), the prediction algebra (``pred_to_x0``,
``x0_to_eps``, ``scale_timesteps``) and the forward process
(``sample_noise`` with the per-frame offset noise, ``q_sample``). The
posterior, the losses and the variational bound wait for the UNet finetune.

The schedule tables are computed in float64 numpy exactly as the JAX
package computes them, kept in float64, and cast to the working dtype on
gather (``_bcast``); a float64 → float32 cast on gather rounds like the JAX
package's float32 tables, so both packages see bit-identical coefficients.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .schedules import beta_schedule

__all__ = ["DiffusionParams", "GaussianDiffusion"]


@dataclasses.dataclass(frozen=True)
class DiffusionParams:
    """Per-timestep diffusion constants (all float64 numpy, shape [T])."""

    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return self.alphas_cumprod.shape[0]

    @classmethod
    def create(cls, betas: np.ndarray) -> "DiffusionParams":
        betas = np.asarray(betas, dtype=np.float64)
        if not (betas.min() > 0 and betas.max() <= 1):
            raise ValueError("betas must lie in (0, 1]")
        alphas_cumprod = np.cumprod(1.0 - betas)
        # the clamp keeps zero-terminal-SNR schedules finite at t = T-1
        # (same limit argument as the JAX package's DiffusionParams)
        acp_safe = np.maximum(alphas_cumprod, 1e-12)
        return cls(
            alphas_cumprod=alphas_cumprod,
            sqrt_alphas_cumprod=np.sqrt(alphas_cumprod),
            sqrt_one_minus_alphas_cumprod=np.sqrt(1.0 - alphas_cumprod),
            sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp_safe),
            sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp_safe - 1.0),
        )


class GaussianDiffusion:
    """Static diffusion configuration plus the DDIM prediction algebra."""

    def __init__(
        self,
        schedule: str = "linear_sd",
        schedule_param: Optional[dict] = None,
        mean_type: str = "eps",
        var_type: str = "fixed_small",
        rescale_timesteps: bool = False,
        noise_strength: float = 0.0,
        **training_only,
    ):
        """Takes the config's ``Diffusion`` block; its other training-only
        keys (``loss_type``...) are accepted and unused."""
        if mean_type not in ("eps", "v", "x0"):
            raise NotImplementedError(f"mean_type {mean_type!r} is not ported")
        if var_type not in {"learned", "learned_range", "fixed_large", "fixed_small"}:
            raise ValueError(f"unknown var_type {var_type!r}")
        self.params = DiffusionParams.create(beta_schedule(schedule, **dict(schedule_param or {})))
        self.num_timesteps = int(self.params.num_timesteps)
        self.mean_type = mean_type
        self.var_type = var_type
        self.rescale_timesteps = rescale_timesteps
        self.noise_strength = float(noise_strength)
        self._tables: Dict[tuple, torch.Tensor] = {}

    def _bcast(self, name: str, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Gather table ``name`` at ``t`` and broadcast to ``x``'s batch
        shape (B, 1, 1, ...), cast to ``x.dtype``. The float64 table is
        copied to ``t``'s device once and cached there."""
        key = (name, t.device)
        vec = self._tables.get(key)
        if vec is None:
            vec = torch.as_tensor(getattr(self.params, name), dtype=torch.float64).to(t.device)
            self._tables[key] = vec
        out = vec.index_select(0, t.long()).to(x.dtype)
        return out.reshape(t.shape + (1,) * (x.ndim - 1))

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

    def pred_to_x0(self, out: torch.Tensor, xt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """Convert the model's raw prediction (per ``mean_type``) to x0."""
        if self.mean_type == "x0":
            return out
        if self.mean_type == "eps":
            return (self._bcast("sqrt_recip_alphas_cumprod", t, xt) * xt
                    - self._bcast("sqrt_recipm1_alphas_cumprod", t, xt) * out)
        return (self._bcast("sqrt_alphas_cumprod", t, xt) * xt  # "v"
                - self._bcast("sqrt_one_minus_alphas_cumprod", t, xt) * out)

    def x0_to_eps(self, x0: torch.Tensor, xt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return ((self._bcast("sqrt_recip_alphas_cumprod", t, xt) * xt - x0)
                / self._bcast("sqrt_recipm1_alphas_cumprod", t, xt))

    def scale_timesteps(self, t: torch.Tensor) -> torch.Tensor:
        if self.rescale_timesteps:
            return t.float() * 1000.0 / self.num_timesteps
        return t
