"""The diffusion schedule and the deterministic DDIM step (eta 0) with
classifier-free guidance, in float64 from the configuration's ``Diffusion``
block: ``linear_sd`` (Stable Diffusion's scaled linear) and ``cosine``
(Nichol and Dhariwal), optionally rescaled to zero terminal SNR (Lin et al.
2023); the prediction is ``eps`` or ``v``."""

from __future__ import annotations

import math

import numpy as np
import torch


def betas(schedule: str, num_timesteps: int = 1000, zero_terminal_snr: bool = False,
          init_beta: float = 0.00085, last_beta: float = 0.012, cosine_s: float = 0.008,
          **unused) -> np.ndarray:
    n = num_timesteps
    if schedule == "linear_sd":
        b = np.linspace(init_beta ** 0.5, last_beta ** 0.5, n, dtype=np.float64) ** 2
    elif schedule == "cosine":
        def f(u):
            return np.cos((u + cosine_s) / (1 + cosine_s) * math.pi / 2) ** 2
        s = np.arange(n, dtype=np.float64)
        b = np.minimum(1.0 - f((s + 1) / n) / f(s / n), 0.999)
    else:
        raise ValueError(f"schedule {schedule!r} is not in the reference")
    if zero_terminal_snr and b.max() != 1.0:
        sq = np.sqrt(np.cumprod(1 - b))
        a0, aT = sq[0], sq[-1]
        sq = (sq - aT) * a0 / (a0 - aT)
        ab = sq ** 2
        b = 1 - np.concatenate([ab[:1], ab[1:] / ab[:-1]])
    return b


class DDIM:
    """``alphas_cumprod`` of the configuration, the step sequence of a
    ``steps``-step DDIM, x0 from a prediction and the eta-0 update."""

    def __init__(self, diffusion_cfg: dict):
        d = dict(diffusion_cfg)
        self.mean_type = d.get("mean_type", "eps")
        if self.mean_type not in ("eps", "v"):
            raise ValueError(f"mean_type {self.mean_type!r} is not in the reference")
        self.acp = np.cumprod(1.0 - betas(d.get("schedule", "linear_sd"),
                                          **dict(d.get("schedule_param", {}))))
        self.T = len(self.acp)

    def timesteps(self, steps: int) -> list:
        stride = self.T // steps
        seq = np.clip(1 + np.arange(0, self.T, stride), 0, self.T - 1)[::-1]
        return [int(s) for s in seq]

    def _a(self, t: int) -> float:
        return float(self.acp[max(t, 0)])

    def x0(self, out: torch.Tensor, xt: torch.Tensor, t: int) -> torch.Tensor:
        a = self._a(t)
        out, xt = out.double(), xt.double()
        if self.mean_type == "eps":
            return math.sqrt(1 / max(a, 1e-12)) * xt - math.sqrt(1 / max(a, 1e-12) - 1) * out
        return math.sqrt(a) * xt - math.sqrt(1 - a) * out

    def step(self, x0: torch.Tensor, xt: torch.Tensor, t: int, stride: int) -> torch.Tensor:
        """x_{t - stride} from x0 (float64)."""
        a, a_prev = self._a(t), self._a(t - stride)
        x0, xt = x0.double(), xt.double()
        eps = (math.sqrt(1 / max(a, 1e-12)) * xt - x0) / math.sqrt(1 / max(a, 1e-12) - 1)
        return math.sqrt(a_prev) * x0 + math.sqrt(1 - a_prev) * eps


def implied_eps(x_next: torch.Tensor, xt: torch.Tensor, a: float, a_prev: float):
    """The eps an eta-0 DDIM update from x_t (at ``alphas_cumprod`` a) to
    x_next (at a_prev) used: x_next = √(a_prev/a)·x_t + c·eps with
    c = √(1 − a_prev) − √(a_prev (1 − a) / a)."""
    c = math.sqrt(1 - a_prev) - math.sqrt(a_prev * (1 - a) / max(a, 1e-12))
    return (x_next.double() - math.sqrt(a_prev / max(a, 1e-12)) * xt.double()) / c


def implied_x0(x_next: torch.Tensor, xt: torch.Tensor, a: float, a_prev: float):
    """The x0 an eta-0 DDIM update from x_t (at ``alphas_cumprod`` a) to
    x_next (at a_prev) used: x_next = √((1 − a_prev)/(1 − a))·x_t + d·x0
    with d = √a_prev − √(a (1 − a_prev) / (1 − a))."""
    d = math.sqrt(a_prev) - math.sqrt(a * (1 - a_prev) / (1 - a))
    return (x_next.double() - math.sqrt((1 - a_prev) / (1 - a)) * xt.double()) / d


def guided(cond: torch.Tensor, uncond: torch.Tensor, scale: float) -> torch.Tensor:
    return uncond + scale * (cond - uncond)
