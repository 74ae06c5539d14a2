"""The plain fp32 reference of the ``tiny_euler`` family: the same
denoiser written with functional convolutions over the benchmark's
weights, the Karras σ schedule and the Euler step. It imports nothing of
the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def karras(steps: int, sigma_min: float, sigma_max: float, rho: float) -> list:
    """``steps`` σ from σ_max down to σ_min (Karras et al. 2022), then 0."""
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    out = [(hi + i / (steps - 1) * (lo - hi)) ** rho for i in range(steps)]
    return out + [0.0]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


class Reference:
    def __init__(self, config: dict, state_dicts, device):
        m, s = config["model"], config["sampler"]
        self.device = torch.device(device)
        self.shape = (1, m["latent"], m["size"], m["size"])
        self.sigmas = karras(s["steps"], s["sigma_min"], s["sigma_max"], s["rho"])
        if state_dicts is None:  # the shapes alone (counting on the meta device)
            w, lat, cd = m["width"], m["latent"], m["cond_dim"]
            shapes = {"table": (256, cd), "emb.weight": (w, cd + 1), "emb.bias": (w,),
                      "conv_in.weight": (w, lat, 3, 3), "conv_in.bias": (w,),
                      "conv_mid.weight": (w, w, 3, 3), "conv_mid.bias": (w,),
                      "conv_out.weight": (lat, w, 3, 3), "conv_out.bias": (lat,)}
            self.weights = {k: torch.zeros(v, device=self.device) for k, v in shapes.items()}
        else:
            self.weights = {k: v.to(self.device, torch.float32)
                            for k, v in state_dicts["net"].items()}

    def cond(self, prompt: str) -> torch.Tensor:
        idx = torch.tensor(list(prompt.encode()), dtype=torch.long, device=self.device)
        return self.weights["table"][idx].mean(0, keepdim=True)

    def start(self, item: dict) -> torch.Tensor:
        g = torch.Generator().manual_seed(item["seed"])
        return (torch.randn(self.shape, generator=g) * self.sigmas[0]).to(self.device)

    def denoise(self, x: torch.Tensor, sigma: float, c: torch.Tensor) -> torch.Tensor:
        w = self.weights
        c_in, c_skip = 1.0 / math.sqrt(sigma ** 2 + 1), 1.0 / (sigma ** 2 + 1)
        c_out = sigma / math.sqrt(sigma ** 2 + 1)
        noise = torch.full((x.shape[0], 1), math.log(sigma) / 4, device=x.device)
        e = F.linear(torch.cat([c, noise], 1), w["emb.weight"], w["emb.bias"])
        h = F.silu(F.conv2d(x.float() * c_in, w["conv_in.weight"], w["conv_in.bias"], padding=1)
                   + e[:, :, None, None])
        h = F.silu(F.conv2d(h, w["conv_mid.weight"], w["conv_mid.bias"], padding=1))
        out = F.conv2d(h, w["conv_out.weight"], w["conv_out.bias"], padding=1)
        return c_skip * x.float() + c_out * out

    @torch.no_grad()
    def step(self, x: torch.Tensor, i: int, c: torch.Tensor) -> torch.Tensor:
        """The Euler step at index ``i`` from state ``x``."""
        s0, s1 = self.sigmas[i], self.sigmas[i + 1]
        return x.float() + (s1 - s0) * (x.float() - self.denoise(x, s0, c)) / s0
