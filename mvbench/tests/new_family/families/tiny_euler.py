"""A tiny denoiser family: one request is a latent of ``latent`` channels
at ``size``² drawn from the request's seed at σ_max, a prompt reduced to a
conditioning vector, and ``steps`` Euler steps over a float σ schedule
(Karras, ending at 0) through an EDM-preconditioned convolutional
denoiser (c_noise = ln σ / 4). It has no refine and no CFG.

The watch records, for every request the window sends, the state that
each denoiser call received (a forward pre-hook on ``Program.net``). The
check draws ``check.requests`` of them from the seed and holds them to the
plain fp32 reference (``reference/tiny_euler.py``):
``start``, the first state against σ_max × the seed's noise; ``step``, at
every step the program's increment from its own state against the
reference's Euler increment from that state (the last one ends at the
answer); ``missing``, the steps not recorded."""

from __future__ import annotations

import math
import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from ..reference import tiny_euler as ref
from ..traffic import rng_for


class Denoiser(nn.Module):
    def __init__(self, latent: int, width: int, cond_dim: int):
        super().__init__()
        self.table = nn.Parameter(torch.empty(256, cond_dim))
        self.emb = nn.Linear(cond_dim + 1, width)
        self.conv_in = nn.Conv2d(latent, width, 3, padding=1)
        self.conv_mid = nn.Conv2d(width, width, 3, padding=1)
        self.conv_out = nn.Conv2d(width, latent, 3, padding=1)

    def cond(self, prompt: str) -> torch.Tensor:
        idx = torch.tensor(list(prompt.encode()), dtype=torch.long, device=self.table.device)
        return self.table[idx].float().mean(0, keepdim=True)

    def forward(self, x: torch.Tensor, sigma: float, c: torch.Tensor) -> torch.Tensor:
        dt = self.table.dtype
        c_in, c_skip = 1.0 / math.sqrt(sigma ** 2 + 1), 1.0 / (sigma ** 2 + 1)
        c_out = sigma / math.sqrt(sigma ** 2 + 1)
        noise = torch.full((x.shape[0], 1), math.log(sigma) / 4, device=x.device)
        e = self.emb(torch.cat([c, noise], 1).to(dt))
        h = F.silu(self.conv_in((x * c_in).to(dt)) + e[:, :, None, None])
        out = self.conv_out(F.silu(self.conv_mid(h)))
        return c_skip * x + c_out * out.float()


def euler_step(x: torch.Tensor, d: torch.Tensor, s0: float, s1: float) -> torch.Tensor:
    return x + (s1 - s0) * d


class Program:
    def __init__(self, config: dict, mix: dict, device):
        m = config["model"]
        dt = config["pipeline"].get("sampling_dtype", "bfloat16")
        self.device = torch.device(device)
        self.net = Denoiser(m["latent"], m["width"], m["cond_dim"]).to(
            self.device, getattr(torch, dt)).eval().requires_grad_(False)
        s = config["sampler"]
        self.sigmas = [float(v) for v in ref.karras(s["steps"], s["sigma_min"], s["sigma_max"],
                                                    s["rho"])]
        self.shape = (1, m["latent"], m["size"], m["size"])

    def shapes(self) -> Dict[str, list]:
        return {"net": [(k, t.shape) for k, t in self.net.state_dict().items()]}

    def load(self, state_dicts) -> None:
        self.net.load_state_dict(state_dicts["net"])

    def swap(self, models) -> None:
        self.net = models["net"]

    @torch.no_grad()
    def request(self, item: dict) -> dict:
        g = torch.Generator().manual_seed(item["seed"])
        x = (torch.randn(self.shape, generator=g) * self.sigmas[0]).to(self.device)
        c = self.net.cond(item["prompt"])
        for s0, s1 in zip(self.sigmas[:-1], self.sigmas[1:]):
            x = euler_step(x, (x - self.net(x, s0, c)) / s0, s0, s1)
        return {"latents": x.cpu().numpy()}

    @staticmethod
    def finite(out: dict) -> bool:
        return bool(np.isfinite(out["latents"]).all())


class Watch:
    def __init__(self, program, config: dict, mix: dict, seed: int, spans, trace: bool):
        self.config, self.seed, self.k = config, seed, int(mix["check"]["requests"])
        self.on, self.cur, self.j, self.records = False, None, None, {}
        self._hook = program.net.register_forward_pre_hook(self._pre)

    def _pre(self, module, args):
        if self.on and self.cur is not None:
            self.cur.append(args[0].detach().float().cpu())

    def begin(self, j) -> None:
        self.j, self.cur = j, ([] if j is not None else None)

    def end(self) -> None:
        if self.cur is not None:
            self.records[self.j] = self.cur
        self.cur = None

    def readings(self) -> dict:
        return {}

    def close(self) -> None:
        self._hook.remove()

    def check(self, state_dicts, items, outputs, device):
        r = ref.Reference(self.config, state_dicts, device)
        done = [j for j, out in enumerate(outputs) if out is not None]
        picks = sorted(rng_for(self.seed, "check_sample").choice(
            done, min(self.k, len(done)), replace=False))
        read, detail = {"start": 0.0, "step": 0.0, "missing": 0}, []
        for j in picks:
            rec = self.records.get(int(j), [])
            if len(rec) != len(r.sigmas) - 1:
                read["missing"] += abs(len(r.sigmas) - 1 - len(rec))
                print(f"mvbench: request {j}: {len(rec)} denoiser calls recorded of "
                      f"{len(r.sigmas) - 1}", file=sys.stderr)
                continue
            states = [x.to(device) for x in rec]
            states.append(torch.as_tensor(outputs[j]["latents"], device=device))
            read["start"] = max(read["start"], ref.rel(states[0], r.start(items[j])))
            c = r.cond(items[j]["prompt"])
            for i in range(len(rec)):
                want = r.step(states[i], i, c) - states[i]
                detail.append(("step", int(j), i, ref.rel(states[i + 1] - states[i], want)))
                read["step"] = max(read["step"], detail[-1][-1])
        return read, detail


def work(config: dict, mix: dict) -> Dict[str, object]:
    """FLOPs of one request: the reference's denoiser on the meta device,
    once a step."""
    steps = int(config["sampler"]["steps"])
    with torch.device("meta"):
        r = ref.Reference(config, None, "meta")
        x = torch.zeros(r.shape)
        with FlopCounterMode(display=False) as fc:
            r.denoise(x, 1.0, torch.zeros(1, r.weights["table"].shape[1]))
    return {"flops": float(steps * fc.get_total_flops()), "calls": []}
