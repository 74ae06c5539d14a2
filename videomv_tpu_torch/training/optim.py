"""The learning-rate schedule and AdamW of the LGM-refine finetune.

Port of ``videomv_tpu/training/optim.py``: ``annealing_lr`` (linear warm-up,
then cosine or linear decay to ``decay_ratio`` of the peak; reference
utils/optim/lr_scheduler.py:6-58) and the AdamW branch of
``build_optimizer``. The update is written out to match the optax chain the
JAX package builds (``scale_by_adam(mu_dtype=bfloat16)`` →
``add_decayed_weights`` → ``scale_by_schedule``), including its details:

* the first moment is stored in bf16: ``b1 · mu`` is a bf16 product (b1
  itself rounded to bf16, as JAX rounds a Python scalar that meets a bf16
  array, so the decay is 0.8984375 for b1 = 0.9) to which the fp32
  gradient term is added; the bias-corrected update uses that unrounded
  fp32 sum, which is then rounded to bf16 for storage. The second moment and
  the parameters stay fp32;
* the schedule is read at the count *before* the increment, so the first
  update runs at ``lr(0)``, which is 0 under warm-up;
* weight decay is added to the Adam direction before the learning rate.

Adafactor, the per-key gradient scaling of the SD-origin weights and
gradient clipping belong to the UNet finetune and are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np
import torch

__all__ = ["AdamW", "annealing_lr", "build_optimizer"]


def annealing_lr(peak_lr: float, warmup_steps: int = 10, total_steps: int = 1_000_000,
                 decay_mode: str = "cosine", decay_ratio: float = 0.5
                 ) -> Callable[[int], float]:
    """``schedule(step) -> lr``, computed in float32 like the JAX schedule."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(peak_lr) * step / f32(max(warmup_steps, 1)))
        progress = np.clip((step - f32(warmup_steps))
                           / f32(max(total_steps - warmup_steps, 1)), f32(0), f32(1))
        if decay_mode == "cosine":
            return float(f32(peak_lr) * (f32(decay_ratio) + f32(1 - decay_ratio) * f32(0.5)
                                         * (f32(1) + np.cos(f32(math.pi) * progress))))
        if decay_mode == "linear":
            return float(f32(peak_lr) * (f32(1) - f32(1 - decay_ratio) * progress))
        return float(f32(peak_lr))  # constant after warm-up

    return schedule


class AdamW:
    """AdamW over a fixed list of fp32 parameters, first moment in bf16.

    ``step()`` reads each parameter's ``.grad`` and updates the parameter in
    place; ``count`` is the number of updates taken. The update runs as a
    handful of multi-tensor (``torch._foreach``) operations."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable[[int], float],
                 betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.params: List[torch.nn.Parameter] = [p for p in params if p.requires_grad]
        for p in self.params:
            if p.dtype != torch.float32:
                raise ValueError(f"AdamW keeps fp32 master parameters, got {p.dtype}")
        self.schedule = schedule
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.bfloat16) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> float:
        """One update from the parameters' ``.grad``; returns the learning
        rate it used."""
        lr = self.schedule(self.count)
        self.count += 1
        grads = [p.grad.float() for p in self.params]
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        # mu <- (1 - b1) g + bf16(bf16(b1) mu), kept in fp32 until it is stored
        b1_bf16 = float(torch.tensor(self.b1).bfloat16())
        mu32 = [m.float() for m in torch._foreach_mul(self.mu, b1_bf16)]
        torch._foreach_add_(mu32, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu32, bc1)
        torch._foreach_div_(update, denom)
        if self.weight_decay:
            torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-lr)
        torch._foreach_copy_(self.mu, mu32)
        return lr

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count, "mu": [m.clone() for m in self.mu],
                "nu": [v.clone() for v in self.nu]}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError("optimizer state does not fit this parameter list")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape:
                raise ValueError("optimizer state does not fit this parameter list")
            dst.copy_(src)


def build_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 3e-5,
                    weight_decay: float = 0.0, betas: Sequence[float] = (0.9, 0.999),
                    eps: float = 1e-8, warmup_steps: int = 10, total_steps: int = 1_000_000,
                    decay_mode: str = "cosine", optimizer: str = "adamw") -> AdamW:
    """AdamW under ``annealing_lr`` (the reference recipe,
    train_t2v_enterance.py:203-225)."""
    if optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {optimizer!r} is not ported yet (it comes with the UNet finetune)")
    schedule = annealing_lr(lr, warmup_steps, total_steps, decay_mode)
    return AdamW(params, schedule, betas=betas, eps=eps, weight_decay=weight_decay)
