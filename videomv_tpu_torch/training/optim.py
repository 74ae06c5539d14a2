"""Learning-rate schedule, optimizers and gradient transforms of the
finetunes.

Port of ``videomv_tpu/training/optim.py``: ``annealing_lr`` (linear warm-up,
then cosine or linear decay to ``decay_ratio`` of the peak; reference
utils/optim/lr_scheduler.py:6-58), ``build_optimizer`` with AdamW or
Adafactor, the per-key gradient scale of the SD-origin weights
(``sd_key_matcher``, ``scale_selected_grads``; reference
pretrain_functions.py:19-51) and clipping by the global norm. Each
optimizer's ``step()`` applies, in the optax chain's order,
``clip_by_global_norm`` → the key scale → the update.

The AdamW update is written out to match the optax chain the JAX package
builds (``scale_by_adam(mu_dtype=bfloat16)`` → ``add_decayed_weights`` →
``scale_by_schedule``), including its details:

* the first moment is stored in bf16: ``b1 · mu`` is a bf16 product (b1
  itself rounded to bf16, as JAX rounds a Python scalar that meets a bf16
  array, so the decay is 0.8984375 for b1 = 0.9) to which the fp32
  gradient term is added; the bias-corrected update uses that unrounded
  fp32 sum, which is then rounded to bf16 for storage. The second moment and
  the parameters stay fp32;
* the schedule is read at the count *before* the increment, so the first
  update runs at ``lr(0)``, which is 0 under warm-up;
* weight decay is added to the Adam direction before the learning rate.

Adafactor is ``optax.adafactor`` at its defaults: a factored second moment
over the two largest axes when the second largest has at least 128 entries,
decay ``1 - (k+1)^-0.8``, per-tensor RMS clipping at 1, the update scaled by
the learning rate and by the parameter's RMS (at least 1e-3), eps 1e-30.
The gradient scale is applied as JAX applies it, before the optimizer:
Adam normalises a constant scale away except through ``eps``.

Under FSDP (``parallel.mesh.apply_fsdp``) a parameter is a ``DTensor`` of
which this rank holds a shard (rows of its axis 0, fewer or none on the last
ranks where the rows do not divide); the global norm of the clip sums the
shards' squares over the ranks. AdamW is elementwise and updates the shard
it holds (its moments are shards too). Adafactor keeps what optax computes
on the whole parameter: the factored axes are chosen from the global shape,
every mean over axis 0 (the moments' reduction, ``row_col_mean``) is a sum
all-reduced over the ranks and divided by the global row count, and the RMS
of ``clip_by_block_rms`` and ``scale_by_param_block_rms`` is all-reduced
likewise; a moment that keeps axis 0 is sharded with its parameter, one that
reduces it is whole on every rank. ``full_state_dict`` gathers either
optimizer's state into whole tensors (every rank calls it) and
``load_full_state_dict`` cuts whole tensors back to this rank's shards.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

__all__ = ["Adafactor", "AdamW", "annealing_lr", "build_optimizer", "clip_by_global_norm_",
           "local_tensor", "scale_selected_grads", "sd_key_matcher"]


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


def sd_key_matcher(sd_keys_path: str) -> Callable[[str], bool]:
    """A predicate over the port's parameter names from the reference's
    SD-key JSON (682 released torch keys). The port's names are the released
    keys, so a name matches when its stem (the name without ``.weight`` /
    ``.bias``) is a listed key's stem, as the JAX matcher compares stems:
    a listed weight marks its bias too."""
    with open(sd_keys_path) as f:
        stems = {re.sub(r"\.(weight|bias)$", "", k) for k in json.load(f)}

    def match(name: str) -> bool:
        return re.sub(r"\.(weight|bias)$", "", name) in stems

    return match


def resolve_sd_keys_path(grad_scale: float, sd_keys_path: Optional[str]) -> str:
    """The key list's path, or the JAX package's errors: no path given, or a
    path that exists neither as given nor under the repository root."""
    if sd_keys_path is None:
        raise ValueError(
            "Pretrain.grad_scale is set but sd_keys_path is not; point it at "
            "data/stable_diffusion_image_key_temporal_attention_x1.json "
            "(vendored) or set grad_scale: 1.0 to disable the scaling.")
    if os.path.exists(sd_keys_path):
        return sd_keys_path
    repo_rel = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        sd_keys_path)
    if os.path.exists(repo_rel):
        return repo_rel
    raise FileNotFoundError(
        f"Pretrain.grad_scale={grad_scale} requires the SD-origin key list at "
        f"{sd_keys_path!r}, which does not exist. The vendored copy lives at "
        "data/stable_diffusion_image_key_temporal_attention_x1.json.")


def scale_selected_grads(grads: List[torch.Tensor], selected: Sequence[int],
                         scale: float) -> None:
    """Multiply the gradients at indices ``selected`` by ``scale`` in place
    (the reference's per-tensor gradient hooks)."""
    if selected:
        torch._foreach_mul_([grads[i] for i in selected], scale)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """The part of ``t`` this rank holds: its shard of a ``DTensor``, else
    ``t`` itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _gather_rows(t: torch.Tensor, param: DTensor) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's rows, split over axis 0
    as ``param`` is."""
    shape = (param.shape[0],) + tuple(t.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t, param.device_mesh, param.placements, shape=shape,
                              stride=stride).full_tensor()


def _shard_rows(t: torch.Tensor, param: DTensor) -> torch.Tensor:
    """This rank's rows of the whole tensor ``t``, split over axis 0 as
    ``param`` is."""
    return distribute_tensor(t.to(param.device), param.device_mesh,
                             param.placements).to_local()


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Sequence[bool] = (), group=None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: when the global L2 norm of
    all gradients reaches ``max_norm``, each becomes ``g / norm * max_norm``.
    The test stays on the device (no host read). Returns the norm. Where
    ``sharded[i]`` is true, ``grads[i]`` is this rank's shard of a gradient
    split over ``group``, and the squares of the shards are summed over it."""
    norms = torch.stack(torch._foreach_norm(grads))
    if any(sharded):
        sq = norms.square()
        mask = torch.tensor(list(sharded), device=sq.device)
        part = torch.where(mask, sq, torch.zeros_like(sq)).sum()
        dist.all_reduce(part, group=group)
        norm = (part + torch.where(mask, torch.zeros_like(sq), sq).sum()).sqrt()
    else:
        norm = torch.linalg.vector_norm(norms)
    keep = norm < max_norm
    one = torch.ones((), device=norm.device, dtype=norm.dtype)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


class _Optimizer:
    """What AdamW and Adafactor share: the fp32 master parameters, the
    gradient transforms in front of the update, and ``count``, the number
    of updates taken."""

    def __init__(self, params, schedule: Callable[[int], float],
                 grad_clip: Optional[float] = None, grad_scale: Optional[float] = None,
                 scale_match: Optional[Callable[[str], bool]] = None):
        named = _named(params)
        self.names: List[str] = [n for n, p in named if p.requires_grad]
        self.params: List[torch.nn.Parameter] = [p for _, p in named if p.requires_grad]
        for p in self.params:
            if p.dtype != torch.float32:
                raise ValueError(f"{type(self).__name__} keeps fp32 master parameters, "
                                 f"got {p.dtype}")
        self.sharded = [isinstance(p, DTensor) for p in self.params]
        self.group = next((p.device_mesh.get_group() for p in self.params
                           if isinstance(p, DTensor)), None)
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.grad_scale = grad_scale
        self.scaled: List[int] = ([i for i, n in enumerate(self.names) if scale_match(n)]
                                  if scale_match is not None else [])
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _tensors(self) -> List[torch.Tensor]:
        """The parameters as this rank holds them (shards under FSDP), read
        anew each step: FSDP may rebind a shard's tensor after the first
        forward."""
        return [local_tensor(p) for p in self.params]

    def _state_rows(self) -> Dict[str, List[bool]]:
        """For each list of per-parameter state, whether each tensor holds
        rows of its parameter's sharded axis 0."""
        raise NotImplementedError

    def full_state_dict(self) -> Dict[str, object]:
        """``state_dict()`` with every sharded tensor gathered whole; under
        FSDP every rank calls it."""
        state = self.state_dict()
        if any(self.sharded):
            for key, rows in self._state_rows().items():
                state[key] = [_gather_rows(t, p) if r else t
                              for t, p, r in zip(state[key], self.params, rows)]
        return state

    def load_full_state_dict(self, state: Dict[str, object]) -> None:
        """``load_state_dict`` of whole tensors, each cut to this rank's
        rows where its parameter is sharded."""
        if any(self.sharded):
            state = dict(state)
            for key, rows in self._state_rows().items():
                state[key] = [_shard_rows(t, p) if r else t
                              for t, p, r in zip(state[key], self.params, rows)]
        self.load_state_dict(state)

    def _grads(self) -> List[torch.Tensor]:
        """The fp32 gradients after clipping and the key scale (this rank's
        shards under FSDP). A parameter the loss did not reach (no ``.grad``;
        the camera MLP in an image step) has a zero gradient, as in JAX."""
        grads = [local_tensor(p.grad).float() if p.grad is not None
                 else torch.zeros_like(local_tensor(p)) for p in self.params]
        if self.grad_clip:
            clip_by_global_norm_(grads, self.grad_clip, self.sharded, self.group)
        if self.grad_scale is not None:
            scale_selected_grads(grads, self.scaled, self.grad_scale)
        return grads


def _named(params) -> List[Tuple[str, torch.nn.Parameter]]:
    """``named_parameters()`` pairs as given, or plain parameters named by
    their index."""
    items = list(params)
    if items and isinstance(items[0], tuple):
        return items
    return [(str(i), p) for i, p in enumerate(items)]


class AdamW(_Optimizer):
    """AdamW over a fixed list of fp32 parameters, first moment in bf16.

    ``step()`` reads each parameter's ``.grad`` and updates the parameter in
    place; ``count`` is the number of updates taken. The update runs as a
    handful of multi-tensor (``torch._foreach``) operations."""

    def __init__(self, params, schedule: Callable[[int], float],
                 betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, **transforms):
        super().__init__(params, schedule, **transforms)
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        with torch.no_grad():
            local = self._tensors()
        self.mu = [torch.zeros_like(p, dtype=torch.bfloat16) for p in local]
        self.nu = [torch.zeros_like(p) for p in local]

    @torch.no_grad()
    def step(self) -> float:
        """One update from the parameters' ``.grad``; returns the learning
        rate it used."""
        params = self._tensors()
        grads = self._grads()
        lr = self.schedule(self.count)
        self.count += 1
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
            torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_add_(params, update, alpha=-lr)
        torch._foreach_copy_(self.mu, mu32)
        return lr

    def _state_rows(self) -> Dict[str, List[bool]]:
        return {"mu": list(self.sharded), "nu": list(self.sharded)}

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


# optax.adafactor's defaults
ADAFACTOR_MIN_DIM, ADAFACTOR_DECAY, ADAFACTOR_EPS = 128, 0.8, 1e-30


class Adafactor(_Optimizer):
    """``optax.adafactor`` at its defaults over fp32 parameters, whole or
    FSDP shards (see the module docstring). Per parameter the state is the
    factored row and column moments (``v_row``, ``v_col``) or the full one
    (``v``)."""

    def __init__(self, params, schedule: Callable[[int], float], **transforms):
        super().__init__(params, schedule, **transforms)
        # chosen from the whole parameter's shape: a shard's may sort otherwise
        self.dims = [self._factored_dims(tuple(p.shape)) for p in self.params]
        self.v_row, self.v_col, self.v = [], [], []
        with torch.no_grad():
            local = self._tensors()
        for p, d in zip(local, self.dims):
            # the unused moments are (1,) zeros, as in optax's state
            without = (lambda axis: [s for i, s in enumerate(p.shape) if i != axis])
            self.v_row.append(p.new_zeros(without(d[1]) if d else (1,)))
            self.v_col.append(p.new_zeros(without(d[0]) if d else (1,)))
            self.v.append(p.new_zeros((1,)) if d else torch.zeros_like(p))

    @staticmethod
    def _factored_dims(shape) -> Optional[Tuple[int, int]]:
        """optax's choice: the second-largest and the largest axis, when
        the second largest has at least ADAFACTOR_MIN_DIM entries."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < ADAFACTOR_MIN_DIM:
            return None
        return int(order[-2]), int(order[-1])

    def _state_rows(self) -> Dict[str, List[bool]]:
        # v_row drops the largest axis, v_col the second largest
        return {"v_row": [s and d is not None and d[1] != 0
                          for s, d in zip(self.sharded, self.dims)],
                "v_col": [s and d is not None and d[0] != 0
                          for s, d in zip(self.sharded, self.dims)],
                "v": [s and d is None for s, d in zip(self.sharded, self.dims)]}

    def _mean(self, i: int, x: torch.Tensor, dim: int, rows: bool,
              keepdim: bool = False) -> torch.Tensor:
        """The mean of ``x`` over ``dim`` as optax takes it on the whole
        parameter ``i``; ``rows``: x's axis 0 is the parameter's axis 0,
        which this rank holds a shard of when the parameter is sharded."""
        if not (self.sharded[i] and rows and dim == 0):
            return x.mean(dim=dim, keepdim=keepdim)
        total = x.sum(dim=0, keepdim=keepdim)
        dist.all_reduce(total, group=self.group)
        return total / self.params[i].shape[0]

    def _rms(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The root mean square of the whole parameter-shaped ``x``."""
        if not self.sharded[i]:
            return x.square().mean().sqrt()
        total = x.square().sum()
        dist.all_reduce(total, group=self.group)
        return (total / self.params[i].numel()).sqrt()

    @torch.no_grad()
    def step(self) -> float:
        params = self._tensors()
        grads = self._grads()
        lr = self.schedule(self.count)
        f32 = np.float32
        # decay and 1 - decay in float32, as optax computes them
        decay32 = f32(1.0) - f32(self.count + 1) ** f32(-ADAFACTOR_DECAY)
        decay, rest = float(decay32), float(f32(1.0) - decay32)
        self.count += 1
        for i, (p, g, d) in enumerate(zip(params, grads, self.dims)):
            gsq = g * g + ADAFACTOR_EPS
            if d is None:
                self.v[i] = decay * self.v[i] + rest * gsq
                u = g * self.v[i] ** -0.5
            else:
                d1, d0 = d
                self.v_row[i] = decay * self.v_row[i] + rest * self._mean(i, gsq, d0, True)
                self.v_col[i] = decay * self.v_col[i] + rest * self._mean(i, gsq, d1, True)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = self._mean(i, self.v_row[i], reduced_d1, d0 != 0, keepdim=True)
                row_factor = (self.v_row[i] / row_col_mean) ** -0.5
                col_factor = self.v_col[i] ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            # clip_by_block_rms(1), the learning rate, scale_by_param_block_rms
            u = u / torch.clamp_min(self._rms(i, u), 1.0)
            u = u * lr * torch.clamp_min(self._rms(i, p), 1e-3)
            p.sub_(u)
        return lr

    def state_dict(self) -> Dict[str, object]:
        return {"count": self.count, "v_row": [t.clone() for t in self.v_row],
                "v_col": [t.clone() for t in self.v_col], "v": [t.clone() for t in self.v]}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        for key in ("v_row", "v_col", "v"):
            mine = getattr(self, key)
            if len(state[key]) != len(mine) or any(
                    a.shape != b.shape for a, b in zip(mine, state[key])):
                raise ValueError("optimizer state does not fit this parameter list")
            for dst, src in zip(mine, state[key]):
                dst.copy_(src)
        self.count = int(state["count"])


def build_optimizer(params, lr: float = 3e-5, weight_decay: float = 0.0,
                    betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
                    warmup_steps: int = 10, total_steps: int = 1_000_000,
                    decay_mode: str = "cosine", grad_scale: Optional[float] = None,
                    sd_keys_path: Optional[str] = None, grad_clip: Optional[float] = None,
                    optimizer: str = "adamw"):
    """AdamW (the reference recipe, train_t2v_enterance.py:203-225 +
    pretrain_functions.py:19-51) or Adafactor under ``annealing_lr``.

    ``params``: ``named_parameters()`` pairs (the key scale finds its
    parameters by name) or plain parameters. ``grad_scale`` other than 1
    multiplies the gradients of the SD-origin keys listed at
    ``sd_keys_path``; ``grad_clip`` clips by the global norm first."""
    kw = dict(grad_clip=grad_clip)
    if grad_scale is not None and grad_scale != 1.0:
        kw.update(grad_scale=float(grad_scale), scale_match=sd_key_matcher(
            resolve_sd_keys_path(grad_scale, sd_keys_path)))
    schedule = annealing_lr(lr, warmup_steps, total_steps, decay_mode)
    if optimizer == "adafactor":
        return Adafactor(params, schedule, **kw)
    if optimizer != "adamw":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return AdamW(params, schedule, betas=betas, eps=eps, weight_decay=weight_decay, **kw)
