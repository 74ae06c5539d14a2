"""The diffusion training step of the UNet finetune, on one device or
data-parallel over a 1-D ``('dp',)`` mesh.

Port of ``videomv_tpu/parallel/train_step.py`` (the reference train-loop
core, train_t2v_enterance.py:237-323): draw t, the noise and the
classifier-free drop; replace the dropped rows' text by the negative-prompt
embedding ``zero_y``; the diffusion loss of the denoiser; backward; the
optimizer; the EMA lerp. The denoiser comes in through an apply function,
so one step serves T2V (``make_t2v_apply``: text and camera) and I2V
(``make_i2v_apply``: also the reference frame). Against the JAX step:

  jitted, donated step over a mesh    → an eager step on one device
  fp32 params, bf16 module dtype      → fp32 master parameters under bf16
                                        autocast (``autocast_dtype``)
  optax chain                         → ``training.optim`` (AdamW or
                                        Adafactor, the key scale, the clip)
  EMA tree_map                        → ``torch._foreach`` mul / add
  ``jax.random`` keys per step        → one explicit ``torch.Generator``

Every random draw of a step comes from the caller's generator: t, the noise
and the drop (``draw_train_randoms``), then the dropout masks, which run on
the device's default generator seeded with the explicit generator's state
and hand the advanced state back to it. ``draws=`` replays another
framework's t, noise and drop. The step reads nothing back to the host: its
loss is returned as a device tensor.

Data-parallel (``mesh=``): each rank holds its rows of the global batch.
Every rank draws the global batch's t, noise and drop from the step's
generator (the same on every rank) and keeps its own rows, so the step is
the one-device step on the global batch, as the JAX package's sharded step
is. The gradients are averaged over the ranks: the replicated ones by one
bucketed ``all_reduce``, the FSDP-sharded ones by FSDP's reduce-scatter;
the loss returned is the global mean, and the optimizer and the EMA then run
alike on every rank (on its shards under FSDP). Each rank's dropout masks
come from a generator seeded from the step's generator, the step count and
the rank, so no two ranks draw the same masks; on one rank the dropout runs
from the step's generator as on one device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor

from ..training.optim import local_tensor
from .collectives import all_reduce

__all__ = ["TrainDraws", "TrainState", "build_train_step", "draw_train_randoms", "make_i2v_apply",
           "make_t2v_apply"]

ApplyFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]],
                   torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """What a step changes: the step count, the UNet (fp32 master
    parameters), its optimizer and, with EMA on, one fp32 tensor per UNet
    parameter in ``parameters()`` order."""

    step: int
    unet: torch.nn.Module
    optimizer: object
    ema: Optional[List[torch.Tensor]] = None


@dataclasses.dataclass
class TrainDraws:
    """The random draws of one step, on the batch's device."""

    t: torch.Tensor      # [B] int64 timesteps
    noise: torch.Tensor  # like the latents
    drop: torch.Tensor   # [B] bool: the row's text is replaced by zero_y


def draw_train_randoms(generator: torch.Generator, latents: torch.Tensor, diffusion,
                       p_zero: float, rows: Optional[int] = None) -> TrainDraws:
    """One step's draws from ``generator`` (on the latents' device), for
    ``rows`` rows shaped like ``latents`` (default: its own rows)."""
    b = latents.shape[0] if rows is None else rows
    dev = latents.device
    t = torch.randint(0, diffusion.num_timesteps, (b,), generator=generator, device=dev)
    noise = diffusion.sample_noise(latents.new_empty((b,) + tuple(latents.shape[1:])),
                                   generator)
    drop = torch.rand((b,), generator=generator, device=dev) < p_zero
    return TrainDraws(t, noise, drop)


def rank_rows(draws: TrainDraws, n: int, r: int) -> TrainDraws:
    """Rank ``r``'s block of rows of the global batch's draws."""
    k = draws.t.shape[0] // n
    sl = slice(r * k, (r + 1) * k)
    return TrainDraws(draws.t[sl], draws.noise[sl], draws.drop[sl])


# the most gradient bytes one all-reduce of sync_grads carries
GRAD_BUCKET_BYTES = 1 << 28


def rank_generator(generator: torch.Generator, step: int, rank: int) -> torch.Generator:
    """A generator for rank ``rank``'s dropout masks at ``step``: seeded
    from ``generator``'s seed, the step and the rank, on its device."""
    seed = ((generator.initial_seed() * 1_000_003 + step) * 65_537 + rank) % (1 << 63)
    return torch.Generator(device=generator.device).manual_seed(seed)


def sync_grads(params, group, n: int) -> None:
    """Average the gradients of ``params`` that are not FSDP-sharded over the
    ``n`` ranks of ``group``, in buckets of at most ``GRAD_BUCKET_BYTES`` (one
    ``all_reduce`` each). Sharded gradients are FSDP's (already averaged)."""
    grads = [p.grad for p in params if p.grad is not None and not isinstance(p.grad, DTensor)]
    bucket, size = [], 0
    for i, g in enumerate(grads):
        bucket.append(g)
        size += g.numel() * g.element_size()
        if size >= GRAD_BUCKET_BYTES or i == len(grads) - 1:
            flat = all_reduce(torch.cat([x.reshape(-1) for x in bucket]), group).div_(n)
            offset = 0
            for x in bucket:
                x.copy_(flat[offset:offset + x.numel()].view_as(x))
                offset += x.numel()
            bucket, size = [], 0


def make_t2v_apply(unet: torch.nn.Module) -> ApplyFn:
    """Text + camera conditioning (train_t2v_enterance.py:286-296); the
    module's train/eval mode decides dropout."""

    def apply_fn(xt, t, y, batch):
        return unet(xt, t, y=y, camera_data=batch.get("camera_data"))

    return apply_fn


def make_i2v_apply(unet: torch.nn.Module) -> ApplyFn:
    """I2V conditioning: the T2V conditioning plus the reference frame's
    latent (``batch["local_image"]``) and its CLIP image embedding
    (``batch["image_embed"]``); no fps is passed, so the UNet's default of 8
    applies (train_i2v_enterance.py local_image path)."""

    def apply_fn(xt, t, y, batch):
        return unet(xt, t, y=y, camera_data=batch.get("camera_data"),
                    local_image=batch["local_image"], image=batch.get("image_embed"))

    return apply_fn


@contextlib.contextmanager
def _dropout_stream(generator: Optional[torch.Generator]):
    """Within ``with``, the default generator of ``generator``'s device runs
    from ``generator``'s state (dropout draws from the default generator);
    on exit ``generator`` takes the advanced state and the default one is
    restored. Both states live on the host: nothing syncs."""
    if generator is None:
        yield
        return
    dev = generator.device
    cuda = dev.type == "cuda"
    with torch.random.fork_rng(devices=[dev] if cuda else [], device_type=dev.type):
        default = (torch.cuda.default_generators[dev.index if dev.index is not None
                                                 else torch.cuda.current_device()]
                   if cuda else torch.default_generator)
        default.set_state(generator.get_state())
        try:
            yield
        finally:
            generator.set_state(default.get_state())


def build_train_step(apply_fn: ApplyFn, diffusion, ema_decay: float = 0.9999,
                     use_ema: bool = True, p_zero: float = 0.1,
                     zero_y: Optional[torch.Tensor] = None,
                     autocast_dtype: Optional[torch.dtype] = None, mesh=None):
    """Create ``train_step(state, batch, generator=None, draws=None) ->
    loss`` (a 0-d device tensor); ``train_step.loss_fn(batch, draws)`` is the
    loss alone (of the rows it is given).

    ``mesh``: the 1-D data mesh (``parallel.mesh.make_mesh``) for the
    data-parallel step: ``batch`` holds this rank's rows, ``draws`` (when
    given) are the global batch's, and the loss returned is the global mean.

    batch: ``latents`` [B, 4, F, h, w] (the frozen VAE's encode),
    ``y_words`` [B, L, ctx], optional ``camera_data`` [B, F, 16], and for
    ``make_i2v_apply`` ``local_image`` [B, 4, 1, h, w] and ``image_embed``
    [B, y_dim]. ``zero_y``
    [1, L, ctx] is the negative prompt's embedding that dropped rows take
    (reference ``zero_y_negative``, train_t2v_enterance.py:173-175,274), or
    zeros when None. ``autocast_dtype`` (bf16 on the card) runs the denoiser
    under autocast over its fp32 parameters."""

    def loss_fn(batch: Dict[str, torch.Tensor], draws: TrainDraws) -> torch.Tensor:
        latents, y = batch["latents"], batch["y_words"]
        uncond = (torch.zeros((), dtype=y.dtype, device=y.device) if zero_y is None
                  else zero_y.to(y.dtype))
        y = torch.where(draws.drop[:, None, None], uncond, y)

        def model_fn(xt, t):
            if autocast_dtype is None:
                return apply_fn(xt, t, y, batch)
            with torch.autocast(device_type=xt.device.type, dtype=autocast_dtype):
                return apply_fn(xt, t, y, batch)

        loss_vec, _ = diffusion.loss(model_fn, latents, draws.t, noise=draws.noise)
        return loss_vec.mean()

    n = 1 if mesh is None else mesh.size()
    r = 0 if mesh is None else mesh.get_local_rank()
    group = None if mesh is None else mesh.get_group()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[TrainDraws] = None) -> torch.Tensor:
        if draws is None:
            if generator is None:
                raise ValueError("train_step needs a generator or the step's draws")
            draws = draw_train_randoms(generator, batch["latents"], diffusion, p_zero,
                                       rows=n * batch["latents"].shape[0])
        if n > 1:
            draws = rank_rows(draws, n, r)
        dropout_gen = (rank_generator(generator, state.step, r)
                       if n > 1 and generator is not None else generator)
        state.optimizer.zero_grad()
        with _dropout_stream(dropout_gen):
            loss = loss_fn(batch, draws)
            loss.backward()
        loss = loss.detach()
        if n > 1:
            sync_grads(state.unet.parameters(), group, n)
            loss = all_reduce(loss.clone(), group).div_(n)
        state.optimizer.step()
        if use_ema and state.ema is not None:
            with torch.no_grad():
                params = [local_tensor(p.detach()) for p in state.unet.parameters()]
                torch._foreach_mul_(state.ema, ema_decay)
                torch._foreach_add_(state.ema, params, alpha=1.0 - ema_decay)
        state.step += 1
        return loss

    train_step.loss_fn = loss_fn
    return train_step
