"""Frame-sharded (sequence-parallel) inference: one sample's frames over
several devices.

Port of ``videomv_tpu/parallel/infer.py``. Spatial blocks and everything
per frame (convolutions, spatial attention, the camera embedding, the VAE)
run on a rank's own frames unchanged; the temporal blocks need every frame
and take the token layout through an all-to-all (``collectives``). In the
JAX package GSPMD inserts those collectives from the placement of the
inputs; here the UNet's temporal blocks insert them while a ``FrameShard``
is current (``frame_sharded``), and the caller hands each rank its block of
frames (the noise, the cameras) and gathers the result.

Frames shard in contiguous blocks: rank ``r`` of ``n`` holds frames
``[r·F/n, (r+1)·F/n)``, as ``NamedSharding(P(..., 'sp'))`` places them.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import logging
from typing import Iterator, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from . import collectives
from .mesh import world_size

__all__ = ["FrameShard", "current_frame_shard", "frame_parallel_mesh", "frame_sharded",
           "in_mesh", "replicate_params", "shard_on_axis"]

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class FrameShard:
    """This rank's part of a frame-sharded sample: rank ``index`` of the
    ``size`` ranks of ``group`` holds frames ``start .. start + local`` of
    ``frames``."""

    group: object
    size: int
    index: int
    frames: int

    @classmethod
    def of(cls, mesh: DeviceMesh, frames: int, axis: str = "sp") -> "FrameShard":
        n = mesh.size(mesh.mesh_dim_names.index(axis))
        if frames % n:
            raise ValueError(f"{frames} frames do not divide over {n} devices")
        return cls(mesh.get_group(axis), n, mesh.get_local_rank(axis), frames)

    @property
    def local(self) -> int:
        return self.frames // self.size

    @property
    def start(self) -> int:
        return self.index * self.local

    def frames_to_tokens(self, x: torch.Tensor) -> torch.Tensor:
        return collectives.frames_to_tokens(x, self.group, self.size, self.index)

    def tokens_to_frames(self, x: torch.Tensor, hw) -> torch.Tensor:
        return collectives.tokens_to_frames(x, self.group, self.size, self.index, hw)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's frames of ``x`` (frames on ``dim``), in frame order."""
        return collectives.all_gather_cat(x, self.group, dim)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("frame_shard", default=None)


@contextlib.contextmanager
def frame_sharded(shard: Optional[FrameShard]) -> Iterator[None]:
    """Within ``with``, the UNets' temporal blocks treat their input as
    ``shard``'s block of frames (None: the whole sample)."""
    token = _CURRENT.set(shard)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current_frame_shard() -> Optional[FrameShard]:
    return _CURRENT.get()


def frame_parallel_mesh(num_frames: int, n_devices: Optional[int] = None,
                        device_type: str = "cpu") -> Optional[DeviceMesh]:
    """The largest usable ``('sp',)`` mesh: the most ranks (at most
    ``n_devices`` when given) whose count divides ``num_frames``, the first
    ones of the world. None when only one would take part. Every rank calls
    it; ranks outside the mesh wait for the result."""
    avail = world_size() if n_devices is None else min(n_devices, world_size())
    n = max(d for d in range(1, avail + 1) if num_frames % d == 0)
    if n < avail:
        logger.warning("frame_parallel: %d frames not divisible by %d devices — using %d",
                       num_frames, avail, n)
    if n == 1:
        return None
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=("sp",))


def shard_on_axis(mesh: DeviceMesh, x: torch.Tensor, dim: int, axis: str = "sp"
                  ) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over the mesh's ``axis``."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {n} devices")
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k)


def replicate_params(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank (in place): the
    weights live everywhere, the activations are what shard."""
    from .mesh import replicate

    if world_size() > 1:
        replicate(list(module.parameters()) + list(module.buffers()), src)


def in_mesh(mesh: Optional[DeviceMesh]) -> bool:
    """Whether this rank takes part in ``mesh``."""
    return mesh is not None and mesh.get_coordinate() is not None
