"""Process groups, the data mesh and its placements: one process per device.

Port of ``videomv_tpu/parallel/mesh.py``. The JAX package runs one process
per host and lets GSPMD place a global batch over a ``Mesh``; here every
device has its own process (``torchrun``, or ``spawn`` below), a rank holds
its own rows, and the collectives are written out:

  ``jax.distributed.initialize``  → ``init_distributed`` (NCCL on
                                     ``cuda:LOCAL_RANK``, gloo on the CPU)
  1-D ``Mesh(('dp',))``           → ``make_mesh``: a ``DeviceMesh``
  ``shard_batch``                 → this rank's rows of the global batch
  ``replicate``                   → a broadcast from rank 0
  ``fsdp_shardings``              → ``apply_fsdp``: FSDP2 ``fully_shard``

A single process with none of ``torchrun``'s variables and no rendezvous is a
world of one and creates no process group.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .collectives import broadcast

__all__ = ["apply_fsdp", "init_distributed", "local_device", "make_mesh", "replicate",
           "shard_batch", "spawn", "world_size"]

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600.0


def world_size() -> int:
    """Processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(device: torch.device, init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join the default process group; returns this process's rank.

    The backend follows ``device``: NCCL for a CUDA device (the process then
    runs on ``cuda:LOCAL_RANK``; pass that device), gloo for the CPU. The
    rendezvous is ``init_method`` with ``rank`` and ``world_size`` when
    given (the tests pass a ``file://`` path), else ``env://`` when
    ``torchrun``'s variables are set. Without either the process is a world
    of one and no group is created. A failed rendezvous raises (nothing
    falls back to one process), and the backend and device are never
    changed here. Calling it again in a process that has joined returns the
    rank."""
    if dist.is_initialized():
        return dist.get_rank()
    device = torch.device(device)
    if init_method is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return 0
        init_method = "env://"
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw: Dict[str, Any] = {}
    if backend == "nccl":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    logger.info("rank %d of %d on %s (%s)", dist.get_rank(), dist.get_world_size(), device,
                backend)
    return dist.get_rank()


def local_device(name: str = "cuda") -> torch.device:
    """The device of this process: ``cuda:LOCAL_RANK`` under ``torchrun``
    when ``name`` is ``cuda``, else ``name`` as given."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def make_mesh(n_devices: Optional[int] = None, device_type: str = "cpu") -> DeviceMesh:
    """A 1-D ``('dp',)`` ``DeviceMesh`` over the first ``n_devices`` ranks
    (all of them by default). Every rank calls it, members or not."""
    n = world_size() if n_devices is None else n_devices
    if n > world_size():
        raise ValueError(f"a mesh of {n} devices in a world of {world_size()}")
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=("dp",))


def shard_batch(mesh: Optional[DeviceMesh], batch, axis: str = "dp"):
    """This rank's rows of ``batch``: the ``r``-th of ``n`` equal blocks of
    every array, tensor and list in it (nested dicts included; rows on the
    leading axis; scalars pass through). A batch whose rows do not divide by
    ``n`` raises, as the JAX placement does. ``mesh=None`` returns
    ``batch``."""
    if mesh is None:
        return batch
    n, r = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)

    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if not isinstance(x, (list, tuple)) and getattr(x, "ndim", 0) == 0:
            return x
        if len(x) % n:
            raise ValueError(f"a batch of {len(x)} rows does not divide over {n} devices")
        k = len(x) // n
        return x[r * k:(r + 1) * k]

    return rows(batch)


def replicate(tensors: Iterable[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite ``tensors`` (in place) on every rank with rank ``src``'s."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in tensors:
            broadcast(t.data, src, group)


def apply_fsdp(units: Sequence[nn.Module], mesh: DeviceMesh, min_size: int = 1 << 16) -> int:
    """Shard the parameters of ``units`` over ``mesh`` with FSDP2
    ``fully_shard``, one unit at a time; returns how many units it sharded.

    A unit is a module the model calls as a whole (a UNet block: its
    ``fsdp_units()``), so its parameters are all-gathered in its forward and
    recomputation and its gradients reduce-scattered (averaged) after its
    backward. Parameters of fewer than ``min_size`` entries stay replicated
    (``ignored_params``), as do the parameters of no unit: they remain plain
    tensors, whose gradients the train step all-reduces. FSDP2 shards a
    parameter's dim 0 where the JAX placement (``fsdp_shardings``) shards its
    earliest divisible dim: the values each rank keeps differ, the gathered
    parameter and every result are the same."""
    from torch.distributed.fsdp import fully_shard

    done = 0
    for unit in units:
        params = list(unit.parameters())
        small = {p for p in params if p.numel() < min_size}
        if len(small) < len(params):
            fully_shard(unit, mesh=mesh, reshard_after_forward=True, ignored_params=small)
            done += 1
    return done


# ------------------------------------------------------------------ spawn


def _rank_main(fn: Callable, r: int, n: int, init_file: str, timeout_s: float, args: tuple,
               results) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=r, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout_s))
        results.put((r, True, fn(r, n, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((r, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, init_file: Optional[str] = None,
          deadline_s: float = 300.0, args: tuple = ()) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    (the ``spawn`` start method) joined in one gloo process group over a
    ``file://`` rendezvous at ``init_file`` (which must not exist yet);
    returns each rank's result in rank order. ``fn`` and its results are
    pickled: ``fn`` is a module-level function of a module the workers can
    import. Each rank runs with one thread; its tensors may lie on the CPU
    or on a card, as gloo takes both.

    A rank that raises makes ``spawn`` raise with its traceback; when
    ``deadline_s`` passes first, every rank is killed and ``TimeoutError``
    raised. The group's own timeout is ``deadline_s`` too, so a collective
    that waits on a dead rank ends."""
    if init_file is None or os.path.exists(init_file):
        raise ValueError(f"spawn needs a fresh rendezvous file, got {init_file!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, init_file, deadline_s, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    end = time.monotonic() + deadline_s
    done = False
    try:
        while len(got) < world_size:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {world_size - len(got)} of {world_size} ranks did "
                                   f"not finish within {deadline_s} s")
            try:
                r, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if i not in got and p.exitcode not in
                        (None, 0)]
                if dead:
                    raise RuntimeError(f"spawn: rank(s) {dead} died with exit codes "
                                       f"{[procs[i].exitcode for i in dead]}")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {r} failed:\n{out}")
            got[r] = out
        done = True
    finally:
        if done:  # every rank reported: let them leave the group
            for p in procs:
                p.join(timeout=max(1.0, min(30.0, end - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
    return [got[r] for r in range(world_size)]
