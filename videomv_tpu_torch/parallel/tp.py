"""Tensor-parallel (Megatron-style) attention for serving, composed with
frame parallelism on a 2-D ``('sp', 'tp')`` mesh.

Port of ``videomv_tpu/parallel/tp.py``. The JAX package places the
attention projections head-sharded and GSPMD propagates the layout; here
``place_params_tp`` cuts each attention module's weights in place to this
rank's heads:

- ``to_q`` / ``to_k`` / ``to_v`` by columns (their output features, which
  are ``heads × head_dim``): the rank attends over its own heads, with no
  collective (kernel 1 runs on the local heads);
- ``to_out.0`` by rows (its input features): each rank's product is a
  partial sum, and one ``all_reduce`` over the tp group adds them before the
  bias, which every rank keeps whole.

Everything else stays replicated, the GEGLU FFN included (its value and gate
halves would split across ranks). A module is sharded only when its head
count divides by tp (the head gate of ``tp_shardings``): the T2V levels have
5, 10 and 20 heads of 64, so level 0 stays replicated at tp = 2.

Attention modules are found by their projections' names (``to_q``,
``to_k``, ``to_v``, ``to_out``), as the JAX placement finds its leaves.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .mesh import world_size

__all__ = ["place_params_tp", "tensor_parallel_mesh", "tp_shardings"]

logger = logging.getLogger(__name__)


def tensor_parallel_mesh(num_heads: int, tp: Optional[int] = None, sp: int = 1,
                         n_devices: Optional[int] = None, device_type: str = "cpu"
                         ) -> Optional[DeviceMesh]:
    """A 2-D ``('sp', 'tp')`` mesh over the first ``sp·tp`` ranks. ``tp``
    must divide ``num_heads``; when omitted, the largest divisor of it that
    fits the ranks left after ``sp`` is taken. None when only one rank would
    take part."""
    avail = world_size() if n_devices is None else min(n_devices, world_size())
    budget = avail // max(sp, 1)
    if tp is None:
        tp = max((d for d in range(1, budget + 1) if num_heads % d == 0), default=1)
    if num_heads % tp != 0:
        raise ValueError(f"tp={tp} must divide num_heads={num_heads}")
    if sp * tp > avail:
        raise ValueError(f"sp*tp = {sp}*{tp} exceeds {avail} devices")
    if tp == 1 and sp == 1:
        return None
    return DeviceMesh(device_type, torch.arange(sp * tp).reshape(sp, tp),
                      mesh_dim_names=("sp", "tp"))


def _attention_modules(module: nn.Module):
    for name, m in module.named_modules():
        if all(hasattr(m, a) for a in ("to_q", "to_k", "to_v", "to_out", "heads")):
            yield name, m


def _gate(dim: int, n: int, head_dim: Optional[int]) -> bool:
    """JAX ``tp_shardings``'s head gate: ``dim`` splits ``n`` ways into
    whole heads (with ``head_dim`` given), else ``dim`` divides by ``n``."""
    if dim % n != 0:
        return False
    if head_dim is None:
        return True
    # a dim that floor-divides to a tp-divisible head count but is no exact
    # head multiple (160 at head_dim 64, tp 2) would shard mid-head
    return dim % head_dim == 0 and (dim // head_dim) % n == 0


def tp_shardings(module: nn.Module, tp: int, head_dim: Optional[int] = None
                 ) -> Dict[str, str]:
    """The placement of every attention projection weight of ``module`` by
    parameter name: ``"column"`` (to_q / to_k / to_v, split over their
    output features), ``"row"`` (to_out.0, split over its input features)
    or ``"replicated"`` (the head gate fails)."""
    out = {}
    for name, m in _attention_modules(module):
        prefix = f"{name}." if name else ""
        for proj in ("to_q", "to_k", "to_v"):
            w = getattr(m, proj).weight
            ok = _gate(w.shape[0], tp, head_dim)
            out[f"{prefix}{proj}.weight"] = "column" if ok else "replicated"
        w = m.to_out[0].weight
        out[f"{prefix}to_out.0.weight"] = "row" if _gate(w.shape[1], tp, head_dim) else "replicated"
    return out


def place_params_tp(mesh: DeviceMesh, module: nn.Module, head_dim: Optional[int] = None,
                    axis: str = "tp") -> int:
    """Cut ``module``'s attention weights in place to this rank's heads per
    ``tp_shardings`` (a module is sharded whole or not at all) and give each
    sharded module the tp group; returns how many modules were sharded. Call
    it on every rank of the mesh, with the same weights on each."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    placement = tp_shardings(module, n, head_dim)
    done = 0
    with torch.no_grad():
        for name, m in _attention_modules(module):
            prefix = f"{name}." if name else ""
            kinds = {placement[f"{prefix}{p}.weight"] for p in ("to_q", "to_k", "to_v")}
            kinds.add(placement[f"{prefix}to_out.0.weight"])
            if kinds != {"column", "row"}:
                logger.warning("tp: %s (%d heads) fails the %d-way head gate — replicated",
                               name, m.heads, n)
                continue
            for proj in ("to_q", "to_k", "to_v"):
                lin = getattr(m, proj)
                k = lin.weight.shape[0] // n
                lin.weight = nn.Parameter(lin.weight[r * k:(r + 1) * k].clone(),
                                          requires_grad=lin.weight.requires_grad)
                lin.out_features = k
            out = m.to_out[0]
            k = out.weight.shape[1] // n
            out.weight = nn.Parameter(out.weight[:, r * k:(r + 1) * k].clone(),
                                      requires_grad=out.weight.requires_grad)
            out.in_features = k
            m.heads //= n
            m.tp_group = group
            done += 1
    return done
