"""The collectives of the port's multi-device paths, written where the JAX
package's layouts make GSPMD insert one.

One process drives one device, and every function here takes the process
group it runs over: NCCL on the card, gloo on the CPU. gloo also runs every
collective used here on CUDA tensors (two ranks that share one card cannot
use NCCL, which refuses two ranks on one device), so nothing is staged
through host memory.

Beside the plain collectives:

- ``frames_to_tokens`` / ``tokens_to_frames``: the all-to-all between a
  frame-sharded activation ``[B, C, F/n, H, W]`` and the token-sharded one
  ``[B, C, F, T_r]`` that a temporal block needs (every frame of this rank's
  ``T_r`` of the ``H·W`` tokens). ``H·W`` need not divide by ``n`` (16
  tokens at the deepest level over 3 ranks): the first ``H·W mod n`` ranks
  hold one token more (``token_splits``);
- ``group_norm``: a GroupNorm whose statistics span every rank of the group,
  from one all-reduce of the fp32 sum, sum of squares and count per (row,
  group).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..ops.group_norm import count_plain

__all__ = ["all_gather_cat", "all_reduce", "all_to_all", "broadcast", "frames_to_tokens",
           "group_norm", "token_splits", "tokens_to_frames"]


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    """A bfloat16 tensor viewed as float16 (the same two bytes), for the
    collectives that only move data: gloo takes float16 on CUDA tensors and
    neither bfloat16 nor int16 (torch 2.11: "Invalid scalar type")."""
    return t.view(torch.float16) if t.dtype == torch.bfloat16 else t


def all_reduce(tensor: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``tensor`` over ``group``; returns it."""
    dist.all_reduce(tensor, op=op, group=group)
    return tensor


def broadcast(tensor: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In-place broadcast from global rank ``src``; returns ``tensor``."""
    dist.broadcast(tensor, src, group=group)
    return tensor


def all_gather_cat(tensor: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes), concatenated along ``dim`` in
    group rank order."""
    src = _as_bits(tensor.contiguous())
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).view(tensor.dtype)


def all_to_all(output: torch.Tensor, inp: torch.Tensor, output_splits: Sequence[int],
               input_splits: Sequence[int], group=None) -> torch.Tensor:
    """``all_to_all_single`` along dim 0 with the given split sizes; fills
    and returns ``output``."""
    dist.all_to_all_single(_as_bits(output), _as_bits(inp.contiguous()), list(output_splits),
                           list(input_splits), group=group)
    return output


def token_splits(tokens: int, n: int) -> List[int]:
    """How many of ``tokens`` each of ``n`` ranks holds: the first
    ``tokens mod n`` one more than the others."""
    base, rem = divmod(tokens, n)
    return [base + (r < rem) for r in range(n)]


def frames_to_tokens(x: torch.Tensor, group, n: int, rank: int) -> torch.Tensor:
    """``[B, C, F/n, H, W]`` (this rank's block of frames) → ``[B, C, F, T_r]``
    (every frame of this rank's tokens, in row-major ``H·W`` order)."""
    b, c, fl, hh, ww = x.shape
    splits = token_splits(hh * ww, n)
    mine = splits[rank]
    inp = x.reshape(b, c, fl, hh * ww).permute(3, 0, 1, 2).contiguous()  # [HW, B, C, F/n]
    out = inp.new_empty((n * mine, b, c, fl))
    all_to_all(out, inp, [mine] * n, splits, group)
    # block j holds rank j's frames of this rank's tokens
    return out.view(n, mine, b, c, fl).permute(2, 3, 0, 4, 1).reshape(b, c, n * fl, mine)


def tokens_to_frames(x: torch.Tensor, group, n: int, rank: int, hw) -> torch.Tensor:
    """The inverse of ``frames_to_tokens``: ``[B, C, F, T_r]`` → ``[B, C,
    F/n, H, W]`` for spatial size ``hw = (H, W)``."""
    b, c, f, mine = x.shape
    hh, ww = hw
    fl = f // n
    splits = token_splits(hh * ww, n)
    inp = x.reshape(b, c, n, fl, mine).permute(2, 4, 0, 1, 3).reshape(n * mine, b, c, fl)
    out = inp.new_empty((hh * ww, b, c, fl))
    all_to_all(out, inp, splits, [mine] * n, group)
    return out.permute(1, 2, 3, 0).reshape(b, c, fl, hh, ww)


def group_norm(norm: nn.GroupNorm, x: torch.Tensor, group: Optional[object] = None
               ) -> torch.Tensor:
    """``norm(x)`` with the statistics of each (row, channel group) taken
    over the elements that every rank of ``group`` holds of it (``x``'s dims
    after the channel), in plain PyTorch (a bf16 call counted in
    ``gn.plain``). ``group=None`` is ``norm(x)`` itself."""
    if group is None:
        return norm(x)
    count_plain(x)
    b, c = x.shape[:2]
    g = norm.num_groups
    xf = x.reshape(b, g, -1).float()
    count = torch.full((b, g), float(xf.shape[-1]), device=x.device)
    stats = all_reduce(torch.stack([xf.sum(-1), xf.square().sum(-1), count]), group)
    mean = stats[0] / stats[2]
    var = (stats[1] / stats[2] - mean.square()).clamp_min(0.0)
    y = ((xf - mean[..., None]) * torch.rsqrt(var + norm.eps)[..., None]).reshape(x.shape)
    if norm.affine:
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = y * norm.weight.float().reshape(shape) + norm.bias.float().reshape(shape)
    return y.to(x.dtype)
