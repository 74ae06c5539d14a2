"""Seeded weights, made on the device in a few large draws.

Each model's state dict is cut from one normal draw of a ``torch.Generator``
on the device, in the dtype the model is served in: tensors of rank ≥ 2
scaled by fan_in^-½, 1-D ``weight``s (norm scales) 1 + 0.1·n, other 1-D
tensors 0.1·n. No layer is zeroed, so every path of every model acts. The
same seed gives the same values on every call; the program and the
reference load the same values (the reference upcast to fp32).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, Tuple

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for ``tag`` from the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def seeded_state_dict(shapes: Iterable[Tuple[str, torch.Size]], seed: int, tag: str,
                      device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``(name, shape)`` pairs, from one draw."""
    shapes = list(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, tag))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if len(shape) >= 2:
            t.mul_(math.prod(shape[1:]) ** -0.5)
        elif name.endswith("weight"):
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.1)
        out[name] = t
    return out


def maker(seed: int, device, config: dict):
    """``make(shapes)`` → the seed's state dicts ``{model: {name: tensor}}``
    for ``{model: [(name, shape)]}``, in the dtype the configuration serves."""
    sd = str(config["pipeline"].get("sampling_dtype", "")).lower()
    dtype = torch.float32 if sd in ("float32", "fp32", "f32") else torch.bfloat16

    def make(shapes):
        return {n: seeded_state_dict(s, seed, n, device, dtype) for n, s in shapes.items()}
    return make
