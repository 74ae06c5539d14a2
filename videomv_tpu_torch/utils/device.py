"""The device rule of the port's entry points: they run on the card."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(name: str = "cuda") -> torch.device:
    """``name`` as a ``torch.device``. A CUDA device that is not there is an
    error, never a silent move to the CPU: the CPU is used only when the
    caller names it."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"device {name!r} requested but torch.cuda.is_available() is False: the entry "
            "points of videomv_tpu_torch run on a CUDA device; pass --device cpu to run on "
            "the CPU")
    return device
