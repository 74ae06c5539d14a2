"""The control of the serving cells: the reference computed one precision
below the configuration's bf16, in fp8 (e4m3, one scale per tensor), and
put in the program's place.

Every weight of rank ≥ 2 is rounded to fp8 once, and every input of a
linear or convolution layer (and of the text and visual towers' packed
attention projection) on each call; the products then run in fp32 on the
rounded values. ``ProgramFacing`` gives the reference models the calling
convention of the program's modules, so a pipeline can take them in place
of its own."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from . import nets

FP8_MAX = 448.0


def q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in x's dtype."""
    s = FP8_MAX / x.detach().abs().amax().float().clamp_min(1e-12)
    return ((x.float() * s).to(torch.float8_e4m3fn).float() / s).to(x.dtype)


def _round_input(module, args):
    return (q8(args[0]),) + tuple(args[1:])


def fp8_models(models: Dict[str, nn.Module]) -> Dict[str, nn.Module]:
    """Round the models' weights to fp8 in place and hook their layers'
    inputs; returns the same dict."""
    for m in models.values():
        with torch.no_grad():
            for p in m.parameters():
                if p.dim() >= 2:
                    p.copy_(q8(p))
        for mod in m.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nets.CLIPAttention)):
                mod.register_forward_pre_hook(_round_input)
    return models


class _Clip(nn.Module):
    def __init__(self, clip):
        super().__init__()
        self.inner = clip

    def encode_text(self, tokens):
        return None, self.inner.encode_text(tokens)

    def encode_image(self, images):
        return self.inner.visual(images)


class _Vae(nn.Module):
    def __init__(self, vae):
        super().__init__()
        self.inner = vae

    def decode(self, z):
        return self.inner.decode(z)

    def encode_first_stage(self, x, scale_factor: float = 1.0):
        return scale_factor * self.inner.encode_mode(x)


def program_facing(models: Dict[str, nn.Module]) -> Dict[str, nn.Module]:
    """The reference models under the program's module interfaces
    (``unet``, ``vae``, ``clip``, ``lgm`` as the pipelines call them)."""
    out = dict(models)
    out["clip"], out["vae"] = _Clip(models["clip"]), _Vae(models["vae"])
    return out
