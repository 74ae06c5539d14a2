"""LGM, the feed-forward Gaussian-splat reconstructor, as PyTorch modules
(NCHW).

Port of ``videomv_tpu/models/lgm.py`` (reference core/models.py +
core/unet.py). An asymmetric UNet takes V = 4 views of 9-channel input
(RGB + 6 Plücker ray channels) at ``input_size``², runs cross-view
``MVAttention`` at the deep levels and emits 14 Gaussian parameters per
pixel at ``splat_size``², activated into (pos, opacity, scale, rotation,
rgb) Gaussians.

Module paths are the released keys (``unet.down_blocks.0.nets.0.norm1``,
``unet.down_blocks.3.attns.0.attn.qkv``, ``unet.mid_block.nets.0``,
``unet.up_blocks.0.upsample``, ``conv``), so ``model.safetensors`` and the
``lgm_big.*`` subtree of a UNet checkpoint load directly. Kept from the
reference: GroupNorm of 32 groups with eps 1e-5, 16 heads with qkv split
``[3, heads, head_dim]``, the skip scale √½, the asymmetric skip selection
of the up path, and the rotation normalised over dim 1 (across all N
Gaussians, the reference's bare ``F.normalize``). Attention goes through
``ops.dot_product_attention``, so its long self-attention takes the CUDA
flash kernel under the JAX package's gate (head_dim 64 at 16² and 8²;
head_dim 32 at 32² stays plain). Inference only: no rematerialisation.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention

__all__ = ["LGM", "LGMOptions", "LGMResnetBlock", "LGMUNet", "MVAttention"]


@dataclasses.dataclass(frozen=True)
class LGMOptions:
    """Geometry and architecture options (reference core/options.py; the
    defaults are the 'big' variant VideoMV uses)."""

    input_size: int = 256
    down_channels: Tuple[int, ...] = (64, 128, 256, 512, 1024, 1024)
    down_attention: Tuple[bool, ...] = (False, False, False, True, True, True)
    mid_attention: bool = True
    up_channels: Tuple[int, ...] = (1024, 1024, 512, 256, 128)
    up_attention: Tuple[bool, ...] = (True, True, True, False, False)
    splat_size: int = 128
    output_size: int = 512
    fovy: float = 39.6
    znear: float = 0.5
    zfar: float = 2.5
    num_views: int = 8
    num_input_views: int = 4
    cam_radius: float = 1.5
    lambda_lpips: float = 1.0

    @classmethod
    def big(cls) -> "LGMOptions":
        return cls()

    @classmethod
    def small(cls) -> "LGMOptions":
        return cls(up_channels=(1024, 1024, 512, 256), up_attention=(True, True, True, False),
                   splat_size=64, output_size=256)

    @classmethod
    def tiny(cls) -> "LGMOptions":
        return cls(down_channels=(32, 64, 128, 256), down_attention=(False, False, False, True),
                   up_channels=(256, 128, 64), up_attention=(True, False, False),
                   splat_size=128, output_size=256)


def _gn(c: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, c, eps=1e-5)


class _QKV(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)


class MVAttention(nn.Module):
    """Cross-view attention: the V·H·W pixels of a scene's views form one
    token axis, so every view attends to every other."""

    def __init__(self, dim: int, num_heads: int = 16, num_frames: int = 4,
                 skip_scale: float = 1.0):
        super().__init__()
        self.num_heads, self.num_frames, self.skip_scale = num_heads, num_frames, skip_scale
        self.norm = _gn(dim)
        self.attn = _QKV(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B·V, C, H, W]
        bv, c, hh, ww = x.shape
        b = bv // self.num_frames
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, self.num_frames * hh * ww, c)
        s, hd = h.shape[1], c // self.num_heads
        q, k, v = (t.reshape(b, s, self.num_heads, hd).contiguous()
                   for t in self.attn.qkv(h).split(c, dim=-1))
        o = self.attn.proj(dot_product_attention(q, k, v).reshape(b, s, c))
        o = o.reshape(bv, hh, ww, c).permute(0, 3, 1, 2)
        return (o + x) * self.skip_scale


class LGMResnetBlock(nn.Module):
    """GN → SiLU → conv, twice, with a 1×1 shortcut when the width changes
    (the UNet uses no resampling inside the block)."""

    def __init__(self, in_channels: int, out_channels: int, skip_scale: float = 1.0):
        super().__init__()
        self.skip_scale = skip_scale
        self.norm1 = _gn(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _gn(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        res = self.shortcut(x) if hasattr(self, "shortcut") else x
        return (h + res) * self.skip_scale


class _Block(nn.Module):
    """One level: ``nets`` (resnet blocks), ``attns`` (MVAttention, when the
    level has attention) and an optional resampling conv."""

    def __init__(self, nets: List[nn.Module], attns: List[nn.Module]):
        super().__init__()
        self.nets = nn.ModuleList(nets)
        if attns:
            self.attns = nn.ModuleList(attns)

    def layer(self, j: int, x: torch.Tensor) -> torch.Tensor:
        x = self.nets[j](x)
        return self.attns[j](x) if hasattr(self, "attns") else x


class LGMUNet(nn.Module):
    """Asymmetric encoder-decoder with cross-view attention
    (core/unet.py:234-319): [B·V, Cin, H, W] → [B·V, Cout, H', W']."""

    def __init__(self, in_channels: int = 9, out_channels: int = 14,
                 down_channels=(64, 128, 256, 512, 1024, 1024),
                 down_attention=(False, False, False, True, True, True),
                 mid_attention: bool = True,
                 up_channels=(1024, 1024, 512, 256, 128),
                 up_attention=(True, True, True, False, False),
                 layers_per_block: int = 2, skip_scale: float = math.sqrt(0.5),
                 num_frames: int = 4):
        super().__init__()
        kw = dict(skip_scale=skip_scale)
        akw = dict(num_frames=num_frames, skip_scale=skip_scale)
        self.conv_in = nn.Conv2d(in_channels, down_channels[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        skip_channels = [down_channels[0]]
        cout = down_channels[0]
        for i, ch in enumerate(down_channels):
            cin, cout = cout, ch
            nets = [LGMResnetBlock(cin if j == 0 else cout, cout, **kw)
                    for j in range(layers_per_block)]
            attns = ([MVAttention(cout, **akw) for _ in range(layers_per_block)]
                     if down_attention[i] else [])
            blk = _Block(nets, attns)
            skip_channels += [cout] * layers_per_block
            if i != len(down_channels) - 1:
                blk.downsample = nn.Conv2d(cout, cout, 3, stride=2, padding=1)
                skip_channels.append(cout)
            self.down_blocks.append(blk)

        mid = down_channels[-1]
        self.mid_block = _Block([LGMResnetBlock(mid, mid, **kw) for _ in range(2)],
                                [MVAttention(mid, **akw)] if mid_attention else [])

        self.up_blocks = nn.ModuleList()
        cout = up_channels[0]
        for i, ch in enumerate(up_channels):
            cin, cout = cout, ch
            n_layers = layers_per_block + 1
            skips = skip_channels[-n_layers:][::-1]
            skip_channels = skip_channels[:-n_layers]
            nets = [LGMResnetBlock((cin if j == 0 else cout) + skips[j], cout, **kw)
                    for j in range(n_layers)]
            attns = ([MVAttention(cout, **akw) for _ in range(n_layers)]
                     if up_attention[i] else [])
            blk = _Block(nets, attns)
            if i != len(up_channels) - 1:
                blk.upsample = nn.Conv2d(cout, cout, 3, padding=1)
            self.up_blocks.append(blk)
        self.norm_out = _gn(up_channels[-1])
        self.conv_out = nn.Conv2d(up_channels[-1], out_channels, 3, padding=1)
        self.layers_per_block = layers_per_block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        xss = [x]
        for blk in self.down_blocks:
            for j in range(len(blk.nets)):
                x = blk.layer(j, x)
                xss.append(x)
            if hasattr(blk, "downsample"):
                x = blk.downsample(x)
                xss.append(x)

        x = self.mid_block.nets[0](x)
        if hasattr(self.mid_block, "attns"):
            x = self.mid_block.attns[0](x)
        x = self.mid_block.nets[1](x)

        for blk in self.up_blocks:
            for j in range(len(blk.nets)):
                x = blk.layer(j, torch.cat([x, xss.pop()], dim=1))
            if hasattr(blk, "upsample"):
                x = blk.upsample(F.interpolate(x, scale_factor=2, mode="nearest"))
        return self.conv_out(F.silu(self.norm_out(x)))


class LGM(nn.Module):
    """Views + rays → Gaussians (reference core/models.py:14-116).

    ``forward(images [B, V, 9, H, W]) -> [B, V·S·S, 14]`` fp32, the channel
    layout (pos 3, opacity 1, scale 3, rotation 4, rgb 3) that
    ``ops.gaussian_splat`` and ``ops.ply_io`` take."""

    def __init__(self, opt: LGMOptions = LGMOptions()):
        super().__init__()
        self.opt = opt
        self.unet = LGMUNet(
            in_channels=9, out_channels=14, down_channels=opt.down_channels,
            down_attention=opt.down_attention, mid_attention=opt.mid_attention,
            up_channels=opt.up_channels, up_attention=opt.up_attention,
            num_frames=opt.num_input_views)
        self.conv = nn.Conv2d(14, 14, 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        B, V, C, H, W = images.shape
        x = images.reshape(B * V, C, H, W).to(self.conv.weight.dtype)
        x = self.conv(self.unet(x))                       # [B·V, 14, S, S]
        S = self.opt.splat_size
        x = x.permute(0, 2, 3, 1).reshape(B, V * S * S, 14).float()
        pos = x[..., 0:3].clamp(-1, 1)
        opacity = torch.sigmoid(x[..., 3:4])
        scale = 0.1 * F.softplus(x[..., 4:7])
        rotation = x[..., 7:11]
        # the reference's bare F.normalize: dim=1, across all N Gaussians
        rotation = rotation / rotation.norm(dim=1, keepdim=True).clamp_min(1e-12)
        rgb = 0.5 * torch.tanh(x[..., 11:14]) + 0.5
        return torch.cat([pos, opacity, scale, rotation, rgb], dim=-1)
