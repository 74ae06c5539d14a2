"""Stable-Diffusion KL-VAE first stage as PyTorch modules (NCHW).

Port of ``videomv_tpu/models/autoencoder.py``. Module paths are the SD
checkpoint's (``decoder.up.3.block.0.conv1``, ``decoder.mid.attn_1.q``,
``encoder.down.0.downsample.conv``, ``post_quant_conv``), so the released
``VQGAN_autoencoder.pth`` loads directly. The mid-block attention is
single-head plain math (fp32 softmax), not a kernel. Its GroupNorms are
``blocks.GroupNorm``s, each with the SiLU after it fused (kernel 6 in bf16
on the card). ``decode`` returns float32 whatever the module's dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import fp32_logits
from .blocks import GroupNorm

__all__ = ["AutoencoderKL", "Decoder", "Encoder"]


def _gn(c: int) -> GroupNorm:
    return GroupNorm(32, c, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = _gn(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_ch, 3, padding=1)
        self.norm2 = _gn(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if out_ch != in_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over H·W with 1×1 conv projections."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _gn(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q, k, v = (m(h).reshape(b, c, hh * ww).transpose(1, 2) for m in (self.q, self.k, self.v))
        logits = fp32_logits("bqc,bkc->bqk", q, k) * c ** -0.5
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        h = torch.einsum("bqk,bkc->bqc", attn, v).transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class _Level(nn.Module):
    """One resolution level: ``block`` (ResnetBlocks) and an optional
    resampling conv (the SD VAE's attn_resolutions=[] leaves no attention)."""

    def __init__(self, blocks, resample: Optional[nn.Module], resample_name: str):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, resample_name, resample)


class _Resample(nn.Module):
    """``conv`` after nearest ×2 upsampling, or a stride-2 valid conv after
    the SD encoder's asymmetric (0, 1) padding."""

    def __init__(self, channels: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(channels, channels, 3, stride=2 if down else 1,
                              padding=0 if down else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.block_1 = ResnetBlock(c, c)
        self.attn_1 = AttnBlock(c)
        self.block_2 = ResnetBlock(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, in_channels: int = 3, z_channels: int = 4,
                 double_z: bool = True):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)
        in_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            c_in, c_out = ch * in_mult[i], ch * mult
            blocks = [ResnetBlock(c_in if j == 0 else c_out, c_out) for j in range(num_res_blocks)]
            last = i == len(ch_mult) - 1
            self.down.append(_Level(blocks, None if last else _Resample(c_out, True), "downsample"))
        c = ch * ch_mult[-1]
        self.mid = _Mid(c)
        self.norm_out = _gn(c)
        self.conv_out = nn.Conv2d(c, 2 * z_channels if double_z else z_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, out_ch: int = 3, z_channels: int = 4):
        super().__init__()
        c = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, c, 3, padding=1)
        self.mid = _Mid(c)
        levels = []
        for i in reversed(range(len(ch_mult))):
            c_out = ch * ch_mult[i]
            blocks = [ResnetBlock(c if j == 0 else c_out, c_out) for j in range(num_res_blocks + 1)]
            levels.append(_Level(blocks, _Resample(c_out, False) if i != 0 else None, "upsample"))
            c = c_out
        self.up = nn.ModuleList(levels[::-1])  # up[i] is level i, as in the SD keys
        self.norm_out = _gn(c)
        self.conv_out = nn.Conv2d(c, out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    """SD KL-VAE. Layout [B, C, H, W] at the public methods."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, z_channels: int = 4, embed_dim: int = 4,
                 out_ch: int = 3):
        super().__init__()
        self.encoder = Encoder(ch, ch_mult, num_res_blocks, 3, z_channels)
        self.decoder = Decoder(ch, ch_mult, num_res_blocks, out_ch, z_channels)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * embed_dim, 1)
        self.post_quant_conv = nn.Conv2d(embed_dim, z_channels, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode_moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior mean and clamped log-variance of images [B, 3, H, W]."""
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode_first_stage(self, x: torch.Tensor, scale_factor: float = 1.0) -> torch.Tensor:
        """Latents of images [B, 3, H, W]: the posterior mode (its mean)
        times ``scale_factor``; no noise is drawn, as in the JAX package's
        GS refine."""
        return scale_factor * self.encode_moments(x)[0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype))).float()
