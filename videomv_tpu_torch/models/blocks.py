"""UNet blocks of the T2V denoiser as PyTorch ``nn.Module``s (NCHW).

Port of the transformer-path blocks of ``videomv_tpu/models/blocks.py``.
Module and parameter names follow the released torch checkpoint keys
(``in_layers.2.weight``, ``temopral_conv`` [sic], ``net.0.proj``...), so a
released ``.pth`` loads with ``load_state_dict`` and a ``state_dict()``
converts into the JAX tree with the JAX package's converters.

Layouts: spatial blocks take ``[B·F, C, H, W]``; temporal blocks take
``[B, C, F, H, W]`` and attend over the F axis with ``(b h w) f c`` tokens.
Attention goes through ``ops.dot_product_attention`` (CUDA flash kernel for
the long spatial self-attention in bf16) and the GEGLU feed-forward through
``ops.geglu_ffn`` (fused CUDA kernel where the JAX package fuses), with the
plain compositions everywhere else.

Layers tagged ``zero_init`` (``zero_module``) start at zero, as in the JAX
package, so a freshly initialised UNet outputs exactly 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.fused_ffn import ffn_eligible, geglu_ffn
from ..ops.fused_spatial import (
    fused_spatial_transformer,
    kernel_params,
    spatial_fused_eligible,
)
from ..parallel.collectives import all_reduce, group_norm
from ..parallel.infer import current_frame_shard

__all__ = [
    "BasicTransformerBlock",
    "CrossAttention",
    "Downsample",
    "FeedForward",
    "ResBlock",
    "SpatialTransformer",
    "TemporalConvBlockV2",
    "TemporalTransformer",
    "TimestepMLP",
    "Upsample",
    "sinusoidal_embedding",
    "zero_module",
]


def zero_module(module: nn.Module) -> nn.Module:
    """Tag ``module`` as zero-initialised (``training.checkpoints.init_weights``
    fills it with zeros on a fresh init) and zero it now."""
    module.zero_init = True
    for p in module.parameters():
        if p.device.type != "meta":
            nn.init.zeros_(p)
    return module


def sinusoidal_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] -> [B, dim] float32; cos first, then sin (reference util.py:177-189)."""
    half = dim // 2
    t = timesteps.float()
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32, device=t.device) / half)
    sinusoid = torch.outer(t, freqs)
    x = torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)
    if dim % 2 != 0:
        x = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    return x


class TimestepMLP(nn.Sequential):
    """Linear -> SiLU -> Linear (time / fps / camera embeddings; keys 0, 2).
    ``zero_init`` zeroes the last layer, as the camera and fps MLPs do."""

    def __init__(self, in_dim: int, embed_dim: int, zero_init: bool = False):
        last = nn.Linear(embed_dim, embed_dim)
        super().__init__(nn.Linear(in_dim, embed_dim), nn.SiLU(),
                         zero_module(last) if zero_init else last)


class CrossAttention(nn.Module):
    """Multi-head (cross-)attention with fp32 softmax: ``to_q/to_k/to_v``
    without bias, ``to_out.0`` with bias (MemoryEfficientCrossAttention).

    Under tensor parallelism (``parallel.tp.place_params_tp``) the module
    holds this rank's heads, ``to_out.0`` its input columns of them, and
    ``tp_group`` the ranks that hold the others: the output projection's
    partial sums are all-reduced over it before the bias."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(dropout))
        self.tp_group = None

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        b, s_q = x.shape[:2]
        s_kv = context.shape[1]
        q = self.to_q(x).view(b, s_q, self.heads, self.dim_head)
        k = self.to_k(context).view(b, s_kv, self.heads, self.dim_head)
        v = self.to_v(context).view(b, s_kv, self.heads, self.dim_head)
        out = dot_product_attention(q, k, v, mask=mask).reshape(b, s_q, self.heads * self.dim_head)
        if self.tp_group is None:
            return self.to_out(out)
        proj = self.to_out[0]
        partial = all_reduce(F.linear(out, proj.weight), self.tp_group)
        return self.to_out[1](partial + proj.bias)


class GEGLU(nn.Module):
    """Holds the GEGLU input projection (key ``proj``); ``FeedForward`` does
    the math so the fused kernel and the plain path share one parameter set."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)


class FeedForward(nn.Module):
    """GEGLU MLP (keys ``net.0.proj``, ``net.2``). In eval mode, bf16 and on a
    CUDA device with the JAX package's eligible shapes it runs the fused CUDA
    kernel; otherwise the plain composition (exact-erf gelu)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, self.inner), nn.Dropout(dropout),
                                 nn.Linear(self.inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w1, b1 = self.net[0].proj.weight, self.net[0].proj.bias
        w2, b2 = self.net[2].weight, self.net[2].bias
        lead, c_in = x.shape[:-1], x.shape[-1]
        t = math.prod(lead)
        if not self.training and ffn_eligible(t, c_in, self.inner, x.dtype, x.is_cuda):
            out = geglu_ffn(x.reshape(t, c_in), w1, b1.float(), w2, b2.float())
            return out.reshape(*lead, w2.shape[0])
        h = F.linear(x, w1, b1)
        hx, gate = h.chunk(2, dim=-1)
        h = self.net[1](hx * F.gelu(gate))
        return F.linear(h, w2, b2)


class BasicTransformerBlock(nn.Module):
    """Self-attn -> cross-attn -> GEGLU FF, pre-LN residual (util.py:510-540)."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head, dropout)
        self.ff = FeedForward(dim, dropout=dropout)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, dropout)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x), None, mask)
        x = x + self.attn2(self.norm2(x), context, mask if context is None else None)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Self+cross attention over the H·W tokens (util.py:311-373,
    use_linear=True; GroupNorm eps 1e-6). [B·F, C, H, W] -> same.

    In eval mode, with a context, depth 1 and d_head 64, the whole block runs
    as one fused CUDA kernel where ``spatial_fused_eligible`` holds (opt-in
    through ``VIDEOMV_ENABLE_FUSED_SPATIAL``; bf16 on a CUDA device, the 32²
    / C = 320 stage). The kernel's layout is ``[R, S, C]``: the NCHW input is
    permuted to tokens-last around the call."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        inner = n_heads * d_head
        self.n_heads, self.d_head, self.depth = n_heads, d_head, depth
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim, dropout)
            for _ in range(depth))
        self.proj_out = zero_module(nn.Linear(inner, in_channels))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        bf, c, hh, ww = x.shape
        if (not self.training and context is not None and self.depth == 1
                and self.d_head == 64 and self.transformer_blocks[0].attn1.tp_group is None
                and spatial_fused_eligible(hh * ww, c, self.n_heads * self.d_head, self.n_heads,
                                           x.dtype, x.is_cuda)):
            out = fused_spatial_transformer(
                x.permute(0, 2, 3, 1).contiguous().view(bf, hh * ww, c), context.contiguous(),
                kernel_params(self), self.n_heads)
            return out.reshape(bf, hh, ww, c).permute(0, 3, 1, 2)
        h = self.norm(x).permute(0, 2, 3, 1).reshape(bf, hh * ww, c)
        h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = self.proj_out(h)
        return h.reshape(bf, hh, ww, c).permute(0, 3, 1, 2) + x


class TemporalTransformer(nn.Module):
    """Self-attention over the frame axis (util.py:992-1089, use_linear=False:
    k=1 conv1d projections, GroupNorm eps 1e-6). ``inner = n_heads·d_head``
    may differ from C (the dim-320 init block: 8 × 64 = 512).
    [B, C, F, H, W] -> same."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        inner = n_heads * d_head
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Conv1d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, None, dropout) for _ in range(depth))
        self.proj_out = zero_module(nn.Conv1d(inner, in_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = current_frame_shard()
        if shard is None:
            b, c, f, hh, ww = x.shape
            return self._tokens(x.reshape(b, c, f, hh * ww), None).reshape(x.shape)
        # frame-sharded: every frame of this rank's tokens, and back
        return shard.tokens_to_frames(self._tokens(shard.frames_to_tokens(x), shard.group),
                                      x.shape[-2:])

    def _tokens(self, x: torch.Tensor, group) -> torch.Tensor:
        """The block over ``x [B, C, F, S]``: all F frames of S tokens; the
        norm's statistics span ``group`` (None: this rank's tokens are all
        of them)."""
        b, c, f, s = x.shape
        h = group_norm(self.norm, x, group).permute(0, 3, 2, 1).reshape(b * s, f, c)
        # a k=1 conv1d over the token layout is a linear map over channels
        h = F.linear(h, self.proj_in.weight[:, :, 0], self.proj_in.bias)
        for block in self.transformer_blocks:
            h = block(h)
        h = F.linear(h, self.proj_out.weight[:, :, 0], self.proj_out.bias)
        return x + h.reshape(b, s, f, c).permute(0, 3, 2, 1)


def _tconv(c_in: int, c_out: int, dropout: Optional[float], zero: bool = False) -> nn.Sequential:
    conv = nn.Conv3d(c_in, c_out, (3, 1, 1), padding=(1, 0, 0))
    if zero:
        conv = zero_module(conv)
    layers = [nn.GroupNorm(32, c_in, eps=1e-5), nn.SiLU()]
    if dropout is not None:
        layers.append(nn.Dropout(dropout))
    return nn.Sequential(*layers, conv)


class TemporalConvBlockV2(nn.Module):
    """Four (3,1,1) temporal convs with a zero-init tail, residual
    (util.py:1347-1392). [B, C, F, H, W] -> same."""

    def __init__(self, in_dim: int, out_dim: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        out_dim = out_dim or in_dim
        self.conv1 = _tconv(in_dim, out_dim, None)
        self.conv2 = _tconv(out_dim, in_dim, dropout)
        self.conv3 = _tconv(in_dim, in_dim, dropout)
        self.conv4 = _tconv(in_dim, in_dim, dropout, zero=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = current_frame_shard()
        if shard is None:
            return x + self.conv4(self.conv3(self.conv2(self.conv1(x))))
        # frame-sharded: the (3, 1, 1) convolutions see every frame of this
        # rank's tokens ([B, C, F, S, 1]), the norms every rank's statistics
        h = shard.frames_to_tokens(x)[..., None]
        out = h
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            out = group_norm(conv[0], out, shard.group)
            for layer in list(conv)[1:]:
                out = layer(out)
        return shard.tokens_to_frames((h + out)[..., 0], x.shape[-2:])


class ResBlock(nn.Module):
    """GN/SiLU/conv residual block + timestep-embedding add + temporal conv
    (util.py:610-730; GroupNorm eps 1e-5). ``forward(x [B·F, C, H, W],
    emb [B·F, E], frames)``."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0,
                 out_channels: Optional[int] = None):
        super().__init__()
        out_ch = out_channels or channels
        self.in_layers = nn.Sequential(nn.GroupNorm(32, channels, eps=1e-5), nn.SiLU(),
                                       nn.Conv2d(channels, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_ch))
        self.out_layers = nn.Sequential(
            nn.GroupNorm(32, out_ch, eps=1e-5), nn.SiLU(), nn.Dropout(dropout),
            zero_module(nn.Conv2d(out_ch, out_ch, 3, padding=1)))
        self.skip_connection = (nn.Identity() if out_ch == channels
                                else nn.Conv2d(channels, out_ch, 1))
        # [sic] spelling: the released checkpoint key (util.py:691)
        self.temopral_conv = TemporalConvBlockV2(out_ch, out_ch, dropout=0.1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, frames: int) -> torch.Tensor:
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        h = self.out_layers(h)
        h = self.skip_connection(x) + h
        bf, c, hh, ww = h.shape
        ht = self.temopral_conv(h.reshape(bf // frames, frames, c, hh, ww).permute(0, 2, 1, 3, 4))
        return ht.permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)


class Upsample(nn.Module):
    """Nearest ×2 upsample + 3×3 conv (util.py:579-607)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    """Stride-2 3×3 conv, padding 1 (util.py:732-756)."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)
