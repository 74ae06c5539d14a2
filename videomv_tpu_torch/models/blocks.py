"""UNet blocks of the T2V denoiser as PyTorch ``nn.Module``s (NCHW).

Port of ``videomv_tpu/models/blocks.py``: the transformer-path blocks of the
shipped checkpoint, and the dormant temporal variants the UNet selects with
``temporal_block`` (``rotary``: ``TemporalAttentionMultiBlock`` of rotary
``TemporalAttentionBlock``s with a ``RelativePositionBias``; ``attemask``:
the causal ``TemporalTransformerAttemask``), plus ``DropPath``.
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

Every GroupNorm is a ``GroupNorm`` (``nn.GroupNorm``'s parameters and
keys), and every GroupNorm → SiLU pair a ``NormSiLU``: in eval mode, with no
autograd recording and a bf16 CUDA input, the norm and its SiLU are one
launch of kernel 6 (``ops.group_norm``), which reads the temporal blocks'
permuted inputs where they lie.

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
from ..ops.flash_attention import fp32_logits
from ..ops.fused_ffn import ffn_eligible, geglu_ffn
from ..ops.fused_spatial import (
    fused_spatial_transformer,
    kernel_params,
    spatial_fused_eligible,
)
from ..ops.group_norm import count_plain, group_norm_eligible
from ..ops.group_norm import group_norm as group_norm_op
from ..parallel.collectives import all_reduce, group_norm
from ..parallel.infer import current_frame_shard

__all__ = [
    "BasicTransformerBlock",
    "CrossAttention",
    "Downsample",
    "DropPath",
    "FeedForward",
    "GroupNorm",
    "NormSiLU",
    "RelativePositionBias",
    "ResBlock",
    "SpatialResBlock",
    "SpatialTransformer",
    "TemporalAttentionBlock",
    "TemporalAttentionMultiBlock",
    "TemporalConvBlockV2",
    "TemporalTransformer",
    "TemporalTransformerAttemask",
    "TimestepMLP",
    "Upsample",
    "residual",
    "rotary_rotate",
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


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` (the same parameters and keys) whose ``forward(x,
    silu=False)`` can apply SiLU to its output. In eval mode, with no
    autograd recording and a bf16 CUDA input the kernel takes
    (``ops.group_norm.group_norm_eligible``), the norm and the SiLU are one
    launch of kernel 6, whose output is contiguous; otherwise PyTorch's norm
    and ``F.silu``, a bf16 call counted in ``gn.plain``."""

    def on_kernel(self, x: torch.Tensor) -> bool:
        """Whether ``forward(x)`` launches kernel 6."""
        return not self.training and group_norm_eligible(x, self.weight, self.bias,
                                                         self.num_groups)

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        if self.on_kernel(x):
            return group_norm_op(x, self.weight, self.bias, self.num_groups, self.eps, silu)
        count_plain(x, silu)
        h = super().forward(x)
        return F.silu(h) if silu else h


def residual(x: torch.Tensor, h: torch.Tensor, norm: GroupNorm) -> torch.Tensor:
    """``x + h`` for a block whose output ``h`` is a permuted (channels-last)
    view. Where the block's ``norm`` runs on kernel 6 the sum takes x's NCHW
    layout, which the next block's GroupNorm reads in place; on the plain
    path it takes h's layout, as it always has."""
    return x + h if norm.on_kernel(x) else h + x


class NormSiLU(nn.Sequential):
    """``Sequential(GroupNorm, SiLU, *rest)`` (a Sequential's keys) that runs
    the norm with its SiLU fused, then the rest."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self[0](x, silu=True)
        for i, layer in enumerate(self):
            if i >= 2:
                h = layer(h)
        return h


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
    / C = 320 stage with a 1024-wide context). The kernel's layout is
    ``[R, S, C]``: the NCHW input is permuted to tokens-last around the
    call."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, dropout: float = 0.0):
        super().__init__()
        inner = n_heads * d_head
        self.n_heads, self.d_head, self.depth = n_heads, d_head, depth
        self.norm = GroupNorm(32, in_channels, eps=1e-6)
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
                                           context.shape[-1], x.dtype, x.is_cuda)):
            out = fused_spatial_transformer(
                x.permute(0, 2, 3, 1).contiguous().view(bf, hh * ww, c), context.contiguous(),
                kernel_params(self), self.n_heads)
            return out.reshape(bf, hh, ww, c).permute(0, 3, 1, 2)
        h = self.norm(x).permute(0, 2, 3, 1).reshape(bf, hh * ww, c)
        h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = self.proj_out(h)
        return residual(x, h.reshape(bf, hh, ww, c).permute(0, 3, 1, 2), self.norm)


def _over_frames(x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(tokens [B, C, F, S], group)`` over ``x [B, C, F, H, W]``, where
    ``tokens`` hold every frame of S tokens. Under ``frame_sharded`` x is one
    rank's block of frames: the tokens are this rank's share of them, taken
    through the all-to-all and back, and ``group`` (None otherwise) is the
    ranks whose statistics a norm must span."""
    shard = current_frame_shard()
    if shard is None:
        b, c, f, hh, ww = x.shape
        return fn(x.reshape(b, c, f, hh * ww), None).reshape(x.shape)
    return shard.tokens_to_frames(fn(shard.frames_to_tokens(x), shard.group), x.shape[-2:])


class TemporalTransformer(nn.Module):
    """Self-attention over the frame axis (util.py:992-1089, use_linear=False:
    k=1 conv1d projections, GroupNorm eps 1e-6). ``inner = n_heads·d_head``
    may differ from C (the dim-320 init block: 8 × 64 = 512).
    ``multiply_zero`` (the UNet's ``use_image_dataset``) returns the input.
    [B, C, F, H, W] -> same."""

    causal = False

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 dropout: float = 0.0, multiply_zero: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.multiply_zero = multiply_zero
        self.norm = GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Conv1d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, None, dropout) for _ in range(depth))
        self.proj_out = zero_module(nn.Conv1d(inner, in_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.multiply_zero:
            return x
        return _over_frames(x, self._tokens)

    def _tokens(self, x: torch.Tensor, group) -> torch.Tensor:
        """The block over ``x [B, C, F, S]``: all F frames of S tokens; the
        norm's statistics span ``group`` (None: this rank's tokens are all
        of them)."""
        b, c, f, s = x.shape
        h = group_norm(self.norm, x, group).permute(0, 3, 2, 1).reshape(b * s, f, c)
        # a k=1 conv1d over the token layout is a linear map over channels
        h = F.linear(h, self.proj_in.weight[:, :, 0], self.proj_in.bias)
        mask = (torch.ones(f, f, dtype=torch.bool, device=x.device).tril()
                if self.causal else None)
        for block in self.transformer_blocks:
            h = block(h, None, mask)
        h = F.linear(h, self.proj_out.weight[:, :, 0], self.proj_out.bias)
        return x + h.reshape(b, s, f, c).permute(0, 3, 2, 1)


class TemporalTransformerAttemask(TemporalTransformer):
    """The causal temporal transformer (util.py:1150-1247): the
    ``TemporalTransformer`` layout with both attentions of every block
    lower-triangular-masked over the frames (token i attends to frames
    <= i of the whole sample; the masked attention takes the plain path).
    [B, C, F, H, W] -> same."""

    causal = True


def rotary_rotate(x: torch.Tensor, rot_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the sequence axis (-2): the
    interleaved pair rotation of the first ``rot_dim`` channels
    (rotary-embedding-torch's ``rotate_queries_or_keys``), computed in
    float32; the other channels pass through."""
    n = x.shape[-2]
    dev = x.device
    inv = 1.0 / theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=dev) / rot_dim)
    freqs = torch.arange(n, dtype=torch.float32, device=dev)[:, None] * inv[None, :]
    freqs = freqs.repeat_interleave(2, dim=-1)  # [n, rot_dim]
    xl, xr = x[..., :rot_dim].float(), x[..., rot_dim:]
    x1, x2 = xl[..., 0::2], xl[..., 1::2]
    rot_half = torch.stack([-x2, x1], dim=-1).reshape(xl.shape)
    xl = xl * torch.cos(freqs) + rot_half * torch.sin(freqs)
    return torch.cat([xl.to(x.dtype), xr], dim=-1)


class RelativePositionBias(nn.Module):
    """T5-style bucketed relative position bias (util.py:271-309):
    ``forward(n, device)`` is ``[heads, n, n]``, added to the temporal
    attention's logits. The bucket of a large offset is its float32 log,
    truncated to an integer (key ``relative_attention_bias.weight``
    [num_buckets, heads])."""

    def __init__(self, heads: int = 8, num_buckets: int = 32, max_distance: int = 128):
        super().__init__()
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def buckets(self, n: int, device=None) -> torch.Tensor:
        """The [n, n] int64 bucket of each (query, key) offset."""
        pos = torch.arange(n, device=device)
        neg = pos[:, None] - pos[None, :]  # q - k
        half = self.num_buckets // 2
        max_exact = half // 2
        an = neg.abs()
        large = torch.log(an.clamp_min(1).float() / max_exact) / torch.log(
            torch.full((), self.max_distance / max_exact, dtype=torch.float32, device=device))
        large = max_exact + (large * (half - max_exact)).to(torch.int32).long()
        large = large.clamp_max(half - 1)
        return (neg < 0).long() * half + torch.where(an < max_exact, an, large)

    def forward(self, n: int, device=None) -> torch.Tensor:
        return self.relative_attention_bias(self.buckets(n, device)).permute(2, 0, 1)


class TemporalAttentionBlock(nn.Module):
    """Rotary temporal attention over the frame axis (util.py:871-990):
    GroupNorm (eps 1e-5) → fused qkv → q scaled, then q and k rotated over
    their first ``min(rotary_dim, dim_head)`` channels → float32 logits
    (+ the relative position bias) → masks → softmax → ``to_out``, residual.
    ``dim_head`` is ``dim // heads`` (util.py:885).

    Masks, all optional, filled with float32's lowest value (a row they
    empty gets a uniform softmax): ``video_mask [B, F]`` keeps the pairs of
    valid frames; ``focus_present_mask [B]`` lets a row's frames attend to
    themselves alone and, when given, takes the place of ``video_mask``;
    ``use_sim_mask`` is causal, after both. ``use_image_dataset`` returns the
    input. The attention is the plain one (F tokens and a bias).
    [B, C, F, H, W] -> same."""

    def __init__(self, dim: int, heads: int = 4, rotary_dim: int = 32,
                 use_image_dataset: bool = False, use_sim_mask: bool = False):
        super().__init__()
        self.dim, self.heads, self.rotary_dim = dim, heads, rotary_dim
        self.use_image_dataset, self.use_sim_mask = use_image_dataset, use_sim_mask
        self.norm = GroupNorm(32, dim, eps=1e-5)
        self.to_qkv = nn.Linear(dim, dim * 3)
        self.to_out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, pos_bias: Optional[torch.Tensor] = None,
                focus_present_mask: Optional[torch.Tensor] = None,
                video_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.use_image_dataset:
            return x
        return _over_frames(x, lambda t, group: self._tokens(
            t, group, pos_bias, focus_present_mask, video_mask))

    def _tokens(self, x: torch.Tensor, group, pos_bias, focus_present_mask, video_mask
                ) -> torch.Tensor:
        b, c, f, s = x.shape
        heads, dh = self.heads, self.dim // self.heads
        h = group_norm(self.norm, x, group).permute(0, 3, 2, 1).reshape(b * s, f, c)
        q, k, v = (t.reshape(b * s, f, heads, dh).transpose(1, 2)
                   for t in self.to_qkv(h).chunk(3, dim=-1))
        rot = min(self.rotary_dim, dh)
        q = rotary_rotate(q * dh ** -0.5, rot)
        k = rotary_rotate(k, rot)
        sim = fp32_logits("bhid,bhjd->bhij", q, k)  # [B·S, heads, F, F]
        if pos_bias is not None:
            sim = sim + pos_bias.float()[None]
        mask = None
        if focus_present_mask is not None:
            eye = torch.eye(f, dtype=torch.bool, device=x.device)
            mask = torch.where(focus_present_mask.bool()[:, None, None], eye,
                               torch.ones_like(eye))
        elif video_mask is not None:
            vm = video_mask.bool()
            mask = vm[:, None, :] & vm[:, :, None]
        if mask is not None:
            sim = sim.masked_fill(~mask.repeat_interleave(s, dim=0)[:, None],
                                  torch.finfo(torch.float32).min)
        if self.use_sim_mask:
            causal = torch.ones(f, f, dtype=torch.bool, device=x.device).tril()
            sim = sim.masked_fill(~causal, torch.finfo(torch.float32).min)
        sim = sim - sim.amax(dim=-1, keepdim=True).detach()
        out = torch.softmax(sim, dim=-1).to(v.dtype) @ v
        out = self.to_out(out.transpose(1, 2).reshape(b * s, f, self.dim))
        return x + out.reshape(b, s, f, c).permute(0, 3, 2, 1)


class TemporalAttentionMultiBlock(nn.Module):
    """``temporal_attn_times`` ``TemporalAttentionBlock``s in a row (keys
    ``att_layers.{i}``; util.py:1249-1277). Frame-sharded, the frames ↔
    tokens exchange happens once around all of them. [B, C, F, H, W] -> same."""

    def __init__(self, dim: int, heads: int = 4, rotary_dim: int = 32,
                 temporal_attn_times: int = 1, use_image_dataset: bool = False,
                 use_sim_mask: bool = False):
        super().__init__()
        self.use_image_dataset = use_image_dataset
        self.att_layers = nn.ModuleList(
            TemporalAttentionBlock(dim, heads, rotary_dim, use_image_dataset, use_sim_mask)
            for _ in range(temporal_attn_times))

    def forward(self, x: torch.Tensor, pos_bias: Optional[torch.Tensor] = None,
                focus_present_mask: Optional[torch.Tensor] = None,
                video_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.use_image_dataset:
            return x

        def tokens(t, group):
            for layer in self.att_layers:
                t = layer._tokens(t, group, pos_bias, focus_present_mask, video_mask)
            return t

        return _over_frames(x, tokens)


class DropPath(nn.Module):
    """Per-row stochastic path drop without rescaling (util.py:1395-1433): in
    training mode with ``p`` > 0 each row of ``x`` is zeroed with
    probability ``p``, drawn from ``generator``; ``keep [B]`` rows are never
    dropped and ``zero [B]`` rows always are (``zero`` wins). The identity
    in eval mode or at ``p`` = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x: torch.Tensor, zero: Optional[torch.Tensor] = None,
                keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        b = x.shape[0]
        drop = torch.rand(b, generator=generator, device=x.device) < self.p
        if keep is not None:
            drop = drop & ~keep.bool()
        if zero is not None:
            drop = drop | zero.bool()
        return x * (~drop).to(x.dtype).reshape((b,) + (1,) * (x.dim() - 1))


def _tconv(c_in: int, c_out: int, dropout: Optional[float], zero: bool = False) -> nn.Sequential:
    conv = nn.Conv3d(c_in, c_out, (3, 1, 1), padding=(1, 0, 0))
    if zero:
        conv = zero_module(conv)
    layers = [GroupNorm(32, c_in, eps=1e-5), nn.SiLU()]
    if dropout is not None:
        layers.append(nn.Dropout(dropout))
    return NormSiLU(*layers, conv)


class TemporalConvBlockV2(nn.Module):
    """Four (3,1,1) temporal convs with a zero-init tail, residual
    (util.py:1347-1392); ``multiply_zero`` returns the input.
    [B, C, F, H, W] -> same."""

    def __init__(self, in_dim: int, out_dim: Optional[int] = None, dropout: float = 0.0,
                 multiply_zero: bool = False):
        super().__init__()
        out_dim = out_dim or in_dim
        self.multiply_zero = multiply_zero
        self.conv1 = _tconv(in_dim, out_dim, None)
        self.conv2 = _tconv(out_dim, in_dim, dropout)
        self.conv3 = _tconv(in_dim, in_dim, dropout)
        self.conv4 = _tconv(in_dim, in_dim, dropout, zero=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.multiply_zero:
            return x
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


class SpatialResBlock(nn.Module):
    """GN/SiLU/conv residual block with the timestep-embedding add
    (util.py:610-730 without its temporal conv; GroupNorm eps 1e-5): the
    spatial half that ``ResBlock`` and SV3D's ``VideoResBlock`` share, under
    the keys both checkpoints use (``in_layers``, ``emb_layers``,
    ``out_layers``, ``skip_connection``). ``spatial(x [B·F, C, H, W],
    emb [B·F, E])``."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0,
                 out_channels: Optional[int] = None):
        super().__init__()
        out_ch = out_channels or channels
        self.in_layers = NormSiLU(GroupNorm(32, channels, eps=1e-5), nn.SiLU(),
                                  nn.Conv2d(channels, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_ch))
        self.out_layers = NormSiLU(
            GroupNorm(32, out_ch, eps=1e-5), nn.SiLU(), nn.Dropout(dropout),
            zero_module(nn.Conv2d(out_ch, out_ch, 3, padding=1)))
        self.skip_connection = (nn.Identity() if out_ch == channels
                                else nn.Conv2d(channels, out_ch, 1))

    def spatial(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        h = self.out_layers(h)
        return self.skip_connection(x) + h


class ResBlock(SpatialResBlock):
    """``SpatialResBlock`` + temporal conv (util.py:610-730);
    ``use_image_dataset`` turns the temporal conv into the identity.
    ``forward(x [B·F, C, H, W], emb [B·F, E], frames)``."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0,
                 out_channels: Optional[int] = None, use_image_dataset: bool = False):
        super().__init__(channels, emb_channels, dropout, out_channels)
        out_ch = out_channels or channels
        # [sic] spelling: the released checkpoint key (util.py:691)
        self.temopral_conv = TemporalConvBlockV2(out_ch, out_ch, dropout=0.1,
                                                 multiply_zero=use_image_dataset)

    def forward(self, x: torch.Tensor, emb: torch.Tensor, frames: int) -> torch.Tensor:
        h = self.spatial(x, emb)
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
