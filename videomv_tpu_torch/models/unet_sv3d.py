"""Stable Video 3D's denoiser (``sv3d_p``): SVD's ``VideoUNet`` on PyTorch.

The network of ``sgm/modules/diffusionmodules/video_model.py::VideoUNet``
(Stability-AI/generative-models) at the settings of
``scripts/sampling/configs/sv3d_p.yaml``: 8 input channels (4 noisy + 4
concat), 4 out, model_channels 320, mult 1,2,4,4, 2 res blocks, attention at
ds 1, 2, 4 with 64-wide heads, depth 1, context 1024 (one CLIP image token),
linear projections, ``adm_in_channels`` 1280 (the camera vector) through a
``sequential`` label embedding, ``extra_ff_mix_layer``,
``use_spatial_context``, ``merge_strategy: learned_with_images`` and
``video_kernel_size`` [3, 1, 1].

Its blocks beside the port's VGen ones (``models/blocks.py``):

- ``VideoResBlock``: ``blocks.SpatialResBlock`` (the spatial half the port's
  ``ResBlock`` has too), then ``time_stack``, a ResBlock over ``[B, C, T,
  H, W]`` with (3, 1, 1) convolutions and each frame's embedding added
  between them, mixed with the spatial output by ``time_mixer``.
- ``SpatialVideoTransformer``: ``blocks.SpatialTransformer``'s norm,
  projections and spatial block, then a ``VideoTransformerBlock`` over the
  frames of each position (``ff_in``, self-attention, cross-attention to the
  first frame's context, ``ff``) on ``x + time_pos_embed(frame index)``,
  mixed with the spatial output by ``time_mixer``.
- ``AlphaBlender``: ``α·spatial + (1 − α)·temporal`` with ``α =
  sigmoid(mix_factor)``. SV3D's ``image_only_indicator`` is all zeros, so
  the ``learned_with_images`` strategy reduces to that; the indicator is
  not an input here.

The frame count is the module's (``num_frames``), not an argument, so one
request's forward has one input signature and the serving pipeline replays
it as one CUDA graph (``models/graphed.py``); every input is a tensor and
nothing in the forward reads a device value on the host. Attention goes
through ``ops.dot_product_attention`` (kernel 1 for the spatial
self-attention of ≥ 256 tokens) and the GEGLU feed-forwards through
``ops.geglu_ffn`` where their gates hold (kernel 2 at C ≤ 640).

Parameter names are the source checkpoint's keys under
``model.diffusion_model.`` (``input_blocks.1.0.time_stack.in_layers.2.weight``,
``input_blocks.1.0.time_mixer.mix_factor``, ``label_emb.0.0.weight``...), so
released weights load with ``load_state_dict`` once the prefix is taken off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .blocks import (
    CrossAttention,
    Downsample,
    FeedForward,
    GroupNorm,
    NormSiLU,
    SpatialResBlock,
    SpatialTransformer,
    Upsample,
    residual,
    sinusoidal_embedding,
    zero_module,
)
from .graphed import GraphedForward, run_forward

__all__ = ["AlphaBlender", "SpatialVideoTransformer", "TemporalResBlock", "VideoResBlock",
           "VideoTransformerBlock", "VideoUNet"]


class AlphaBlender(nn.Module):
    """``α·x_spatial + (1 − α)·x_temporal``, ``α = sigmoid(mix_factor)``
    (``learned_with_images`` with an all-zero image indicator)."""

    def __init__(self, alpha: float = 0.5):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([float(alpha)]))

    def forward(self, x_spatial: torch.Tensor, x_temporal: torch.Tensor) -> torch.Tensor:
        a = torch.sigmoid(self.mix_factor).to(x_spatial.dtype)
        return a * x_spatial + (1.0 - a) * x_temporal


class TemporalResBlock(nn.Module):
    """A ``VideoResBlock``'s ``time_stack``: GN/SiLU/Conv3d (3, 1, 1), each
    frame's embedding added, GN/SiLU/zero Conv3d, residual; over ``x [B, C,
    T, H, W]`` with ``emb [B, T, E]`` (the source's ResBlock at dims 3 with
    ``exchange_temb_dims``)."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0):
        super().__init__()
        conv = lambda: nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0))
        self.in_layers = NormSiLU(GroupNorm(32, channels, eps=1e-5), nn.SiLU(), conv())
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, channels))
        self.out_layers = NormSiLU(GroupNorm(32, channels, eps=1e-5), nn.SiLU(),
                                   nn.Dropout(dropout), zero_module(conv()))
        self.skip_connection = nn.Identity()

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        h = h + self.emb_layers(emb).permute(0, 2, 1)[..., None, None].to(h.dtype)
        return self.skip_connection(x) + self.out_layers(h)


class VideoResBlock(SpatialResBlock):
    """The spatial ResBlock over ``[B·T, C, H, W]``, then ``time_stack``
    over the frames, mixed by ``time_mixer``. ``forward(x, emb [B·T, E])``."""

    def __init__(self, channels: int, emb_channels: int, num_frames: int,
                 out_channels: Optional[int] = None, dropout: float = 0.0,
                 merge_factor: float = 0.5):
        super().__init__(channels, emb_channels, dropout, out_channels)
        out_ch = out_channels or channels
        self.num_frames = num_frames
        self.time_stack = TemporalResBlock(out_ch, emb_channels, dropout)
        self.time_mixer = AlphaBlender(merge_factor)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        x = self.spatial(x, emb)
        bt, c, hh, ww = x.shape
        t = self.num_frames
        x5 = x.reshape(bt // t, t, c, hh, ww).permute(0, 2, 1, 3, 4)
        xt = self.time_stack(x5, emb.reshape(bt // t, t, -1))
        return self.time_mixer(x, xt.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww))


class VideoTransformerBlock(nn.Module):
    """Pre-LN block over the frames of each position, ``x [B·S, T, C]``:
    ``ff_in`` (GEGLU, residual), self-attention, cross-attention to
    ``context``, ``ff`` (source: ``sgm/modules/video_attention.py``)."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = FeedForward(dim, dropout=dropout)
        self.attn1 = CrossAttention(dim, None, n_heads, d_head, dropout)
        self.norm2 = nn.LayerNorm(dim)
        self.ff = FeedForward(dim, dropout=dropout)
        self.norm1 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, dropout)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialVideoTransformer(SpatialTransformer):
    """GN (eps 1e-6) and ``proj_in``; the spatial ``BasicTransformerBlock``
    with the frame's context; ``x + time_pos_embed(sin(frame index))``
    through a ``VideoTransformerBlock`` over the frames with the first
    frame's context; the two mixed by ``time_mixer``; ``proj_out`` and the
    residual. ``forward(x [B·T, C, H, W], context [B·T, L, ctx])``."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, context_dim: int,
                 num_frames: int, dropout: float = 0.0, merge_factor: float = 0.5):
        super().__init__(in_channels, n_heads, d_head, 1, context_dim, dropout)
        inner = n_heads * d_head
        self.num_frames = num_frames
        self.time_stack = nn.ModuleList(
            [VideoTransformerBlock(inner, n_heads, d_head, context_dim, dropout)])
        self.time_pos_embed = nn.Sequential(nn.Linear(in_channels, 4 * in_channels), nn.SiLU(),
                                            nn.Linear(4 * in_channels, in_channels))
        self.time_mixer = AlphaBlender(merge_factor)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        bt, c, hh, ww = x.shape
        t, s = self.num_frames, hh * ww
        b = bt // t
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(bt, s, c))
        inner = h.shape[-1]
        frame = torch.arange(t, device=x.device)
        pos = self.time_pos_embed(sinusoidal_embedding(frame, c).to(h.dtype))  # [T, inner]
        # the first frame's context of each sample, for each of its positions
        time_context = context[::t].repeat_interleave(s, dim=0)
        for block, mix_block in zip(self.transformer_blocks, self.time_stack):
            h = block(h, context)
            h_mix = (h.view(b, t, s, inner) + pos[None, :, None]).transpose(1, 2)
            h_mix = mix_block(h_mix.reshape(b * s, t, inner), time_context)
            h_mix = h_mix.view(b, s, t, inner).transpose(1, 2).reshape(bt, s, inner)
            h = self.time_mixer(h, h_mix)
        h = self.proj_out(h)
        return residual(x, h.reshape(bt, hh, ww, c).permute(0, 3, 1, 2), self.norm)


class _Sequential(nn.ModuleList):
    """A ``TimestepEmbedSequential``: each layer takes what it needs of
    ``(emb, context)``."""

    def forward(self, x, emb, context):
        for layer in self:
            if isinstance(layer, VideoResBlock):
                x = layer(x, emb)
            elif isinstance(layer, SpatialVideoTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class VideoUNet(nn.Module):
    """SVD's ``VideoUNet`` (module docstring).

    ``forward(x [B·T, in_channels, H, W], timesteps [B·T] (SV3D: c_noise =
    ¼·ln σ, float), context [B·T, L, context_dim], y [B·T, adm_in_channels])``
    → ``[B·T, out_channels, H, W]`` in float32; ``T`` is ``num_frames``."""

    def __init__(self, in_channels: int = 8, model_channels: int = 320, out_channels: int = 4,
                 num_res_blocks: int = 2, attention_resolutions: Sequence[int] = (4, 2, 1),
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_head_channels: int = 64,
                 context_dim: int = 1024, adm_in_channels: int = 1280, num_frames: int = 21,
                 dropout: float = 0.0, merge_factor: float = 0.5):
        super().__init__()
        self.model_channels, self.num_frames = model_channels, num_frames
        emb_dim = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb_dim), nn.SiLU(),
                                        nn.Linear(emb_dim, emb_dim))
        self.label_emb = nn.Sequential(nn.Sequential(
            nn.Linear(adm_in_channels, emb_dim), nn.SiLU(), nn.Linear(emb_dim, emb_dim)))

        def res(cin, cout):
            return VideoResBlock(cin, emb_dim, num_frames, cout, dropout, merge_factor)

        def attn(ch):
            return SpatialVideoTransformer(ch, ch // num_head_channels, num_head_channels,
                                           context_dim, num_frames, dropout, merge_factor)

        self.input_blocks = nn.ModuleList(
            [_Sequential([nn.Conv2d(in_channels, model_channels, 3, padding=1)])])
        chans, ch, ds = [model_channels], model_channels, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(_Sequential(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(_Sequential([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = _Sequential([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), model_channels * mult)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(_Sequential(layers))
        self.out = NormSiLU(GroupNorm(32, ch, eps=1e-5), nn.SiLU(),
                            zero_module(nn.Conv2d(model_channels, out_channels, 3, padding=1)))
        # the CUDA graphs of a serving pipeline's forward (models/graphed.py)
        self.graphs: Optional[GraphedForward] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.out[2].weight.dtype

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
        """Replayed as a CUDA graph where ``self.graphs`` engages
        (``models/graphed.py``)."""
        return run_forward(self, self._forward, x=x, t=timesteps, context=context, y=y)

    def _forward(self, x, t, context, y):
        dt = self.dtype
        emb = self.time_embed(sinusoidal_embedding(t, self.model_channels).to(dt))
        emb = emb + self.label_emb(y.to(dt))
        context = context.to(dt)
        h, hs = x.to(dt), []
        for block in self.input_blocks:
            h = block(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h).float()
