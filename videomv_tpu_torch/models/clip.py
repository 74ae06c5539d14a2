"""OpenCLIP ViT-H-14 text and visual towers as PyTorch modules.

Port of ``videomv_tpu/models/clip.py``. ``CLIPTextTower``: token and
positional embeddings, a causal transformer cut to its penultimate layer
(``skip_last=1``, the reference's ``layer='penultimate'``), then
``ln_final``; the pipelines use the token sequence ``[B, 77, width]`` as
the UNet's cross-attention context. ``CLIPVisionTower``: 14×14 patch
convolution, class token, 257 positions, ``ln_pre``, 32 unmasked blocks of
width 1280, ``ln_post`` on the class token, projection to 1024: the I2V
pipeline's global image embedding. ``OpenCLIPTextVisual`` holds both
(the text tower's parameters at the top level, ``visual.`` beside them, as
in the released file). Parameter names are open_clip's
(``transformer.resblocks.N.attn.in_proj_weight`` packed q/k/v,
``mlp.c_fc``, ``ln_final``, ``text_projection``, ``visual.conv1.weight``,
``visual.class_embedding``, ``visual.proj``). Attention is the plain
fp32-softmax path (an additive causal mask in the text tower).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import attention_reference

__all__ = ["CLIPTextTower", "CLIPVisionTower", "OpenCLIPTextVisual", "VIT_MEAN", "VIT_STD"]

# CLIP normalisation constants (reference tools/modules/config.py:77-78)
VIT_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
VIT_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


class CLIPAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed ``in_proj_weight``,
    ``out_proj``) with the JAX package's fp32-softmax math."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, s, c = x.shape
        q, k, v = (t.reshape(b, s, self.heads, c // self.heads)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        out = attention_reference(q, k, v, bias=mask)
        return self.out_proj(out.reshape(b, s, c))


class CLIPResBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict(
            c_fc=nn.Linear(width, width * 4), gelu=nn.GELU(), c_proj=nn.Linear(width * 4, width)))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, n_blocks: int):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPResBlock(width, heads) for _ in range(n_blocks))


class CLIPTextTower(nn.Module):
    """Causal text transformer; holds ``layers - skip_last`` blocks."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 1024,
                 heads: int = 16, layers: int = 24, embed_dim: int = 1024, skip_last: int = 1):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = _Transformer(width, heads, layers - skip_last)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encode_text(tokens)

    def encode_text(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens: int [B, 77] -> (pooled [B, embed_dim], sequence [B, 77, width])."""
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding.to(x.dtype)
        s = self.context_length
        causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device), diagonal=1)
        for block in self.transformer.resblocks:
            x = block(x, causal)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot] @ self.text_projection.to(x.dtype)
        return pooled, x


class CLIPVisionTower(nn.Module):
    """ViT-H/14 visual tower: CLIP-normalised images ``[B, 3, H, W]`` →
    pooled, projected image embedding ``[B, embed_dim]``."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, width: int = 1280,
                 heads: int = 16, layers: int = 32, embed_dim: int = 1024):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty((image_size // patch_size) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, heads, layers)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.conv1(images.to(self.conv1.weight.dtype))  # [B, width, gh, gw]
        x = x.flatten(2).transpose(1, 2)                    # [B, gh·gw, width]
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype)
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x)
        return self.ln_post(x[:, 0]) @ self.proj.to(x.dtype)


class OpenCLIPTextVisual(CLIPTextTower):
    """Both towers under the released file's key names: the text tower's
    parameters at the top level (``token_embedding.weight``,
    ``transformer.resblocks...``), the visual tower's under ``visual.``.
    ``forward(tokens, images) -> (image_emb | None, pooled_text, token_seq)``;
    ``text`` is the text tower alone, sharing these parameters."""

    def __init__(self, visual: Optional[CLIPVisionTower] = None, **text_kwargs):
        super().__init__(**text_kwargs)
        self.visual = visual if visual is not None else CLIPVisionTower()

    @property
    def text(self):
        return self.encode_text

    def forward(self, tokens: torch.Tensor, images: Optional[torch.Tensor] = None):
        pooled, seq = self.encode_text(tokens)
        return (self.visual(images) if images is not None else None), pooled, seq

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)
