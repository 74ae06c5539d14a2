"""The image→multiview 3D video UNet (``UNetSD_I2VGen``) as a PyTorch module.

Port of ``videomv_tpu/models/unet_i2v.py``: the T2V backbone plus the
I2VGen-XL image-conditioning adapters (reference unet_i2vgen.py:27-541):

1. concat plane: the reference frame's VAE latent, tiled over the frames with
   a temporal position ramp ``(1..f-1)/(f-1)`` for frames 1..f-1, runs through
   a conv stack and a tiny temporal transformer; the result enters the concat
   plane **twice** — the reference's acknowledged bug (unet_i2vgen.py:345-346)
   which the released weights were trained with, reproduced as a doubling;
2. local context: the same latent pooled to 64 tokens of width
   ``context_dim`` (``local_image_embedding``) appended to the text tokens;
3. global context: the CLIP image embedding expanded into ``num_tokens = 4``
   context tokens (``context_embedding``);
4. the fps embedding is always applied (zero-init, default fps 8), the camera
   embedding as in T2V.

Context length = 77 (text) + 64 (local) + 4 (global) = 145 tokens. The input
convolution takes ``in_dim + concat_dim`` channels. Module names are the
released checkpoint's (``local_image_concat.0``, ``local_temporal_encoder.
layers.0.0.fn.to_qkv``, ``local_image_embedding.3``, ``context_embedding.2``,
``fps_embedding.0``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import fp32_logits
from ..parallel.infer import current_frame_shard
from .blocks import TimestepMLP, sinusoidal_embedding
from .graphed import run_forward
from .unet_t2v import UNetSD_T2VBase

__all__ = ["PreNormAttention", "TransformerV2", "UNetSD_I2VGen", "adaptive_avg_pool_2d"]


class _PackedAttention(nn.Module):
    """Multi-head attention with a packed ``to_qkv`` without bias (reference
    util.py:1091-1117); no output projection when ``heads == 1 and
    dim_head == dim``."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        project_out = not (heads == 1 and dim_head == dim)
        self.to_out = nn.Sequential(nn.Linear(inner, dim)) if project_out else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q, k, v = (t.reshape(b, s, self.heads, self.dim_head)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        logits = fp32_logits("bqhd,bkhd->bhqk", q, k) * self.dim_head ** -0.5
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, self.heads * self.dim_head)
        return self.to_out(o)


class PreNormAttention(nn.Module):
    """LayerNorm → packed-qkv attention, residual (reference util.py:1119-1127;
    keys ``norm``, ``fn.to_qkv``, ``fn.to_out.0``)."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = _PackedAttention(dim, heads, dim_head)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fn(self.norm(x))


class _GeluFeedForward(nn.Module):
    """Linear → exact GELU → Linear (keys ``net.0.0``, ``net.2``)."""

    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.net = nn.Sequential(nn.Sequential(nn.Linear(dim, dim * 4), nn.GELU()),
                                 nn.Identity(), nn.Linear(dim * 4, dim_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class TransformerV2(nn.Module):
    """The adapter transformer (reference util.py:1129-1148): per layer a
    ``PreNormAttention`` and a plain-GELU feed-forward ``dim → 4·dim →
    mlp_dim``, each with its residual (keys ``layers.N.0``, ``layers.N.1``)."""

    def __init__(self, dim: int, heads: int = 2, dim_head: int = 4, mlp_dim: int = 4,
                 depth: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([PreNormAttention(dim, heads, dim_head),
                           _GeluFeedForward(dim, mlp_dim)])
            for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = attn(x)
            x = x + ff(x)
        return x


def adaptive_avg_pool_2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``AdaptiveAvgPool2d`` over NCHW as the JAX package computes it: block
    means where the sizes divide, a bilinear resize otherwise."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if h % oh == 0 and w % ow == 0:
        return F.avg_pool2d(x, (h // oh, w // ow))
    # jax.image.resize(method="linear"): half-pixel centres, antialiased when
    # it shrinks
    return F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False, antialias=True)


class UNetSD_I2VGen(UNetSD_T2VBase):
    """I2V denoiser: the T2V backbone + the image-conditioning adapters.

    Extra inputs: ``local_image`` [B, 4, 1, h, w] (the VAE latent of the
    reference frame) and ``image`` [B, y_dim] (the CLIP global image
    embedding). ``concat_dim`` equals ``in_dim`` (reference unet_i2vgen.py:93)."""

    def __init__(self, in_dim: int = 4, dim: int = 320, y_dim: int = 1024,
                 context_dim: int = 1024, num_tokens: int = 4, **kwargs):
        kwargs.pop("use_fps_condition", None)  # the fps embedding is always on
        super().__init__(in_dim=in_dim, dim=dim, y_dim=y_dim, context_dim=context_dim,
                         use_fps_condition=True, **kwargs)
        concat_dim = in_dim
        embed_dim = dim * 4
        self.in_dim, self.concat_dim, self.num_tokens = in_dim, concat_dim, num_tokens
        # the input conv sees the latent and the concat plane
        self.input_blocks[0][0] = nn.Conv2d(in_dim + concat_dim, dim, 3, padding=1)
        if not self.temporal_attention:
            # the I2V middle block keeps its temporal transformer whatever
            # temporal_attention says (JAX unet_i2v.py:249-254)
            mid_ch = dim * self.dim_mult[-1]
            self.middle_block.insert(2, self._block(in_dim, "temporal", "middle_block_2",
                                                    mid_ch, mid_ch))
        self.local_image_concat = nn.Sequential(
            nn.Conv2d(in_dim, concat_dim * 4, 3, padding=1), nn.SiLU(),
            nn.Conv2d(concat_dim * 4, concat_dim * 4, 3, padding=1), nn.SiLU(),
            nn.Conv2d(concat_dim * 4, concat_dim, 3, padding=1))
        self.local_temporal_encoder = TransformerV2(
            dim=concat_dim, heads=2, dim_head=concat_dim, mlp_dim=concat_dim, depth=1)
        # conv → SiLU → pool to 32² → two stride-2 convs: 64 tokens (the
        # reference hardcodes width 1024 for the last one; context_dim here)
        self.local_image_embedding = nn.Sequential(
            nn.Conv2d(in_dim, concat_dim * 8, 3, padding=1), nn.SiLU(), nn.Identity(),
            nn.Conv2d(concat_dim * 8, concat_dim * 16, 3, stride=2, padding=1), nn.SiLU(),
            nn.Conv2d(concat_dim * 16, context_dim, 3, stride=2, padding=1))
        self.context_embedding = nn.Sequential(
            nn.Linear(y_dim, embed_dim), nn.SiLU(),
            nn.Linear(embed_dim, context_dim * num_tokens))

    def fsdp_units(self):
        """The T2V backbone's units, the adapters the forward calls whole,
        and each convolution of ``local_image_embedding`` (called one by
        one)."""
        return (super().fsdp_units()
                + [self.local_image_concat, self.local_temporal_encoder, self.context_embedding]
                + [m for m in self.local_image_embedding if any(True for _ in m.parameters())])

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        y: Optional[torch.Tensor] = None,
        camera_data: Optional[torch.Tensor] = None,
        fps: Optional[torch.Tensor] = None,
        local_image: Optional[torch.Tensor] = None,
        image: Optional[torch.Tensor] = None,
        zero_y: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Replayed as a CUDA graph where ``self.graphs`` engages
        (``models/graphed.py``)."""
        return run_forward(self, self._forward, x=x, t=t, y=y, camera_data=camera_data, fps=fps,
                           local_image=local_image, image=image, zero_y=zero_y)

    def _forward(self, x, t, y, camera_data, fps, local_image, image, zero_y):
        b, c, f, hh, ww = x.shape
        dt = self.dtype
        if local_image is None:
            raise ValueError("I2V requires the reference-frame latent (local_image)")
        if local_image.dim() == 4:
            local_image = local_image[:, :, None]
        local_image = local_image[:, :, :1].to(dt)

        # ---- concat plane (unet_i2vgen.py:331-346). It mixes frames twice:
        # its ramp counts the sample's frames, and its temporal transformer
        # attends over them. It depends on the reference frame alone, not on
        # x, so a frame-sharded rank builds it over all the sample's frames
        # and keeps its own block of them (no collective).
        shard = current_frame_shard()
        fa = f if shard is None else shard.frames
        if fa > 1:
            ramp = (torch.arange(1, fa, dtype=torch.float32, device=x.device) / (fa - 1)).to(dt)
            mask_pos = ramp.reshape(1, 1, fa - 1, 1, 1).expand(b, c, fa - 1, hh, ww)
            ximg = torch.cat([local_image, mask_pos], dim=2)
        else:
            ximg = local_image
        xi = self.local_image_concat(ximg.permute(0, 2, 1, 3, 4).reshape(b * fa, c, hh, ww))
        cd = self.concat_dim
        # the tiny temporal transformer over the frames of every pixel
        xi = xi.reshape(b, fa, cd, hh, ww).permute(0, 3, 4, 1, 2).reshape(b * hh * ww, fa, cd)
        xi = self.local_temporal_encoder(xi)
        xi = xi.reshape(b, hh, ww, fa, cd).permute(0, 3, 4, 1, 2)  # [B, F, cd, H, W]
        if shard is not None:
            xi = xi[:, shard.start:shard.start + f]
        # the reference adds the plane twice (kept for weight compatibility)
        concat = 2.0 * xi

        # ---- embeddings (the fps embedding always on, unet_i2vgen.py:349)
        e = self.time_embed(sinusoidal_embedding(t, self.dim).to(dt))
        if fps is None:
            fps = torch.full_like(t, 8)
        e = e + self.fps_embedding(sinusoidal_embedding(fps, self.dim).to(dt))
        e = e.repeat_interleave(f, dim=0)
        if self.use_camera_condition and camera_data is not None:
            e = e + self.camera_embedding(camera_data.reshape(b * f, self.camera_dim).to(dt))

        # ---- context: text + 64 local tokens + num_tokens global tokens
        if y is None:
            if zero_y is None:
                raise ValueError("I2V needs y or zero_y")
            y = zero_y[:, :1, :].expand(b, 1, self.context_dim)
        lc = self.local_image_embedding[1](self.local_image_embedding[0](local_image[:, :, 0]))
        lc = adaptive_avg_pool_2d(lc, (32, 32))
        for layer in list(self.local_image_embedding)[3:]:
            lc = layer(lc)
        lc = lc.flatten(2).transpose(1, 2)  # [B, 64, context_dim], row-major over (h, w)
        context = [y.to(dt), lc]
        if image is not None:
            img = self.context_embedding(image.to(dt))
            context.append(img.reshape(b, self.num_tokens, self.context_dim))
        context = torch.cat(context, dim=1).repeat_interleave(f, dim=0)

        # ---- backbone over [x; concat] channels
        h = torch.cat([x.permute(0, 2, 1, 3, 4).to(dt), concat], dim=2)
        h = h.reshape(b * f, c + cd, hh, ww)
        xs = []
        for blocks in self.input_blocks:
            h = self._run(blocks, h, e, context, b, f)
            xs.append(h)
        h = self._run(self.middle_block, h, e, context, b, f)
        for blocks in self.output_blocks:
            h = self._run(blocks, torch.cat([h, xs.pop()], dim=1), e, context, b, f)
        h = self.out(h)
        return h.reshape(b, f, self.out_dim, hh, ww).permute(0, 2, 1, 3, 4).float()
