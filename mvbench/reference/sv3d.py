"""The plain reference of the ``sv3d`` family (Stable Video 3D ``sv3d_p``):
SVD's ``VideoUNet``, the v-scaling EDM denoiser, the triangle CFG, the
Euler step, the camera vector and the conditioning, in plain PyTorch.

Written from the source (Stability-AI/generative-models:
``sgm/modules/diffusionmodules/video_model.py``, ``openaimodel.py``,
``sgm/modules/video_attention.py``, ``denoiser_scaling.py``, ``guiders.py``,
``sampling.py``, ``discretizer.py``, ``scripts/sampling/simple_video_sample.py``)
and importing nothing of the program. Module and parameter names are the
source checkpoint's, so the benchmark's state dicts load here and into the
program alike. The CLIP visual tower and the SD VAE are ``nets``' plain
copies. The check runs it in float32 with TF32 off for products and
convolutions; attention is ``softmax(q kᵀ / √d) v`` with fp32 logits,
computed over blocks of rows so that no [B, H, S, S] tensor is whole at
5,184 tokens; ``nets.record_calls`` lists its attention and feed-forward
calls (the benchmark's work count).

Departures from the source, as the program makes them: the image is
composited on white and resized (no re-centring on its alpha), the CLIP
tower's 224² resize is bilinear and antialiased (the source's is bicubic),
the last view is decoded (the source pastes the input image over it), and
``image_only_indicator`` (all zeros in SV3D) is not an input.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import nets
from .serving import VIT_MEAN, VIT_STD, white_composite

# rows of [B·H] whose logits a block holds at most (here 64 × 5184² × 4 B = 6.9 GB)
ATTN_BLOCK_ROWS = 64


def attention(q, k, v):
    """softmax(q·kᵀ·d^-½)·v over ``[B, S, H, D]``, fp32 logits, in blocks of
    ``ATTN_BLOCK_ROWS`` (batch, head) rows."""
    b, s, h, d = q.shape
    if nets._CALLS is not None:
        nets._CALLS.append(("attn", (b, s, k.shape[1], h, d), False))
    qh, kh, vh = (t.transpose(1, 2).reshape(b * h, t.shape[1], d) for t in (q, k, v))
    out = torch.empty_like(qh)
    for i in range(0, b * h, ATTN_BLOCK_ROWS):
        sl = slice(i, i + ATTN_BLOCK_ROWS)
        logits = torch.bmm(qh[sl].float(), kh[sl].float().transpose(1, 2)) * d ** -0.5
        out[sl] = torch.bmm(torch.softmax(logits, -1).to(v.dtype), vh[sl])
    return out.view(b, h, s, d).transpose(1, 2)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """The source's ``timestep_embedding``: [N] → [N, dim] fp32, cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim=None, heads=8, dim_head=64):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Identity())

    def forward(self, x, context=None):
        context = x if context is None else context
        b, sq, sk = x.shape[0], x.shape[1], context.shape[1]
        q = self.to_q(x).view(b, sq, self.heads, self.dim_head)
        k = self.to_k(context).view(b, sk, self.heads, self.dim_head)
        v = self.to_v(context).view(b, sk, self.heads, self.dim_head)
        return self.to_out(attention(q, k, v).reshape(b, sq, self.heads * self.dim_head))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head)
        self.ff = nets.FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm1, self.norm2, self.norm3 = (nn.LayerNorm(dim) for _ in range(3))

    def forward(self, x, context):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class VideoTransformerBlock(nn.Module):
    """``ff_in`` (residual), self-attention, cross-attention, ``ff``, over
    ``[B·S, T, C]``."""

    def __init__(self, dim, n_heads, d_head, context_dim):
        super().__init__()
        self.norm_in = nn.LayerNorm(dim)
        self.ff_in = nets.FeedForward(dim)
        self.attn1 = CrossAttention(dim, None, n_heads, d_head)
        self.norm2 = nn.LayerNorm(dim)
        self.ff = nets.FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm3 = nn.LayerNorm(dim)

    def forward(self, x, context):
        x = self.ff_in(self.norm_in(x)) + x
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class AlphaBlender(nn.Module):
    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([0.5]))

    def forward(self, x_spatial, x_temporal):
        alpha = torch.sigmoid(self.mix_factor)
        return alpha * x_spatial + (1.0 - alpha) * x_temporal


class SpatialVideoTransformer(nn.Module):
    def __init__(self, ch, n_heads, d_head, context_dim, frames):
        super().__init__()
        self.frames = frames
        self.norm = nn.GroupNorm(32, ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, n_heads * d_head)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(ch, n_heads, d_head, context_dim)])
        self.proj_out = nn.Linear(n_heads * d_head, ch)
        self.time_stack = nn.ModuleList([VideoTransformerBlock(ch, n_heads, d_head, context_dim)])
        self.time_pos_embed = nn.Sequential(nn.Linear(ch, 4 * ch), nn.SiLU(),
                                            nn.Linear(4 * ch, ch))
        self.time_mixer = AlphaBlender()

    def forward(self, x, context):
        bt, c, hh, ww = x.shape
        t, s = self.frames, hh * ww
        x_in = x
        time_context = context[::t].repeat_interleave(s, dim=0)  # "(b n)", n = h·w
        x = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(bt, s, c))
        frame = torch.arange(t, device=x.device).repeat(bt // t)
        emb = self.time_pos_embed(timestep_embedding(frame, c))[:, None, :]
        for block, mix_block in zip(self.transformer_blocks, self.time_stack):
            x = block(x, context)
            x_mix = (x + emb).reshape(bt // t, t, s, c).transpose(1, 2).reshape(-1, t, c)
            x_mix = mix_block(x_mix, time_context)
            x_mix = x_mix.reshape(bt // t, s, t, c).transpose(1, 2).reshape(bt, s, c)
            x = self.time_mixer(x, x_mix)
        x = self.proj_out(x)
        return x.reshape(bt, hh, ww, c).permute(0, 3, 1, 2) + x_in


class ResBlock(nn.Module):
    """The source's ResBlock at dims 2 (spatial) or 3 (``time_stack``, kernel
    (3, 1, 1), the frame embedding broadcast over H and W)."""

    def __init__(self, ch, emb_ch, out_ch, dims=2):
        super().__init__()
        conv = (lambda a, b: nn.Conv2d(a, b, 3, padding=1)) if dims == 2 else \
            (lambda a, b: nn.Conv3d(a, b, (3, 1, 1), padding=(1, 0, 0)))
        self.dims = dims
        self.in_layers = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(), conv(ch, out_ch))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, out_ch))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, out_ch), nn.SiLU(), nn.Identity(),
                                        conv(out_ch, out_ch))
        self.skip_connection = nn.Identity() if out_ch == ch else nn.Conv2d(ch, out_ch, 1)

    def forward(self, x, emb):
        h = self.in_layers(x)
        e = self.emb_layers(emb)
        if self.dims == 3:  # emb [B, T, C] → [B, C, T, 1, 1]
            e = e.permute(0, 2, 1)
        while e.dim() < h.dim():
            e = e[..., None]
        return self.skip_connection(x) + self.out_layers(h + e)


class VideoResBlock(ResBlock):
    def __init__(self, ch, emb_ch, out_ch, frames):
        super().__init__(ch, emb_ch, out_ch)
        self.frames = frames
        self.time_stack = ResBlock(out_ch, emb_ch, out_ch, dims=3)
        self.time_mixer = AlphaBlender()

    def forward(self, x, emb):
        x = super().forward(x, emb)
        bt, c, hh, ww = x.shape
        t = self.frames
        x5 = x.reshape(bt // t, t, c, hh, ww).permute(0, 2, 1, 3, 4)
        xt = self.time_stack(x5, emb.reshape(bt // t, t, -1))
        out = self.time_mixer(x5, xt)
        return out.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww)


class Sequential(nn.ModuleList):
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
    """``forward(x [B·T, C_in, H, W], timesteps [B·T], context, y)`` → fp32."""

    def __init__(self, in_channels=8, model_channels=320, out_channels=4, num_res_blocks=2,
                 attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
                 num_head_channels=64, context_dim=1024, adm_in_channels=1280, num_frames=21):
        super().__init__()
        mc, t = model_channels, num_frames
        emb = mc * 4
        self.model_channels = mc
        self.time_embed = nn.Sequential(nn.Linear(mc, emb), nn.SiLU(), nn.Linear(emb, emb))
        self.label_emb = nn.Sequential(nn.Sequential(nn.Linear(adm_in_channels, emb), nn.SiLU(),
                                                     nn.Linear(emb, emb)))
        attn = lambda ch: SpatialVideoTransformer(ch, ch // num_head_channels,
                                                  num_head_channels, context_dim, t)
        self.input_blocks = nn.ModuleList([Sequential([nn.Conv2d(in_channels, mc, 3, padding=1)])])
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [VideoResBlock(ch, emb, mult * mc, t)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                self.input_blocks.append(Sequential(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(Sequential([nets.Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = Sequential([VideoResBlock(ch, emb, ch, t), attn(ch),
                                        VideoResBlock(ch, emb, ch, t)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [VideoResBlock(ch + chans.pop(), emb, mc * mult, t)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(nets.Upsample(ch))
                    ds //= 2
                self.output_blocks.append(Sequential(layers))
        self.out = nn.Sequential(nn.GroupNorm(32, ch), nn.SiLU(),
                                 nn.Conv2d(mc, out_channels, 3, padding=1))

    @property
    def dtype(self):
        return self.out[2].weight.dtype

    def forward(self, x, timesteps, context, y):
        dt = self.dtype
        emb = self.time_embed(timestep_embedding(timesteps, self.model_channels).to(dt))
        emb = emb + self.label_emb(y.to(dt))
        context, h, hs = context.to(dt), x.to(dt), []
        for module in self.input_blocks:
            h = module(h, emb, context)
            hs.append(h)
        h = self.middle_block(h, emb, context)
        for module in self.output_blocks:
            h = module(torch.cat([h, hs.pop()], dim=1), emb, context)
        return self.out(h).float()


# ------------------------------------------------------------------ sampling


def sigmas(steps: int, sigma_min: float, sigma_max: float, rho: float) -> List[float]:
    """``EDMDiscretization``: ``steps`` σ from σ_max to σ_min, then 0."""
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return [(hi + i / (steps - 1) * (lo - hi)) ** rho for i in range(steps)] + [0.0]


def scalings(sigma: float):
    """``VScalingWithEDMcNoise``: (c_skip, c_out, c_in, c_noise)."""
    return (1.0 / (sigma ** 2 + 1.0), -sigma / (sigma ** 2 + 1.0) ** 0.5,
            1.0 / (sigma ** 2 + 1.0) ** 0.5, 0.25 * math.log(sigma))


def triangle(frames: int, max_scale: float, min_scale: float = 1.0, period: float = 1.0):
    """``TrianglePredictionGuider``'s scale [frames]."""
    values = torch.linspace(0, 1, frames, dtype=torch.float64)
    wave = 2 * (values / period - torch.floor(values / period + 0.5)).abs()
    return (wave * (max_scale - min_scale) + min_scale).float()


def orbit(frames: int, elevations_deg: Sequence[float]):
    """The script's polar angles (90° − elevation) and azimuths (evenly
    spaced, the last frame at the input's view), in radians."""
    az = np.linspace(0, 360, frames + 1)[1:] % 360
    az = np.deg2rad((az - az[-1]) % 360)
    pol = np.deg2rad(90 - np.broadcast_to(np.asarray(elevations_deg, np.float64), (frames,)))
    return pol, az


def camera_vector(cond_aug: float, polars, azimuths, device) -> torch.Tensor:
    """[frames, 1280]: ConcatTimestepEmbedderND of cond_aug (256), the polar
    angles (512) and the azimuths (512)."""
    pol = torch.as_tensor(np.asarray(polars), device=device).float()
    azi = torch.as_tensor(np.asarray(azimuths), device=device).float()
    return torch.cat([timestep_embedding(torch.full_like(pol, cond_aug), 256),
                      timestep_embedding(pol, 512), timestep_embedding(azi, 512)], dim=1)


def build_models(config: dict) -> Dict[str, nn.Module]:
    """The configuration's models on the current default device."""
    p, m = config["pipeline"], config["models"]
    return {"unet": VideoUNet(**p["VideoUNet"]), "vae": nets.VAE(**m["vae"]),
            "clip": nets.CLIPVisual(**m["clip_visual"])}


class Reference:
    """The configuration's models in float32 from the benchmark's state
    dicts, and each stage of a request worked out again."""

    def __init__(self, config: dict, state_dicts, device, models=None):
        p = config["pipeline"]
        self.device = torch.device(device)
        if models is None:
            with torch.device("meta"):
                models = build_models(config)
            for name, mod in models.items():
                mod.to_empty(device=self.device)
                mod.load_state_dict({k: v.to(self.device, torch.float32)
                                     for k, v in state_dicts[name].items()}, strict=True)
                mod.eval().requires_grad_(False)
        self.m = models
        s = p["Sampler"]
        self.sigmas = sigmas(int(s["num_steps"]), float(s["sigma_min"]), float(s["sigma_max"]),
                             float(s["rho"]))
        g = s["guider"]
        self.frames = int(p["VideoUNet"]["num_frames"])
        self.scale = triangle(self.frames, float(g["max_scale"]), float(g["min_scale"]),
                              float(g["period"])).to(self.device)
        self.res = int(p["resolution"][0])
        self.h = self.res // int(p["scale"])
        self.cond_aug, self.scale_factor = float(p["cond_aug"]), float(p["scale_factor"])

    @torch.no_grad()
    def conditioning(self, item: dict, elevations) -> Dict[str, torch.Tensor]:
        """``token`` [1, 1, 1024], ``latent`` [1, 4, h, w] (the VAE's mode of
        the image plus cond_aug times the seed's second draw) and ``vector``
        [T, 1280] of a request."""
        x = torch.as_tensor(white_composite(item["image"], self.res), device=self.device)
        x = x.permute(2, 0, 1)[None] * 2.0 - 1.0
        gen = torch.Generator(device=self.device).manual_seed(int(item["seed"]))
        torch.randn((self.frames, 4, self.h, self.h), generator=gen, device=self.device)
        aug = torch.randn((1, 3, self.res, self.res), generator=gen, device=self.device)
        x224 = F.interpolate((x + 1.0) / 2.0, size=(224, 224), mode="bilinear", antialias=True,
                             align_corners=False)
        mean = torch.tensor(VIT_MEAN, device=self.device).reshape(1, 3, 1, 1)
        std = torch.tensor(VIT_STD, device=self.device).reshape(1, 3, 1, 1)
        token = self.m["clip"]((x224 - mean) / std).float()[:, None]
        latent = self.m["vae"].encode_mode(x + self.cond_aug * aug).float()
        pol, azi = orbit(self.frames, elevations)
        return {"token": token, "latent": latent,
                "vector": camera_vector(self.cond_aug, pol, azi, self.device)}

    @torch.no_grad()
    def guided_output(self, x: torch.Tensor, i: int, c: Dict[str, torch.Tensor]):
        """The triangle-guided network output ``F_u + s_f·(F_c − F_u)`` at
        step ``i`` from the state ``x`` [T, 4, h, w] (the uncond rows: zero
        token, zero latent, the same camera vectors)."""
        t = self.frames
        c_skip, c_out, c_in, c_noise = scalings(self.sigmas[i])
        xin = torch.cat([x.float() * c_in, c["latent"].expand(t, -1, -1, -1)], 1)
        xin_u = torch.cat([x.float() * c_in, torch.zeros_like(xin[:, 4:])], 1)
        ctx = c["token"].expand(t, -1, -1)
        tt = torch.full((2 * t,), c_noise, device=self.device)
        out = self.m["unet"](torch.cat([xin, xin_u]), tt, torch.cat([ctx, torch.zeros_like(ctx)]),
                             torch.cat([c["vector"], c["vector"]]))
        f_c, f_u = out[:t].double(), out[t:].double()
        return f_u + self.scale.double()[:, None, None, None] * (f_c - f_u)

    def implied_output(self, x: torch.Tensor, x_next: torch.Tensor, i: int) -> torch.Tensor:
        """The guided network output that the program's Euler update from
        ``x`` to ``x_next`` at step ``i`` used: ``D = x − σ_i(x_next − x)/
        (σ_{i+1} − σ_i)``, ``F = (D − c_skip·x)/c_out``, float64."""
        s0, s1 = self.sigmas[i], self.sigmas[i + 1]
        x, x_next = x.double(), x_next.double()
        d = x - s0 * (x_next - x) / (s1 - s0)
        c_skip, c_out, _, _ = scalings(s0)
        return (d - c_skip * x) / c_out

    @torch.no_grad()
    def frames_of(self, latents: torch.Tensor, chunk: int = 7) -> torch.Tensor:
        """Final latents [T, 4, h, w] → uint8 views [T, R, R, 3]."""
        z = latents.float() / self.scale_factor
        out = []
        for s in range(0, z.shape[0], chunk):
            img = (self.m["vae"].decode(z[s:s + chunk]) * 0.5 + 0.5).clamp(0.0, 1.0)
            out.append(torch.round(img * 255.0).to(torch.uint8).permute(0, 2, 3, 1))
        return torch.cat(out)
