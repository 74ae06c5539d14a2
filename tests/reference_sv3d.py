"""A plain fp32 reference of Stable Video 3D (``sv3d_p``) for the port's
CPU tests: SVD's ``VideoUNet`` written as functions over a state dict (the
source checkpoint's keys; each block's kind is read off its keys), the
v-scaling EDM denoiser, the Euler loop, the triangle guidance and the camera
vector, from the source (Stability-AI/generative-models:
``video_model.py``, ``openaimodel.py``, ``video_attention.py``,
``denoiser_scaling.py``, ``guiders.py``, ``sampling.py``,
``discretizer.py``, ``scripts/sampling/simple_video_sample.py``).

It imports no kernel of the port and no JAX; the CLIP visual tower and the
SD VAE are ``mvbench/reference/nets.py``'s plain copies. Attention is one
softmax over fp32 logits (the tests' sizes are small).

Departures from the source, as the port makes them: ``image_only_indicator``
(all zeros in SV3D) is not an input, so each ``AlphaBlender`` is
``sigmoid(mix_factor)``; the image is composited on white and resized, its
CLIP resize is bilinear and antialiased; the last view is decoded, not the
input image pasted over it.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def temb(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _lin(x, w: Weights, p: str):
    return F.linear(x, w[p + ".weight"], w.get(p + ".bias"))


def _gn(x, w: Weights, p: str, eps: float):
    return F.group_norm(x, 32, w[p + ".weight"], w[p + ".bias"], eps)


def _ln(x, w: Weights, p: str):
    return F.layer_norm(x, x.shape[-1:], w[p + ".weight"], w[p + ".bias"], 1e-5)


def _ff(x, w: Weights, p: str):
    a, gate = _lin(x, w, p + ".net.0.proj").chunk(2, dim=-1)
    return _lin(a * F.gelu(gate), w, p + ".net.2")


def _attn(x, ctx, w: Weights, p: str, head: int):
    q, k, v = (_lin(t, w, p + n) for t, n in ((x, ".to_q"), (ctx, ".to_k"), (ctx, ".to_v")))
    b, sq, inner = q.shape
    h = inner // head
    q, k, v = (t.reshape(b, -1, h, head).transpose(1, 2) for t in (q, k, v))
    probs = torch.softmax(q @ k.transpose(-1, -2) * head ** -0.5, dim=-1)
    return _lin((probs @ v).transpose(1, 2).reshape(b, sq, inner), w, p + ".to_out.0")


def _resblock(x, emb, w: Weights, p: str, conv):
    """GN/SiLU/conv, + emb, GN/SiLU/conv, + skip; ``emb`` broadcast to x."""
    h = conv(F.silu(_gn(x, w, p + ".in_layers.0", 1e-5)), w, p + ".in_layers.2")
    h = h + emb
    h = conv(F.silu(_gn(h, w, p + ".out_layers.0", 1e-5)), w, p + ".out_layers.3")
    skip = conv(x, w, p + ".skip_connection") if p + ".skip_connection.weight" in w else x
    return skip + h


def _conv2d(x, w, p):
    k = w[p + ".weight"]
    return F.conv2d(x, k, w[p + ".bias"], padding=k.shape[-1] // 2)


def _conv3d(x, w, p):
    return F.conv3d(x, w[p + ".weight"], w[p + ".bias"], padding=(1, 0, 0))


def _alpha(w: Weights, p: str):
    return torch.sigmoid(w[p + ".time_mixer.mix_factor"])


def video_resblock(x, emb, w: Weights, p: str, frames: int):
    e = _lin(F.silu(emb), w, p + ".emb_layers.1")[:, :, None, None]
    x = _resblock(x, e, w, p, _conv2d)
    bt, c, hh, ww = x.shape
    x5 = x.reshape(bt // frames, frames, c, hh, ww).permute(0, 2, 1, 3, 4)
    et = _lin(F.silu(emb), w, p + ".time_stack.emb_layers.1").reshape(bt // frames, frames, c)
    xt = _resblock(x5, et.permute(0, 2, 1)[..., None, None], w, p + ".time_stack", _conv3d)
    a = _alpha(w, p)
    out = a * x5 + (1 - a) * xt
    return out.permute(0, 2, 1, 3, 4).reshape(bt, c, hh, ww)


def video_transformer(x, ctx, w: Weights, p: str, frames: int, head: int):
    bt, c, hh, ww = x.shape
    s = hh * ww
    x_in = x
    h = _lin(_gn(x, w, p + ".norm", 1e-6).permute(0, 2, 3, 1).reshape(bt, s, c), w,
             p + ".proj_in")
    b0 = p + ".transformer_blocks.0"
    h = h + _attn(_ln(h, w, b0 + ".norm1"), _ln(h, w, b0 + ".norm1"), w, b0 + ".attn1", head)
    h = h + _attn(_ln(h, w, b0 + ".norm2"), ctx, w, b0 + ".attn2", head)
    h = h + _ff(_ln(h, w, b0 + ".norm3"), w, b0 + ".ff")
    pos = _lin(F.silu(_lin(temb(torch.arange(frames), c), w, p + ".time_pos_embed.0")), w,
               p + ".time_pos_embed.2")
    t0 = p + ".time_stack.0"
    m = (h.reshape(bt // frames, frames, s, c) + pos[None, :, None]).transpose(1, 2)
    m = m.reshape(-1, frames, c)
    tctx = ctx[::frames].repeat_interleave(s, dim=0)
    m = m + _ff(_ln(m, w, t0 + ".norm_in"), w, t0 + ".ff_in")
    n1 = _ln(m, w, t0 + ".norm1")
    m = m + _attn(n1, n1, w, t0 + ".attn1", head)
    m = m + _attn(_ln(m, w, t0 + ".norm2"), tctx, w, t0 + ".attn2", head)
    m = m + _ff(_ln(m, w, t0 + ".norm3"), w, t0 + ".ff")
    m = m.reshape(bt // frames, s, frames, c).transpose(1, 2).reshape(bt, s, c)
    a = _alpha(w, p)
    h = a * h + (1 - a) * m
    return _lin(h, w, p + ".proj_out").reshape(bt, hh, ww, c).permute(0, 3, 1, 2) + x_in


def _block(h, emb, ctx, w: Weights, p: str, frames: int, head: int):
    j = 0
    while any(k.startswith(f"{p}.{j}.") for k in w) or f"{p}.{j}.weight" in w:
        q = f"{p}.{j}"
        if q + ".weight" in w:                        # the input convolution
            h = _conv2d(h, w, q)
        elif q + ".op.weight" in w:                   # Downsample
            h = F.conv2d(h, w[q + ".op.weight"], w[q + ".op.bias"], stride=2, padding=1)
        elif q + ".conv.weight" in w:                 # Upsample
            h = _conv2d(F.interpolate(h, scale_factor=2, mode="nearest"), w, q + ".conv")
        elif q + ".time_stack.in_layers.2.weight" in w:
            h = video_resblock(h, emb, w, q, frames)
        else:
            h = video_transformer(h, ctx, w, q, frames, head)
        j += 1
    return h


def unet(w: Weights, x, t, ctx, y, frames: int, head: int = 64):
    """The VideoUNet of ``w``: x [B·T, C, H, W], t [B·T] (c_noise), ctx
    [B·T, L, D], y [B·T, adm] → [B·T, out, H, W]."""
    mc = w["time_embed.0.weight"].shape[1]
    emb = _lin(F.silu(_lin(temb(t, mc), w, "time_embed.0")), w, "time_embed.2")
    emb = emb + _lin(F.silu(_lin(y, w, "label_emb.0.0")), w, "label_emb.0.2")
    hs, h = [], x
    n_in = 1 + max(int(k.split(".")[1]) for k in w if k.startswith("input_blocks."))
    for i in range(n_in):
        h = _block(h, emb, ctx, w, f"input_blocks.{i}", frames, head)
        hs.append(h)
    h = _block(h, emb, ctx, w, "middle_block", frames, head)
    n_out = 1 + max(int(k.split(".")[1]) for k in w if k.startswith("output_blocks."))
    for i in range(n_out):
        h = _block(torch.cat([h, hs.pop()], 1), emb, ctx, w, f"output_blocks.{i}", frames, head)
    return _conv2d(F.silu(_gn(h, w, "out.0", 1e-5)), w, "out.2")


# ------------------------------------------------------------------ sampling


def sigmas(steps: int, sigma_min=0.002, sigma_max=700.0, rho=7.0) -> List[float]:
    ramp = np.linspace(0, 1, steps)
    lo, hi = sigma_min ** (1 / rho), sigma_max ** (1 / rho)
    return [float(v) for v in (hi + ramp * (lo - hi)) ** rho] + [0.0]


def triangle(frames: int, max_scale=2.5, min_scale=1.0, period=1.0) -> torch.Tensor:
    v = np.linspace(0, 1, frames) / period
    return torch.tensor((2 * np.abs(v - np.floor(v + 0.5))) * (max_scale - min_scale)
                        + min_scale, dtype=torch.float32)


def camera_vector(cond_aug: float, elevations_deg, frames: int) -> torch.Tensor:
    """cond_aug (256), polar = 90° − elevation (512), azimuth (512); the
    azimuths of simple_video_sample.py (the last frame at 0)."""
    az = np.linspace(0, 360, frames + 1)[1:] % 360
    az = np.deg2rad((az - az[-1]) % 360)
    pol = np.deg2rad(90.0 - np.broadcast_to(np.asarray(elevations_deg, np.float64), (frames,)))
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    return torch.cat([temb(torch.full((frames,), float(cond_aug)), 256),
                      temb(f32(pol), 512), temb(f32(az), 512)], dim=1)


def guided_output(w: Weights, x, sigma: float, token, latent, vector, scale, head=64):
    """F_u + s_f·(F_c − F_u) from x [T, 4, h, w]; uncond: zero token and latent."""
    t = x.shape[0]
    c_in = (sigma ** 2 + 1) ** -0.5
    xin = torch.cat([torch.cat([x * c_in, latent.expand(t, -1, -1, -1)], 1),
                     torch.cat([x * c_in, torch.zeros_like(latent).expand(t, -1, -1, -1)], 1)])
    ctx = torch.cat([token.expand(t, -1, -1), torch.zeros_like(token).expand(t, -1, -1)])
    out = unet(w, xin, torch.full((2 * t,), 0.25 * math.log(sigma)), ctx,
               torch.cat([vector, vector]), t, head)
    return out[t:] + scale[:, None, None, None] * (out[:t] - out[t:])


def denoised(w: Weights, x, sigma: float, token, latent, vector, scale, head=64):
    """D = c_skip·x + c_out·F under the triangle guidance."""
    c_skip, c_out = 1 / (sigma ** 2 + 1), -sigma / (sigma ** 2 + 1) ** 0.5
    return c_skip * x + c_out * guided_output(w, x, sigma, token, latent, vector, scale, head)


def euler(w: Weights, noise, sig: List[float], token, latent, vector, scale, head=64):
    x = noise * math.sqrt(1 + sig[0] ** 2)
    for s0, s1 in zip(sig[:-1], sig[1:]):
        d = denoised(w, x, s0, token, latent, vector, scale, head)
        x = x + (s1 - s0) * (x - d) / s0
    return x
