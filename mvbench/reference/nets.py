"""The models of both configurations in plain PyTorch, for the benchmark's
reference: the T2V and I2V video UNets, the SD KL-VAE, the OpenCLIP ViT-H
text and visual towers and the LGM (``big``).

A frozen copy of the module code of the measured port with every kernel and
every multi-device path taken out: attention is ``softmax(q kᵀ / √d) v`` in
the module's dtype with fp32 logits, the GEGLU feed-forward is two linears
and an exact GELU, the temporal blocks attend over the frame axis of one
sample. Module and parameter names are the released checkpoints', so one
state dict loads into this code and into the port alike. It imports nothing
of the port. The check runs it in float32 with TF32 off.

``record_calls()`` lists every attention and feed-forward call with its
shape: the benchmark counts the work of a cell from it (on the meta device,
at the cell's shapes).
"""

from __future__ import annotations

import contextlib
import math
from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

_CALLS: Optional[list] = None


@contextlib.contextmanager
def record_calls():
    """Within the block, every ``attention`` call appends ``("attn", (B, S_q,
    S_kv, H, D), masked)`` and every GEGLU feed-forward ``("ffn", (T, C,
    inner))`` to the list it yields."""
    global _CALLS
    saved, _CALLS = _CALLS, []
    try:
        yield _CALLS
    finally:
        _CALLS = saved


def attention(q, k, v, bias=None, mask=None):
    """softmax(q·kᵀ·d^-½ [+ bias] [masked]) · v over ``[B, S, H, D]``,
    logits and softmax in fp32."""
    if _CALLS is not None:
        b, s, h, d = q.shape
        _CALLS.append(("attn", (b, s, k.shape[1], h, d), bias is not None or mask is not None))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def sinusoidal_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] -> [B, dim] float32; cos first, then sin."""
    half = dim // 2
    t = timesteps.float()
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32, device=t.device) / half)
    sinusoid = torch.outer(t, freqs)
    return torch.cat([torch.cos(sinusoid), torch.sin(sinusoid)], dim=1)


# ------------------------------------------------------------------ UNet


class TimestepMLP(nn.Sequential):
    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__(nn.Linear(in_dim, embed_dim), nn.SiLU(), nn.Linear(embed_dim, embed_dim))


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
        b, s_q = x.shape[:2]
        s_kv = context.shape[1]
        q = self.to_q(x).view(b, s_q, self.heads, self.dim_head)
        k = self.to_k(context).view(b, s_kv, self.heads, self.dim_head)
        v = self.to_v(context).view(b, s_kv, self.heads, self.dim_head)
        return self.to_out(attention(q, k, v).reshape(b, s_q, self.heads * self.dim_head))


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, self.inner), nn.Identity(),
                                 nn.Linear(self.inner, dim))

    def forward(self, x):
        if _CALLS is not None:
            _CALLS.append(("ffn", (math.prod(x.shape[:-1]), x.shape[-1], self.inner)))
        hx, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](hx * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim=None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Self + cross attention over the H·W tokens of each frame."""

    def __init__(self, in_channels, n_heads, d_head, context_dim=None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, n_heads, d_head, context_dim)])
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x, context):
        bf, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(bf, hh * ww, c))
        for block in self.transformer_blocks:
            h = block(h, context)
        h = self.proj_out(h)
        return h.reshape(bf, hh, ww, c).permute(0, 3, 1, 2) + x


class TemporalTransformer(nn.Module):
    """Self-attention over the frames of each pixel: [B, C, F, H, W]."""

    def __init__(self, in_channels, n_heads, d_head):
        super().__init__()
        inner = n_heads * d_head
        self.norm = nn.GroupNorm(32, in_channels, eps=1e-6)
        self.proj_in = nn.Conv1d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, n_heads, d_head, None)])
        self.proj_out = nn.Conv1d(inner, in_channels, 1)

    def forward(self, x):
        b, c, f, hh, ww = x.shape
        s = hh * ww
        x4 = x.reshape(b, c, f, s)
        h = self.norm(x4).permute(0, 3, 2, 1).reshape(b * s, f, c)
        h = F.linear(h, self.proj_in.weight[:, :, 0], self.proj_in.bias)
        for block in self.transformer_blocks:
            h = block(h, None)
        h = F.linear(h, self.proj_out.weight[:, :, 0], self.proj_out.bias)
        return (x4 + h.reshape(b, s, f, -1).permute(0, 3, 2, 1)).reshape(x.shape)


def _tconv(c_in, c_out, dropout: bool):
    layers = [nn.GroupNorm(32, c_in, eps=1e-5), nn.SiLU()]
    if dropout:
        layers.append(nn.Identity())
    return nn.Sequential(*layers, nn.Conv3d(c_in, c_out, (3, 1, 1), padding=(1, 0, 0)))


class TemporalConvBlockV2(nn.Module):
    def __init__(self, in_dim, out_dim=None):
        super().__init__()
        out_dim = out_dim or in_dim
        self.conv1 = _tconv(in_dim, out_dim, False)
        self.conv2 = _tconv(out_dim, in_dim, True)
        self.conv3 = _tconv(in_dim, in_dim, True)
        self.conv4 = _tconv(in_dim, in_dim, True)

    def forward(self, x):
        return x + self.conv4(self.conv3(self.conv2(self.conv1(x))))


class ResBlock(nn.Module):
    def __init__(self, channels, emb_channels, out_channels=None):
        super().__init__()
        out_ch = out_channels or channels
        self.in_layers = nn.Sequential(nn.GroupNorm(32, channels, eps=1e-5), nn.SiLU(),
                                       nn.Conv2d(channels, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out_ch))
        self.out_layers = nn.Sequential(nn.GroupNorm(32, out_ch, eps=1e-5), nn.SiLU(),
                                        nn.Identity(), nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = (nn.Identity() if out_ch == channels
                                else nn.Conv2d(channels, out_ch, 1))
        self.temopral_conv = TemporalConvBlockV2(out_ch, out_ch)  # [sic], the released key

    def forward(self, x, emb, frames):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None].to(h.dtype)
        h = self.skip_connection(x) + self.out_layers(h)
        bf, c, hh, ww = h.shape
        ht = self.temopral_conv(h.reshape(bf // frames, frames, c, hh, ww).permute(0, 2, 1, 3, 4))
        return ht.permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)


class Upsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


def unet_plan(dim, dim_mult, num_res_blocks, attn_scales):
    """The encoder and decoder blocks as lists of ``(kind, name, c_in,
    c_out)`` (reference unet_t2v.py:167-258, temporal attention on)."""
    enc_dims = [dim * u for u in [1] + list(dim_mult)]
    dec_dims = [dim * u for u in [dim_mult[-1]] + list(dim_mult)[::-1]]
    enc = [[("conv_in", "input_blocks_0_0", None, dim), ("temporal", "input_blocks_0_1", dim, dim)]]
    skips, scale, idx = [dim], 1.0, 1
    for i, (cin, cout) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
        for j in range(num_res_blocks):
            entry = [("res", f"input_blocks_{idx}_0", cin, cout)]
            if scale in attn_scales:
                entry += [("spatial", "", cout, cout), ("temporal", "", cout, cout)]
            enc.append(entry)
            skips.append(cout)
            cin, idx = cout, idx + 1
            if i != len(dim_mult) - 1 and j == num_res_blocks - 1:
                enc.append([("down", "", cout, cout)])
                skips.append(cout)
                scale /= 2.0
                idx += 1
    dec = []
    for i, (cin, cout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
        for j in range(num_res_blocks + 1):
            entry = [("res", "", cin + skips.pop(), cout)]
            if scale in attn_scales:
                entry += [("spatial", "", cout, cout), ("temporal", "", cout, cout)]
            cin = cout
            if i != len(dim_mult) - 1 and j == num_res_blocks:
                entry.append(("up", "", cout, cout))
                scale *= 2.0
            dec.append(entry)
    return enc, dec


class UNetT2V(nn.Module):
    """``UNetSD_T2VBase`` (transformer temporal blocks, camera condition):
    ``forward(x [B, C, F, H, W], t [B], y [B, L, Cc], camera_data [B, F, 16])``
    → [B, C, F, H, W] float32."""

    def __init__(self, in_dim=4, dim=320, context_dim=1024, out_dim=4, dim_mult=(1, 2, 4, 4),
                 num_heads=8, head_dim=64, num_res_blocks=2, attn_scales=(1.0, 0.5, 0.25),
                 camera_dim=16, conv_in_dim=None, y_dim=None):
        super().__init__()
        self.dim, self.out_dim, self.head_dim, self.num_heads = dim, out_dim, head_dim, num_heads
        self.camera_dim, self.context_dim = camera_dim, context_dim
        embed = dim * 4
        self.time_embed = TimestepMLP(dim, embed)
        self.camera_embedding = TimestepMLP(camera_dim, embed)
        enc, dec = unet_plan(dim, tuple(dim_mult), num_res_blocks, tuple(attn_scales))
        self.input_blocks = nn.ModuleList()
        for entry in enc:
            if entry[0][0] == "down":
                self.input_blocks.append(self._block(conv_in_dim or in_dim, *entry[0]))
            else:
                self.input_blocks.append(
                    nn.ModuleList(self._block(conv_in_dim or in_dim, *e) for e in entry))
        mid = dim * dim_mult[-1]
        self.middle_block = nn.ModuleList([
            self._block(in_dim, "res", "", mid, mid), self._block(in_dim, "spatial", "", mid, mid),
            self._block(in_dim, "temporal", "", mid, mid),
            self._block(in_dim, "res", "", mid, mid)])
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(self._block(in_dim, *e) for e in entry) for entry in dec)
        self.out = nn.Sequential(nn.GroupNorm(32, dim, eps=1e-5), nn.SiLU(),
                                 nn.Conv2d(dim, out_dim, 3, padding=1))

    def _block(self, in_dim, kind, name, cin, cout):
        if kind == "conv_in":
            return nn.Conv2d(in_dim, cout, 3, padding=1)
        if kind == "res":
            return ResBlock(cin, self.dim * 4, cout)
        if kind == "spatial":
            return SpatialTransformer(cout, cout // self.head_dim, self.head_dim, self.context_dim)
        if kind == "temporal":
            heads = self.num_heads if name == "input_blocks_0_1" else cout // self.head_dim
            return TemporalTransformer(cout, heads, self.head_dim)
        if kind == "down":
            return Downsample(cout)
        return Upsample(cout)

    @property
    def dtype(self):
        return self.out[2].weight.dtype

    def _run(self, blocks, h, e, context, b, f):
        for mod in (blocks if isinstance(blocks, nn.ModuleList) else (blocks,)):
            if isinstance(mod, ResBlock):
                h = mod(h, e, f)
            elif isinstance(mod, SpatialTransformer):
                h = mod(h, context)
            elif isinstance(mod, TemporalTransformer):
                bf, c, hh, ww = h.shape
                ht = mod(h.reshape(b, f, c, hh, ww).permute(0, 2, 1, 3, 4))
                h = ht.permute(0, 2, 1, 3, 4).reshape(bf, c, hh, ww)
            else:
                h = mod(h)
        return h

    def embed(self, t, camera_data, f):
        b = t.shape[0]
        e = self.time_embed(sinusoidal_embedding(t, self.dim).to(self.dtype))
        e = e.repeat_interleave(f, dim=0)
        return e + self.camera_embedding(camera_data.reshape(b * f, self.camera_dim).to(self.dtype))

    def backbone(self, h, e, context, b, f):
        xs = []
        for blocks in self.input_blocks:
            h = self._run(blocks, h, e, context, b, f)
            xs.append(h)
        h = self._run(self.middle_block, h, e, context, b, f)
        for blocks in self.output_blocks:
            h = self._run(blocks, torch.cat([h, xs.pop()], dim=1), e, context, b, f)
        return self.out(h)

    def forward(self, x, t, y, camera_data):
        b, c, f, hh, ww = x.shape
        e = self.embed(t, camera_data, f)
        context = y.to(self.dtype).repeat_interleave(f, dim=0)
        h = x.permute(0, 2, 1, 3, 4).reshape(b * f, c, hh, ww).to(self.dtype)
        h = self.backbone(h, e, context, b, f)
        return h.reshape(b, f, self.out_dim, hh, ww).permute(0, 2, 1, 3, 4).float()


class _PackedAttention(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x):
        b, s, _ = x.shape
        q, k, v = (t.reshape(b, s, self.heads, self.dim_head)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        return self.to_out(attention(q, k, v).reshape(b, s, self.heads * self.dim_head))


class PreNormAttention(nn.Module):
    def __init__(self, dim, heads, dim_head):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = _PackedAttention(dim, heads, dim_head)

    def forward(self, x):
        return x + self.fn(self.norm(x))


class _GeluFeedForward(nn.Module):
    def __init__(self, dim, dim_out):
        super().__init__()
        self.net = nn.Sequential(nn.Sequential(nn.Linear(dim, dim * 4), nn.GELU()),
                                 nn.Identity(), nn.Linear(dim * 4, dim_out))

    def forward(self, x):
        return self.net(x)


class TransformerV2(nn.Module):
    def __init__(self, dim, heads, dim_head, mlp_dim):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([PreNormAttention(dim, heads, dim_head),
                                                    _GeluFeedForward(dim, mlp_dim)])])

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x)
            x = x + ff(x)
        return x


class UNetI2V(UNetT2V):
    """``UNetSD_I2VGen``: the T2V backbone with the image adapters (the
    concat plane, added twice as the released weights were trained; 64
    local tokens; 4 global tokens; the fps embedding at fps 8)."""

    def __init__(self, in_dim=4, dim=320, y_dim=1024, context_dim=1024, num_tokens=4, **kw):
        super().__init__(in_dim=in_dim, dim=dim, context_dim=context_dim,
                         conv_in_dim=2 * in_dim, **kw)
        cd, embed = in_dim, dim * 4
        self.concat_dim, self.num_tokens = cd, num_tokens
        self.fps_embedding = TimestepMLP(dim, embed)
        self.local_image_concat = nn.Sequential(
            nn.Conv2d(in_dim, cd * 4, 3, padding=1), nn.SiLU(),
            nn.Conv2d(cd * 4, cd * 4, 3, padding=1), nn.SiLU(),
            nn.Conv2d(cd * 4, cd, 3, padding=1))
        self.local_temporal_encoder = TransformerV2(cd, 2, cd, cd)
        self.local_image_embedding = nn.Sequential(
            nn.Conv2d(in_dim, cd * 8, 3, padding=1), nn.SiLU(), nn.Identity(),
            nn.Conv2d(cd * 8, cd * 16, 3, stride=2, padding=1), nn.SiLU(),
            nn.Conv2d(cd * 16, context_dim, 3, stride=2, padding=1))
        self.context_embedding = nn.Sequential(
            nn.Linear(y_dim, embed), nn.SiLU(), nn.Linear(embed, context_dim * num_tokens))

    def forward(self, x, t, y, camera_data, local_image, image):
        b, c, f, hh, ww = x.shape
        dt = self.dtype
        local = local_image[:, :, :1].to(dt)
        ramp = (torch.arange(1, f, dtype=torch.float32, device=x.device) / (f - 1)).to(dt)
        ximg = torch.cat([local, ramp.reshape(1, 1, f - 1, 1, 1).expand(b, c, f - 1, hh, ww)], 2)
        xi = self.local_image_concat(ximg.permute(0, 2, 1, 3, 4).reshape(b * f, c, hh, ww))
        cd = self.concat_dim
        xi = xi.reshape(b, f, cd, hh, ww).permute(0, 3, 4, 1, 2).reshape(b * hh * ww, f, cd)
        xi = self.local_temporal_encoder(xi).reshape(b, hh, ww, f, cd).permute(0, 3, 4, 1, 2)

        e = self.time_embed(sinusoidal_embedding(t, self.dim).to(dt))
        e = e + self.fps_embedding(sinusoidal_embedding(torch.full_like(t, 8), self.dim).to(dt))
        e = e.repeat_interleave(f, dim=0)
        e = e + self.camera_embedding(camera_data.reshape(b * f, self.camera_dim).to(dt))

        lie = self.local_image_embedding
        lc = lie[1](lie[0](local[:, :, 0]))
        h_l, w_l = lc.shape[-2:]
        if (h_l, w_l) != (32, 32):  # to 32²: block means where the sizes divide, else bilinear
            lc = (F.avg_pool2d(lc, (h_l // 32, w_l // 32)) if h_l % 32 == 0 and w_l % 32 == 0
                  else F.interpolate(lc, size=(32, 32), mode="bilinear", align_corners=False,
                                     antialias=True))
        for layer in list(lie)[3:]:
            lc = layer(lc)
        lc = lc.flatten(2).transpose(1, 2)
        img = self.context_embedding(image.to(dt)).reshape(b, self.num_tokens, self.context_dim)
        context = torch.cat([y.to(dt), lc, img], dim=1).repeat_interleave(f, dim=0)

        h = torch.cat([x.permute(0, 2, 1, 3, 4).to(dt), 2.0 * xi], dim=2)
        h = self.backbone(h.reshape(b * f, c + cd, hh, ww), e, context, b, f)
        return h.reshape(b, f, self.out_dim, hh, ww).permute(0, 2, 1, 3, 4).float()


# ------------------------------------------------------------------- VAE


def _gn6(c):
    return nn.GroupNorm(32, c, eps=1e-6)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.norm1 = _gn6(in_channels)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = _gn6(out_channels)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if out_channels != in_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class VAEAttnBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm = _gn6(c)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(c, c, 1) for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q, k, v = (m(h).reshape(b, c, hh * ww).transpose(1, 2)[:, :, None]
                   for m in (self.q, self.k, self.v))
        h = attention(q, k, v)[:, :, 0].transpose(1, 2).reshape(b, c, hh, ww)
        return x + self.proj_out(h)


class _Level(nn.Module):
    def __init__(self, blocks, resample, name):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, name, resample)


class _Resample(nn.Module):
    def __init__(self, c, down):
        super().__init__()
        self.down = down
        self.conv = nn.Conv2d(c, c, 3, stride=2 if down else 1, padding=0 if down else 1)

    def forward(self, x):
        if self.down:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.block_1, self.attn_1, self.block_2 = VAEResnetBlock(c, c), VAEAttnBlock(c), \
            VAEResnetBlock(c, c)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class VAEEncoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4):
        super().__init__()
        self.conv_in = nn.Conv2d(3, ch, 3, padding=1)
        in_mult = (1,) + tuple(ch_mult)
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            c_in, c_out = ch * in_mult[i], ch * mult
            blocks = [VAEResnetBlock(c_in if j == 0 else c_out, c_out)
                      for j in range(num_res_blocks)]
            last = i == len(ch_mult) - 1
            self.down.append(_Level(blocks, None if last else _Resample(c_out, True),
                                    "downsample"))
        c = ch * ch_mult[-1]
        self.mid = _Mid(c)
        self.norm_out = _gn6(c)
        self.conv_out = nn.Conv2d(c, 2 * z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class VAEDecoder(nn.Module):
    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4):
        super().__init__()
        c = ch * ch_mult[-1]
        self.conv_in = nn.Conv2d(z_channels, c, 3, padding=1)
        self.mid = _Mid(c)
        levels = []
        for i in reversed(range(len(ch_mult))):
            c_out = ch * ch_mult[i]
            blocks = [VAEResnetBlock(c if j == 0 else c_out, c_out)
                      for j in range(num_res_blocks + 1)]
            levels.append(_Level(blocks, _Resample(c_out, False) if i != 0 else None, "upsample"))
            c = c_out
        self.up = nn.ModuleList(levels[::-1])
        self.norm_out = _gn6(c)
        self.conv_out = nn.Conv2d(c, 3, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class VAE(nn.Module):
    """The SD KL-VAE: ``encode_mode`` (the posterior mean, no draw) and
    ``decode``."""

    def __init__(self, ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, z_channels=4):
        super().__init__()
        self.encoder = VAEEncoder(ch, ch_mult, num_res_blocks, z_channels)
        self.decoder = VAEDecoder(ch, ch_mult, num_res_blocks, z_channels)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * z_channels, 1)
        self.post_quant_conv = nn.Conv2d(z_channels, z_channels, 1)

    @property
    def dtype(self):
        return self.post_quant_conv.weight.dtype

    def encode_mode(self, x):
        return self.quant_conv(self.encoder(x.to(self.dtype))).chunk(2, dim=1)[0]

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.to(self.dtype))).float()


# ------------------------------------------------------------------ CLIP


class CLIPAttention(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, bias=None):
        b, s, c = x.shape
        q, k, v = (t.reshape(b, s, self.heads, c // self.heads)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1))
        return self.out_proj(attention(q, k, v, bias=bias).reshape(b, s, c))


class CLIPResBlock(nn.Module):
    def __init__(self, width, heads):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = CLIPAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = nn.Sequential(OrderedDict(
            c_fc=nn.Linear(width, width * 4), gelu=nn.GELU(), c_proj=nn.Linear(width * 4, width)))

    def forward(self, x, bias=None):
        x = x + self.attn(self.ln_1(x), bias)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width, heads, n_blocks):
        super().__init__()
        self.resblocks = nn.ModuleList(CLIPResBlock(width, heads) for _ in range(n_blocks))


class CLIPVisual(nn.Module):
    def __init__(self, image_size=224, patch_size=14, width=1280, heads=16, layers=32,
                 embed_dim=1024):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty((image_size // patch_size) ** 2 + 1, width))
        self.ln_pre = nn.LayerNorm(width, eps=1e-5)
        self.transformer = _Transformer(width, heads, layers)
        self.ln_post = nn.LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.empty(width, embed_dim))

    def forward(self, images):
        x = self.conv1(images.to(self.conv1.weight.dtype)).flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.positional_embedding.to(x.dtype))
        for block in self.transformer.resblocks:
            x = block(x)
        return self.ln_post(x[:, 0]) @ self.proj.to(x.dtype)


class CLIPText(nn.Module):
    """The ViT-H text tower cut to its penultimate block, then ``ln_final``;
    ``visual`` (the I2V configuration) holds the visual tower beside it."""

    def __init__(self, vocab_size=49408, context_length=77, width=1024, heads=16, layers=24,
                 embed_dim=1024, visual: Optional[dict] = None):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.transformer = _Transformer(width, heads, layers - 1)
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))
        if visual is not None:
            self.visual = CLIPVisual(**visual)

    def encode_text(self, tokens):
        """int [B, 77] → the token sequence [B, 77, width]."""
        x = self.token_embedding(tokens) + self.positional_embedding
        s = self.context_length
        causal = torch.triu(torch.full((s, s), float("-inf"), device=x.device), diagonal=1)
        for block in self.transformer.resblocks:
            x = block(x, causal)
        return self.ln_final(x)


# ------------------------------------------------------------------- LGM


def _gn5(c):
    return nn.GroupNorm(32, c, eps=1e-5)


class _QKV(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)


class MVAttention(nn.Module):
    def __init__(self, dim, num_frames, skip_scale, num_heads=16):
        super().__init__()
        self.num_heads, self.num_frames, self.skip_scale = num_heads, num_frames, skip_scale
        self.norm = _gn5(dim)
        self.attn = _QKV(dim)

    def forward(self, x):
        bv, c, hh, ww = x.shape
        b = bv // self.num_frames
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, self.num_frames * hh * ww, c)
        s, hd = h.shape[1], c // self.num_heads
        q, k, v = (t.reshape(b, s, self.num_heads, hd) for t in self.attn.qkv(h).split(c, dim=-1))
        o = self.attn.proj(attention(q, k, v).reshape(b, s, c))
        return (o.reshape(bv, hh, ww, c).permute(0, 3, 1, 2) + x) * self.skip_scale


class LGMResnetBlock(nn.Module):
    def __init__(self, cin, cout, skip_scale):
        super().__init__()
        self.skip_scale = skip_scale
        self.norm1, self.conv1 = _gn5(cin), nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = _gn5(cout), nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv2(F.silu(self.norm2(self.conv1(F.silu(self.norm1(x))))))
        return (h + (self.shortcut(x) if hasattr(self, "shortcut") else x)) * self.skip_scale


class _LGMBlock(nn.Module):
    def __init__(self, nets, attns):
        super().__init__()
        self.nets = nn.ModuleList(nets)
        if attns:
            self.attns = nn.ModuleList(attns)

    def layer(self, j, x):
        x = self.nets[j](x)
        return self.attns[j](x) if hasattr(self, "attns") else x


class LGMUNet(nn.Module):
    def __init__(self, down_channels, down_attention, mid_attention, up_channels, up_attention,
                 num_frames=4, layers_per_block=2):
        super().__init__()
        ss = math.sqrt(0.5)
        self.conv_in = nn.Conv2d(9, down_channels[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        skips, cout = [down_channels[0]], down_channels[0]
        for i, ch in enumerate(down_channels):
            cin, cout = cout, ch
            nets = [LGMResnetBlock(cin if j == 0 else cout, cout, ss)
                    for j in range(layers_per_block)]
            attns = ([MVAttention(cout, num_frames, ss) for _ in range(layers_per_block)]
                     if down_attention[i] else [])
            blk = _LGMBlock(nets, attns)
            skips += [cout] * layers_per_block
            if i != len(down_channels) - 1:
                blk.downsample = nn.Conv2d(cout, cout, 3, stride=2, padding=1)
                skips.append(cout)
            self.down_blocks.append(blk)
        mid = down_channels[-1]
        self.mid_block = _LGMBlock([LGMResnetBlock(mid, mid, ss) for _ in range(2)],
                                   [MVAttention(mid, num_frames, ss)] if mid_attention else [])
        self.up_blocks = nn.ModuleList()
        cout = up_channels[0]
        for i, ch in enumerate(up_channels):
            cin, cout = cout, ch
            n = layers_per_block + 1
            sk = skips[-n:][::-1]
            skips = skips[:-n]
            nets = [LGMResnetBlock((cin if j == 0 else cout) + sk[j], cout, ss) for j in range(n)]
            attns = [MVAttention(cout, num_frames, ss) for _ in range(n)] if up_attention[i] else []
            blk = _LGMBlock(nets, attns)
            if i != len(up_channels) - 1:
                blk.upsample = nn.Conv2d(cout, cout, 3, padding=1)
            self.up_blocks.append(blk)
        self.norm_out = _gn5(up_channels[-1])
        self.conv_out = nn.Conv2d(up_channels[-1], 14, 3, padding=1)

    def forward(self, x):
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
    """Views + rays [B, V, 9, H, W] → Gaussians [B, V·S·S, 14] (pos 3,
    opacity 1, scale 3, rotation 4, rgb 3), activated."""

    def __init__(self, down_channels: Sequence[int], down_attention: Sequence[bool],
                 mid_attention: bool, up_channels: Sequence[int], up_attention: Sequence[bool],
                 splat_size: int, num_input_views: int = 4, **unused):
        super().__init__()
        self.splat_size = splat_size
        self.unet = LGMUNet(tuple(down_channels), tuple(down_attention), mid_attention,
                            tuple(up_channels), tuple(up_attention), num_input_views)
        self.conv = nn.Conv2d(14, 14, 1)

    def forward(self, images):
        B, V, C, H, W = images.shape
        x = self.conv(self.unet(images.reshape(B * V, C, H, W).to(self.conv.weight.dtype)))
        S = self.splat_size
        x = x.permute(0, 2, 3, 1).reshape(B, V * S * S, 14).float()
        rot = x[..., 7:11]
        rot = rot / rot.norm(dim=1, keepdim=True).clamp_min(1e-12)  # over all N, as released
        return torch.cat([x[..., 0:3].clamp(-1, 1), torch.sigmoid(x[..., 3:4]),
                          0.1 * F.softplus(x[..., 4:7]), rot,
                          0.5 * torch.tanh(x[..., 11:14]) + 0.5], dim=-1)


def lgm_options(variant) -> dict:
    """The LGM's published geometry by variant name (reference core/options.py),
    or the given sizes over ``big``'s."""
    big = dict(input_size=256, down_channels=(64, 128, 256, 512, 1024, 1024),
               down_attention=(False, False, False, True, True, True), mid_attention=True,
               up_channels=(1024, 1024, 512, 256, 128), up_attention=(True, True, True, False, False),
               splat_size=128, fovy=39.6)
    if isinstance(variant, dict):
        return dict(big, **variant)
    if variant == "big":
        return big
    raise ValueError(f"unknown LGM variant {variant!r}")

