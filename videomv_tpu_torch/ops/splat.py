"""Tile-binned Gaussian splatting: binning in plain PyTorch, the composite
and its backward as the CUDA kernels ``csrc/splat_composite.cu`` and
``csrc/splat_composite_bwd.cu``, each beside its plain twin.

Port of ``videomv_tpu/ops/splat_pallas.py``. The binning runs on
the device in plain PyTorch, as the JAX package runs it in XLA outside any
kernel: projection, a stable depth argsort, per-Gaussian tile spans, a
fixed-capacity expansion into (tile, Gaussian) pairs in depth order, one
sort on int64 keys ``(tile << idx_bits) | gaussian`` (unique, so the order
is that of the JAX package's uint32 key sort), ``searchsorted`` for each
tile's segment, and the payload gather. All views of a render call are
binned at once (the JAX package bins groups of 8; here the batch is the
whole call, ``B·V`` rows of ``max_pairs`` pairs).

The composite (``composite``) replaces the Pallas kernel
``_tile_kernel``: for each 16×16 tile of each view it walks the tile's
depth-ordered pairs front to back and writes ``[5, 256]`` rows (RGB before
the background, alpha = 1 − T, depth). On a CUDA tensor it launches the
kernel, or raises; on a CPU tensor it runs ``composite_reference``, the
plain twin. ``LAUNCHES`` counts kernel launches and nothing else.

``composite`` is a ``torch.autograd.Function`` (the JAX package's
``_composite`` custom_vjp): its backward replaces the Pallas kernel
``_tile_bwd_kernel`` and returns ``dpayload [R, 16, P]`` from the saved
payload, segments and forward output. On a CUDA tensor the backward
launches its kernel (``BWD_LAUNCHES`` counts those launches) or raises; on a
CPU tensor it runs ``composite_backward_reference``. Every pair belongs to
one tile, so the gradient has one writer per column and is deterministic.
The binning around it (gathers and selects) differentiates through
autograd: the payload gather's backward scatter-adds each pair's gradient
onto its Gaussian. Only the 16-row payload is differentiable; the packed
payload under grad raises, as in the JAX package.

Two payload layouts, as in the JAX package: 16 rows fp32 (mx, my, ica,
icb, icc, r, g, b, opacity, depth, 6 zero rows) and the 8-row packed
inference payload (mx, my, ica, icb, icc, r|g, b|opacity, depth|0, the
pairs truncated to bf16 and packed two to an fp32 word by ``_pack2``).

Left out, as TPU-layout work with no counterpart here: the counting-sort
placement (``counting=True``, a measured loss on the TPU), the
``expand_mode`` tiers (bit-identical to the one expansion kept), and the
MXU prefix-sum tricks.
"""

from __future__ import annotations

import torch

from . import _build
from .gaussian_splat import prepare_gaussians, project_prepared

__all__ = [
    "BWD_LAUNCHES",
    "LAUNCHES",
    "TILE",
    "bin_pairs",
    "composite",
    "composite_backward",
    "composite_backward_reference",
    "composite_reference",
    "rasterize_binned_batch",
    "untile",
]

TILE = 16
MAX_SPAN = 16  # tiles per side a Gaussian may cover (the JAX package's default)
LAUNCHES = 0
BWD_LAUNCHES = 0

_HI_MASK = -65536  # 0xFFFF0000 as int32


def _pack2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Truncate two fp32 tensors to bf16 (by masking, not rounding) and pack
    them into one fp32-typed word: ``a`` in the high 16 bits, ``b`` in the
    low. Bit-identical to the JAX package's ``_pack2``."""
    ua = a.float().contiguous().view(torch.int32)
    ub = b.float().contiguous().view(torch.int32)
    return ((ua & _HI_MASK) | ((ub >> 16) & 0xFFFF)).view(torch.float32)


def _unpack2(w: torch.Tensor):
    """Inverse of ``_pack2``: fp32 words → (hi, lo) fp32."""
    u = w.contiguous().view(torch.int32)
    hi = (u & _HI_MASK).view(torch.float32)
    lo = ((u & 0xFFFF).to(torch.int64) << 16)  # the low half moved up, as uint32
    lo = torch.where(lo >= 2 ** 31, lo - 2 ** 32, lo).to(torch.int32).view(torch.float32)
    return hi, lo


def bin_pairs(mean2d, inv_cov, depth, radius, color, opacity, valid, img_size: int,
              max_pairs: int, packed: bool = False):
    """Depth-ordered, tile-sorted pair lists of ``R`` views at once.

    Inputs are ``project_prepared``'s outputs with a leading view axis
    (``mean2d [R, N, 2]``, ``depth [R, N]``, ...). Returns ``(payload
    [R, 8 or 16, max_pairs] fp32, tile_start [R, T] int32, tile_count
    [R, T] int32, pairs [R])``, where ``pairs`` is each view's demanded
    pair count (pairs beyond ``max_pairs``, the deepest, are dropped) and
    dead pairs have a zero payload."""
    R, N = depth.shape
    nts = img_size // TILE
    n_tiles = nts * nts
    dev = depth.device

    # depth order (a stable sort, as jnp.argsort)
    inf = torch.full_like(depth, float("inf"))
    order = torch.argsort(torch.where(valid, depth, inf), dim=1, stable=True)

    def take(x):
        idx = order if x.dim() == 2 else order[..., None].expand(-1, -1, x.shape[-1])
        return torch.gather(x, 1, idx)

    mean2d, inv_cov, color = take(mean2d), take(inv_cov), take(color)
    v = torch.gather(valid, 1, order)
    zero = torch.zeros_like(depth)
    opacity = torch.where(v, take(opacity), zero)
    radius = torch.where(v, take(radius), zero)
    depth = torch.where(v, take(depth), zero)

    # tile spans
    mx, my = mean2d[..., 0], mean2d[..., 1]

    def tile_of(x):
        return torch.clamp(torch.floor(x / TILE), 0, nts - 1).to(torch.int64)

    tx0, tx1 = tile_of(mx - radius), tile_of(mx + radius)
    ty0, ty1 = tile_of(my - radius), tile_of(my + radius)
    on_screen = ((mx + radius >= 0) & (mx - radius < img_size)
                 & (my + radius >= 0) & (my - radius < img_size)
                 & (radius > 0) & (opacity > 0))
    span_x = torch.where(on_screen, torch.clamp(tx1 - tx0 + 1, 0, MAX_SPAN), 0)
    span_y = torch.where(on_screen, torch.clamp(ty1 - ty0 + 1, 0, MAX_SPAN), 0)
    counts = span_x * span_y

    # fixed-capacity expansion in depth order: pair i belongs to the
    # Gaussian whose run [ends - counts, ends) holds it
    ends = torch.cumsum(counts, dim=1)
    pairs = ends[:, -1]
    pair_idx = torch.arange(max_pairs, device=dev, dtype=torch.int64).expand(R, -1)
    pair_live = pair_idx < pairs[:, None]
    pair_g = torch.searchsorted(ends[:, :-1].contiguous(), pair_idx.contiguous(), right=True)
    span1 = torch.clamp_min(span_x, 1)
    local = pair_idx - torch.gather(ends - counts, 1, pair_g)
    s = torch.gather(span1, 1, pair_g)
    tile_x = torch.gather(tx0, 1, pair_g) + local % s
    tile_y = torch.gather(ty0, 1, pair_g) + local // s
    tile_id = torch.where(pair_live, tile_y * nts + tile_x, n_tiles)

    # one sort on unique int64 keys keeps the depth order within each tile
    idx_bits = max(1, (N - 1).bit_length())
    key, _ = torch.sort((tile_id << idx_bits) | pair_g, dim=1)
    tile_sorted = key >> idx_bits
    pair_sorted = key & ((1 << idx_bits) - 1)
    bounds = torch.arange(n_tiles + 1, device=dev, dtype=torch.int64).expand(R, -1)
    starts = torch.searchsorted(tile_sorted, bounds.contiguous(), right=False)
    tile_start = starts[:, :-1].to(torch.int32)
    tile_count = (starts[:, 1:] - starts[:, :-1]).to(torch.int32)

    # per-Gaussian attribute rows, one gather to pair order
    if packed:
        attrs = torch.cat([
            mean2d, inv_cov,
            _pack2(color[..., 0], color[..., 1])[..., None],
            _pack2(color[..., 2], opacity)[..., None],
            _pack2(depth, torch.zeros_like(depth))[..., None],
        ], dim=-1)
    else:
        attrs = torch.cat([mean2d, inv_cov, color, opacity[..., None], depth[..., None],
                           torch.zeros(R, N, 6, device=dev)], dim=-1)
    payload = torch.gather(attrs, 1, pair_sorted[..., None].expand(-1, -1, attrs.shape[-1]))
    # dead pairs get a zero payload: a select, never a multiply (packed
    # words are raw bit patterns)
    payload = torch.where(pair_live[..., None], payload, torch.zeros((), device=dev))
    return payload.transpose(1, 2).contiguous(), tile_start, tile_count, pairs


def _pixel_coords(n_tiles_side: int, device):
    """(px, py) [T, 256]: the pixel coordinates of each tile's 256 pixels,
    row-major within the tile."""
    t = torch.arange(n_tiles_side * n_tiles_side, device=device)[:, None]
    p = torch.arange(TILE * TILE, device=device)[None, :]
    px = (p % TILE + (t % n_tiles_side) * TILE).float()
    py = (p // TILE + (t // n_tiles_side) * TILE).float()
    return px, py


def composite_reference(payload: torch.Tensor, tile_start: torch.Tensor,
                        tile_count: torch.Tensor, n_tiles_side: int, chunk: int = 64
                        ) -> torch.Tensor:
    """The plain twin of the composite kernel (the JAX ``_tile_kernel``'s
    math): per tile, α over ``[tiles, 256, chunk]`` blocks, transmittance
    from an exclusive cumulative sum of log(1 − α), weights contracted with
    (r, g, b, depth). Vectorised over every tile of every view; the loop
    runs over chunk index only. Returns ``[R, T, 5, 256]``."""
    R, rows, P = payload.shape
    T = n_tiles_side * n_tiles_side
    dev = payload.device
    start = tile_start.reshape(-1).long()
    count = tile_count.reshape(-1).long()
    base = (torch.arange(R, device=dev) * P).repeat_interleave(T)
    px, py = (c.repeat(R, 1)[..., None] for c in _pixel_coords(n_tiles_side, dev))
    flat = payload.transpose(1, 2).reshape(R * P, rows)
    trans = torch.ones(R * T, TILE * TILE, device=dev)
    acc = torch.zeros(R * T, TILE * TILE, 4, device=dev)
    j = torch.arange(chunk, device=dev)
    n_chunks = -(-int(count.max()) // chunk) if count.numel() else 0
    for ci in range(n_chunks):
        pos = ci * chunk + j                                  # [chunk]
        live = pos[None, :] < count[:, None]                  # [RT, chunk]
        gidx = base[:, None] + torch.clamp(start[:, None] + pos[None, :], max=P - 1)
        d = flat[gidx]                                        # [RT, chunk, rows]
        if rows == 8:
            r_, g_ = _unpack2(d[..., 5])
            b_, op = _unpack2(d[..., 6])
            dep, _ = _unpack2(d[..., 7])
            rgbd = torch.stack([r_, g_, b_, dep], dim=-1)
        else:
            op = d[..., 8]
            rgbd = torch.cat([d[..., 5:8], d[..., 9:10]], dim=-1)
        dx = px - d[:, None, :, 0]                            # [RT, 256, chunk]
        dy = py - d[:, None, :, 1]
        power = (-0.5 * (d[:, None, :, 2] * dx * dx + d[:, None, :, 4] * dy * dy)
                 - d[:, None, :, 3] * dx * dy)
        alpha = torch.clamp_max(op[:, None, :] * torch.exp(power), 0.99)
        dead = (power > 0.0) | (alpha < 1.0 / 255.0) | ~live[:, None, :]
        alpha = torch.where(dead, torch.zeros_like(alpha), alpha)
        logs = torch.log1p(-alpha)
        incl = torch.cumsum(logs, dim=-1)
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
        w = alpha * torch.exp(excl) * trans[..., None]
        acc = acc + torch.bmm(w, rgbd)
        trans = trans * torch.exp(incl[..., -1])
    out = torch.cat([acc[..., :3], (1.0 - trans)[..., None], acc[..., 3:]], dim=-1)
    return out.transpose(1, 2).reshape(R, T, 5, TILE * TILE)


def _check_cuda_inputs(payload, tile_start, tile_count, n_tiles_side):
    if payload.dim() != 3 or payload.shape[1] not in (8, 16):
        raise ValueError(f"splat composite: payload must be [R, 8 or 16, P], "
                         f"got {tuple(payload.shape)}")
    if payload.dtype != torch.float32:
        raise ValueError(f"splat composite: payload must be float32, got {payload.dtype}")
    R = payload.shape[0]
    n_tiles = n_tiles_side * n_tiles_side
    for name, t in (("payload", payload), ("tile_start", tile_start),
                    ("tile_count", tile_count)):
        if not t.is_cuda or t.device != payload.device:
            raise ValueError(f"splat composite: {name} must be on {payload.device}")
        if not t.is_contiguous():
            raise ValueError(f"splat composite: {name} must be contiguous")
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        if t.dtype != torch.int32 or tuple(t.shape) != (R, n_tiles):
            raise ValueError(f"splat composite: {name} must be int32 [{R}, {n_tiles}], "
                             f"got {t.dtype} {tuple(t.shape)}")
    if R > 65535 or n_tiles >= 2 ** 31:
        raise ValueError(f"splat composite: grid ({n_tiles}, {R}) too large")


def composite_backward_reference(payload: torch.Tensor, tile_start: torch.Tensor,
                                 tile_count: torch.Tensor, saved: torch.Tensor,
                                 grad: torch.Tensor, n_tiles_side: int, chunk: int = 64
                                 ) -> torch.Tensor:
    """The plain twin of the backward kernel (the JAX ``_tile_bwd_kernel``'s
    math): the VJP of ``composite_reference`` from the forward's output
    ``saved`` and its gradient ``grad`` (both ``[R, T, 5, 256]``). Walks the
    chunks as the forward twin does, carrying the transmittance and the
    inclusive prefix of Σ_ch gC·c·w, and per (pixel, pair) forms

        dα = (gC·c_i)·T_i − (gC·C_tot − gC·Cum_i − gA·T_N) / max(1 − α, 0.01)

    with dpower = dα·α and dopacity = dα·exp(power), both zero where the pair
    is dead or α sits on its 0.99 clamp. Returns ``dpayload [R, 16, P]``:
    rows 0-1 d mean2d, 2-4 d inv_cov, 5-7 d rgb, 8 d opacity, 9 d depth, the
    rest (and every pair outside a segment) zero."""
    R, rows, P = payload.shape
    if rows != 16:
        raise ValueError("splat composite backward: only the 16-row payload is differentiable")
    T = n_tiles_side * n_tiles_side
    dev = payload.device
    start = tile_start.reshape(-1).long()
    count = tile_count.reshape(-1).long()
    base = (torch.arange(R, device=dev) * P).repeat_interleave(T)
    px, py = (c.repeat(R, 1)[..., None] for c in _pixel_coords(n_tiles_side, dev))
    flat = payload.transpose(1, 2).reshape(R * P, rows)
    sv = saved.reshape(R * T, 5, TILE * TILE).transpose(1, 2)     # [RT, 256, 5]
    gr = grad.reshape(R * T, 5, TILE * TILE).transpose(1, 2)
    ch = [0, 1, 2, 4]                                             # r, g, b, depth
    gC = gr[..., ch]                                              # [RT, 256, 4]
    # gC·C_tot − gA·T_N: the part of the suffix term that no pair changes
    tail = (gC * sv[..., ch]).sum(-1) - gr[..., 3] * (1.0 - sv[..., 3])
    trans = torch.ones(R * T, TILE * TILE, device=dev)
    cum = torch.zeros(R * T, TILE * TILE, device=dev)
    dflat = torch.zeros(R * P, rows, device=dev)
    j = torch.arange(chunk, device=dev)
    n_chunks = -(-int(count.max()) // chunk) if count.numel() else 0
    for ci in range(n_chunks):
        pos = ci * chunk + j
        live = pos[None, :] < count[:, None]                      # [RT, chunk]
        gidx = base[:, None] + torch.clamp(start[:, None] + pos[None, :], max=P - 1)
        d = flat[gidx]                                            # [RT, chunk, 16]
        rgbd = torch.cat([d[..., 5:8], d[..., 9:10]], dim=-1)
        ia, ib, ic = (d[:, None, :, k] for k in (2, 3, 4))
        dx = px - d[:, None, :, 0]                                # [RT, 256, chunk]
        dy = py - d[:, None, :, 1]
        power = -0.5 * (ia * dx * dx + ic * dy * dy) - ib * dx * dy
        expp = torch.exp(power)
        raw = d[:, None, :, 8] * expp
        alpha = torch.clamp_max(raw, 0.99)
        dead = (power > 0.0) | (alpha < 1.0 / 255.0) | ~live[:, None, :]
        alpha = torch.where(dead, torch.zeros_like(alpha), alpha)
        gmask = ~dead & (raw < 0.99)
        logs = torch.log1p(-alpha)
        incl = torch.cumsum(logs, dim=-1)
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
        t_excl = torch.exp(excl) * trans[..., None]
        w = alpha * t_excl
        g1 = torch.bmm(gC, rgbd.transpose(1, 2))                  # gC·c_i [RT, 256, chunk]
        wg = g1 * w
        gcum = torch.cumsum(wg, dim=-1) + cum[..., None]
        one_minus = torch.clamp_min(1.0 - alpha, 0.01)
        dalpha = g1 * t_excl - (tail[..., None] - gcum) / one_minus
        zero = torch.zeros_like(dalpha)
        dpower = torch.where(gmask, dalpha * alpha, zero)
        dop = torch.where(gmask, dalpha * expp, zero)
        d_rgbd = torch.bmm(w.transpose(1, 2), gC)                 # [RT, chunk, 4]
        contrib = torch.stack([
            (dpower * (ia * dx + ib * dy)).sum(1), (dpower * (ic * dy + ib * dx)).sum(1),
            (dpower * (-0.5 * dx * dx)).sum(1), (dpower * (-dx * dy)).sum(1),
            (dpower * (-0.5 * dy * dy)).sum(1),
            d_rgbd[..., 0], d_rgbd[..., 1], d_rgbd[..., 2], dop.sum(1), d_rgbd[..., 3],
        ], dim=-1)                                                # [RT, chunk, 10]
        dflat[gidx[live], :10] = contrib[live]                    # one writer per pair
        trans = trans * torch.exp(incl[..., -1])
        cum = cum + wg.sum(-1)
    return dflat.reshape(R, P, rows).transpose(1, 2).contiguous()


def composite_backward(payload: torch.Tensor, tile_start: torch.Tensor,
                       tile_count: torch.Tensor, saved: torch.Tensor, grad: torch.Tensor,
                       n_tiles_side: int) -> torch.Tensor:
    """The composite's VJP: ``dpayload [R, 16, P]`` from the 16-row payload,
    the segments, the forward's output and its gradient (both ``[R, T, 5,
    256]``). The CUDA kernel, one launch for all R views, on a CUDA tensor;
    the plain twin on a CPU tensor."""
    global BWD_LAUNCHES
    if not payload.is_cuda:
        return composite_backward_reference(payload, tile_start, tile_count, saved, grad,
                                            n_tiles_side)
    _check_cuda_inputs(payload, tile_start, tile_count, n_tiles_side)
    R, rows, P = payload.shape
    if rows != 16:
        raise ValueError("splat composite backward: only the 16-row payload is differentiable")
    tiles = (R, n_tiles_side * n_tiles_side, 5, TILE * TILE)
    for name, t in (("saved", saved), ("grad", grad)):
        if (t.device != payload.device or t.dtype != torch.float32
                or tuple(t.shape) != tiles or not t.is_contiguous()):
            raise ValueError(f"splat composite backward: {name} must be contiguous float32 "
                             f"{list(tiles)} on {payload.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    dpayload = torch.empty_like(payload)
    lib = _build.load_library()
    err = lib.vmv_splat_composite_bwd(
        payload.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(), saved.data_ptr(),
        grad.data_ptr(), dpayload.data_ptr(), R, P, n_tiles_side,
        torch.cuda.current_stream(payload.device).cuda_stream)
    _build.check(err, "vmv_splat_composite_bwd")
    BWD_LAUNCHES += 1
    return dpayload


def _composite_forward(payload, tile_start, tile_count, n_tiles_side):
    global LAUNCHES
    if not payload.is_cuda:
        return composite_reference(payload, tile_start, tile_count, n_tiles_side)
    _check_cuda_inputs(payload, tile_start, tile_count, n_tiles_side)
    R, rows, P = payload.shape
    out = torch.empty((R, n_tiles_side * n_tiles_side, 5, TILE * TILE),
                      device=payload.device, dtype=torch.float32)
    lib = _build.load_library()
    err = lib.vmv_splat_composite_fwd(
        payload.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(), out.data_ptr(),
        R, rows, P, n_tiles_side, torch.cuda.current_stream(payload.device).cuda_stream)
    _build.check(err, "vmv_splat_composite_fwd")
    LAUNCHES += 1
    return out


class _Composite(torch.autograd.Function):
    """Forward: the composite kernel (or its twin on the CPU); backward: the
    backward kernel (or its twin) on the saved payload, segments and output."""

    @staticmethod
    def forward(ctx, payload, tile_start, tile_count, n_tiles_side):
        if ctx.needs_input_grad[0] and payload.shape[1] != 16:
            raise ValueError(
                "differentiating the packed 8-row splat payload is unsupported: render "
                "with packed=False on a gradient path")
        out = _composite_forward(payload, tile_start, tile_count, n_tiles_side)
        ctx.save_for_backward(payload, tile_start, tile_count, out)
        ctx.n_tiles_side = n_tiles_side
        return out

    @staticmethod
    def backward(ctx, grad):
        payload, tile_start, tile_count, out = ctx.saved_tensors
        dpayload = composite_backward(payload, tile_start, tile_count, out,
                                      grad.contiguous().float(), ctx.n_tiles_side)
        return dpayload, None, None, None


def composite(payload: torch.Tensor, tile_start: torch.Tensor, tile_count: torch.Tensor,
              n_tiles_side: int) -> torch.Tensor:
    """Front-to-back composite of each tile's pairs: ``payload [R, 8 or 16,
    P]``, ``tile_start``/``tile_count [R, T]`` int32 → ``[R, T, 5, 256]``
    (RGB before the background, alpha, depth). The CUDA kernel, one launch
    for all R views, on a CUDA tensor; the plain twin on a CPU tensor.
    Differentiable in the 16-row payload (backward: ``composite_backward``).
    The caller guarantees each segment lies inside ``P``."""
    return _Composite.apply(payload, tile_start, tile_count, n_tiles_side)


def untile(out_tiles: torch.Tensor, n_tiles_side: int) -> torch.Tensor:
    """``[R, T, 5, 256]`` tiles → ``[R, 5, S, S]`` images."""
    R = out_tiles.shape[0]
    nts, S = n_tiles_side, n_tiles_side * TILE
    t = out_tiles.reshape(R, nts, nts, 5, TILE, TILE)      # r, ty, tx, c, py, px
    return t.permute(0, 3, 1, 4, 2, 5).reshape(R, 5, S, S)


def rasterize_binned_batch(gaussians: torch.Tensor, cam_view: torch.Tensor,
                           cam_view_proj: torch.Tensor, img_size: int, tan_half_fov: float,
                           bg_color: torch.Tensor, max_pairs: int, packed: bool = False):
    """``[B, N, 14]`` Gaussians through ``[B, V, 4, 4]`` cameras: scene prep
    once per scene, projection and binning of all B·V views at once, one
    composite launch (the counterpart of ``rasterize_pallas_batch``).
    Returns {"image": [B, V, 3, S, S], "alpha": [B, V, 1, S, S], "depth"}."""
    if img_size % TILE:
        raise ValueError(f"img_size {img_size} is not a multiple of {TILE}")
    B, V = cam_view.shape[:2]
    prep = {k: v[:, None] for k, v in prepare_gaussians(gaussians).items()}  # [B, 1, ...]
    proj = project_prepared(prep, cam_view, cam_view_proj, img_size, tan_half_fov)
    proj = [p.reshape(B * V, *p.shape[2:]) for p in proj]
    payload, tile_start, tile_count, _ = bin_pairs(
        *proj, img_size=img_size, max_pairs=max_pairs, packed=packed)
    out = untile(composite(payload, tile_start, tile_count, img_size // TILE),
                 img_size // TILE)
    alpha = out[:, 3:4]
    img = torch.clamp(out[:, :3] + (1.0 - alpha) * bg_color.float()[None, :, None, None],
                      0.0, 1.0)
    S = img_size
    return {"image": img.reshape(B, V, 3, S, S), "alpha": alpha.reshape(B, V, 1, S, S),
            "depth": out[:, 4:5].reshape(B, V, 1, S, S)}
