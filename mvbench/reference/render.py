"""3D Gaussian splatting, plainly: EWA projection as in 3DGS, then
front-to-back compositing of each 16×16 pixel tile over the Gaussians whose
extent reaches it, in depth order, with the configuration's fixed pair
capacity per view.

The capacity is part of what the served render computes (the released
renderer's static budget): each Gaussian, in depth order, takes one (tile,
Gaussian) pair for every tile of its extent, and the pairs past the
``capacity``-th of a view are dropped, the deepest first. This file states
that rule directly and composites the kept pairs in float32 with no packing.

``render(gaussians [N, 14], cam_view [V, 4, 4], cam_view_proj [V, 4, 4])`` →
image [V, 3, S, S] over the background.
"""

from __future__ import annotations

import math

import torch

TILE = 16
MAX_SPAN = 16  # tiles a Gaussian may cover per side
ALPHA_MIN = 1.0 / 255.0


def quat_to_rotmat(q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def project(g: torch.Tensor, view: torch.Tensor, view_proj: torch.Tensor, size: int,
            tan_half_fov: float):
    """One view: pixel means [N, 2], inverse 2D covariance (a, b, c) [N, 3],
    depth, tile radius, colour [N, 3], opacity and validity."""
    pos, opacity, color = g[:, 0:3], g[:, 3], g[:, 11:14]
    M = quat_to_rotmat(g[:, 7:11]) * g[:, None, 4:7]
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]

    def row(m, c):
        return x * m[0, c] + y * m[1, c] + z * m[2, c] + m[3, c]

    V, P = view, view_proj
    pvx, pvy, depth = row(V, 0), row(V, 1), row(V, 2)
    p_w = 1.0 / (row(P, 3) + 1e-7)
    mean = torch.stack([((row(P, 0) * p_w + 1.0) * size - 1.0) * 0.5,
                        ((row(P, 1) * p_w + 1.0) * size - 1.0) * 0.5], dim=-1)
    focal = size / (2.0 * tan_half_fov)
    lim = 1.3 * tan_half_fov
    tz = depth
    tx = torch.clamp(pvx / tz, -lim, lim) * tz
    ty = torch.clamp(pvy / tz, -lim, lim) * tz
    fz, gx, gy = focal / tz, focal * tx / (tz * tz), focal * ty / (tz * tz)
    U0 = torch.stack([fz * V[0, 0] - gx * V[0, 2], fz * V[1, 0] - gx * V[1, 2],
                      fz * V[2, 0] - gx * V[2, 2]], dim=-1)
    U1 = torch.stack([fz * V[0, 1] - gy * V[0, 2], fz * V[1, 1] - gy * V[1, 2],
                      fz * V[2, 1] - gy * V[2, 2]], dim=-1)
    Y0 = (U0[:, :, None] * M).sum(-2)
    Y1 = (U1[:, :, None] * M).sum(-2)
    a = (Y0 * Y0).sum(-1) + 0.3
    b = (Y0 * Y1).sum(-1)
    c = (Y1 * Y1).sum(-1) + 0.3
    det = a * c - b * b
    valid = (depth > 0.2) & (det > 0.0)
    det = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_cov = torch.stack([c / det, -b / det, a / det], dim=-1)
    mid = 0.5 * (a + c)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    # beyond σ_max·√(2·ln(255·o)) the 1/255 cut leaves nothing; at most 3σ
    cut = torch.sqrt(torch.clamp(2.0 * torch.log(255.0 * torch.clamp_min(opacity, 1e-12)),
                                 0.0, 9.0))
    radius = torch.ceil(cut * torch.sqrt(lam1))
    return mean, inv_cov, depth, radius, color, opacity, valid


def tile_pairs(mean, depth, radius, opacity, valid, size: int, capacity: int):
    """The kept (tile, Gaussian) pairs of one view, as (tile [P], gaussian
    [P]) sorted by tile with each tile's pairs front to back, and the
    number of pairs demanded."""
    nts = size // TILE
    order = torch.argsort(torch.where(valid, depth, torch.full_like(depth, math.inf)),
                          stable=True)
    mx, my = mean[order, 0], mean[order, 1]
    r = torch.where(valid[order], radius[order], torch.zeros_like(radius))
    op = torch.where(valid[order], opacity[order], torch.zeros_like(opacity))

    def tile_of(v):
        return torch.clamp(torch.floor(v / TILE), 0, nts - 1).long()

    tx0, ty0 = tile_of(mx - r), tile_of(my - r)
    on = ((mx + r >= 0) & (mx - r < size) & (my + r >= 0) & (my - r < size)
          & (r > 0) & (op > 0))
    sx = torch.where(on, torch.clamp(tile_of(mx + r) - tx0 + 1, 0, MAX_SPAN), 0)
    sy = torch.where(on, torch.clamp(tile_of(my + r) - ty0 + 1, 0, MAX_SPAN), 0)
    count = sx * sy
    first = torch.cumsum(count, 0) - count
    kept = torch.clamp(torch.clamp_min(capacity - first, 0), max=count)
    gi = torch.repeat_interleave(torch.arange(len(count), device=mean.device), kept)
    local = torch.arange(len(gi), device=mean.device) - torch.repeat_interleave(first, kept)
    w = torch.clamp_min(sx[gi], 1)
    tile = (ty0[gi] + local // w) * nts + tx0[gi] + local % w
    tile, perm = torch.sort(tile, stable=True)
    return tile, order[gi[perm]], int(count.sum())


def composite(tile, gauss, mean, inv_cov, color, opacity, size: int, chunk: int = 128):
    """Front-to-back over each tile's pairs: (rgb [3, S, S], alpha [S, S])."""
    nts = size // TILE
    n_tiles = nts * nts
    dev = mean.device
    counts = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(counts, 0) - counts
    p = torch.arange(TILE * TILE, device=dev)
    t = torch.arange(n_tiles, device=dev)[:, None]
    px = (p % TILE + (t % nts) * TILE).float()[..., None]      # [T, 256, 1]
    py = (p // TILE + (t // nts) * TILE).float()[..., None]
    trans = torch.ones(n_tiles, TILE * TILE, device=dev)
    rgb = torch.zeros(n_tiles, TILE * TILE, 3, device=dev)
    j = torch.arange(chunk, device=dev)
    for c0 in range(0, int(counts.max()) if len(tile) else 0, chunk):
        pos = c0 + j
        live = pos[None, :] < counts[:, None]                   # [T, chunk]
        g = gauss[torch.clamp(starts[:, None] + pos[None, :], max=max(len(gauss) - 1, 0))]
        dx = px - mean[g][:, None, :, 0]
        dy = py - mean[g][:, None, :, 1]
        ic = inv_cov[g][:, None]
        power = -0.5 * (ic[..., 0] * dx * dx + ic[..., 2] * dy * dy) - ic[..., 1] * dx * dy
        alpha = torch.clamp_max(opacity[g][:, None, :] * torch.exp(power), 0.99)
        dead = (power > 0.0) | (alpha < ALPHA_MIN) | ~live[:, None, :]
        alpha = torch.where(dead, torch.zeros_like(alpha), alpha)
        cp = torch.cumprod(1.0 - alpha, dim=-1)                 # [T, 256, chunk]
        excl = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
        w = alpha * excl * trans[..., None]
        rgb = rgb + torch.bmm(w, color[g])                       # [T, 256, 3]
        trans = trans * cp[..., -1]
    img = rgb.reshape(nts, nts, TILE, TILE, 3).permute(4, 0, 2, 1, 3).reshape(3, size, size)
    alpha = (1.0 - trans).reshape(nts, nts, TILE, TILE).permute(0, 2, 1, 3).reshape(size, size)
    return img, alpha


def render(gaussians, cam_view, cam_view_proj, size: int, fovy_deg: float, bg: float,
           capacity: int):
    """[N, 14] Gaussians through [V, 4, 4] cameras → (images [V, 3, S, S],
    pairs demanded per view)."""
    tan = math.tan(0.5 * math.radians(fovy_deg))
    g = gaussians.float()
    out, demanded = [], []
    for v in range(cam_view.shape[0]):
        mean, inv_cov, depth, radius, color, opacity, valid = project(
            g, cam_view[v].float(), cam_view_proj[v].float(), size, tan)
        tile, gauss, n = tile_pairs(mean, depth, radius, opacity, valid, size, capacity)
        rgb, alpha = composite(tile, gauss, mean, inv_cov, color, opacity, size)
        out.append(torch.clamp(rgb + (1.0 - alpha)[None] * bg, 0.0, 1.0))
        demanded.append(n)
    return torch.stack(out), demanded


def capacity(n_gaussians: int, size: int) -> int:
    """The released renderer's pair budget of one view: about 4.5 pairs a
    Gaussian, at least 16384, in steps of 4096, at most 2^20 (2^21 from
    512² up)."""
    cap = (1 << 21) if size >= 512 else (1 << 20)
    return min(cap, max(16384, -(-9 * n_gaussians // 2 // 4096) * 4096))
