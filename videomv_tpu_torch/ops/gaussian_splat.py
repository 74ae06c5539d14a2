"""3D Gaussian splatting on torch tensors: projection, the dense oracle and
the batched render entry point.

Port of ``videomv_tpu/ops/gaussian_splat.py``. Tensor contract (the
reference ``GaussianRenderer.render``, core/gs.py:31-94):

  gaussians [B, N, 14]  (pos 3 | opacity 1 | scale 3 | quat 4 | rgb 3)
  cam_view / cam_view_proj [B, V, 4, 4]  row-vector convention
    (``p_h @ cam_view`` maps world → camera; from ``data.cameras``)
  → {"image": [B, V, 3, S, S], "alpha": [B, V, 1, S, S], "depth": ...}

EWA splatting as in 3DGS: Σ = R·diag(s)²·Rᵀ (quaternion wxyz),
Σ' = J·W·Σ·Wᵀ·Jᵀ + 0.3·I, α_i(x) = min(0.99, o_i · exp(-½ dᵀ Σ'⁻¹ d)),
front-to-back compositing in depth order, background filled with the
residual transmittance.

``rasterize_dense`` is the exact plain oracle (every Gaussian against every
pixel); ``render_gaussians(backend="auto")`` takes the tile-binned path of
``ops.splat`` (the CUDA composite kernel) for CUDA tensors and the dense
oracle for CPU tensors, as the JAX package takes its Pallas path on a TPU.
Geometry is fp32 whatever the input dtype. Both paths are differentiable
in the Gaussians: the dense oracle and the projection through autograd, the
binned path through the composite's backward kernel (16-row payload only).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

__all__ = [
    "prepare_gaussians",
    "project_gaussians",
    "project_prepared",
    "quat_to_rotmat",
    "rasterize_dense",
    "render_gaussians",
    "render_gaussians_view_sharded",
]


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) → [..., 3, 3] rotation matrices (the quaternion
    is used as given, not renormalised, as the CUDA computeCov3D does)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def prepare_gaussians(gaussians: torch.Tensor) -> Dict[str, torch.Tensor]:
    """View-independent per-scene prep of ``[..., N, 14]`` Gaussians: the
    attributes split out and M = R(q)·diag(s), the covariance factor
    (Σ = M Mᵀ), all fp32."""
    g = gaussians.float()
    return {
        "pos": g[..., 0:3],
        "opacity": g[..., 3],
        "color": g[..., 11:14],
        "M": quat_to_rotmat(g[..., 7:11]) * g[..., None, 4:7],
    }


def project_prepared(prep: Dict[str, torch.Tensor], cam_view: torch.Tensor,
                     cam_view_proj: torch.Tensor, img_size: int, tan_half_fov: float):
    """EWA-project prepared Gaussians ``[..., N]`` through views ``[..., 4, 4]``
    (leading dims broadcast; e.g. prep of one scene against [V, 4, 4]
    gives [V, N] outputs).

    Returns (mean2d [..., N, 2] pixel coordinates, inv_cov [..., N, 3] the
    (a, b, c) of the inverse 2D covariance, depth, radius, color
    [..., N, 3], opacity, valid), the JAX function's tuple."""
    pos, M = prep["pos"], prep["M"]
    color, opacity = prep["color"], prep["opacity"]
    V = cam_view.float()[..., None, :, :]       # [..., 1, 4, 4] against N
    P = cam_view_proj.float()[..., None, :, :]
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]

    def row(m, c):  # x·m[0,c] + y·m[1,c] + z·m[2,c] + m[3,c]
        return x * m[..., 0, c] + y * m[..., 1, c] + z * m[..., 2, c] + m[..., 3, c]

    pvx, pvy, depth = row(V, 0), row(V, 1), row(V, 2)
    ph0, ph1, ph3 = row(P, 0), row(P, 1), row(P, 3)
    p_w = 1.0 / (ph3 + 1e-7)
    mean2d = torch.stack([((ph0 * p_w + 1.0) * img_size - 1.0) * 0.5,
                          ((ph1 * p_w + 1.0) * img_size - 1.0) * 0.5], dim=-1)

    focal = img_size / (2.0 * tan_half_fov)
    tz = depth
    # the tangent-plane clamp of the CUDA rasterizer (1.3 · tan_fov)
    lim = 1.3 * tan_half_fov
    tx = torch.clamp(pvx / tz, -lim, lim) * tz
    ty = torch.clamp(pvy / tz, -lim, lim) * tz
    fz = focal / tz
    gx = focal * tx / (tz * tz)
    gy = focal * ty / (tz * tz)

    # U = J·Wᵀ rows [..., N, 3]; Y = U @ M per Gaussian
    U0 = torch.stack([fz * V[..., 0, 0] - gx * V[..., 0, 2],
                      fz * V[..., 1, 0] - gx * V[..., 1, 2],
                      fz * V[..., 2, 0] - gx * V[..., 2, 2]], dim=-1)
    U1 = torch.stack([fz * V[..., 0, 1] - gy * V[..., 0, 2],
                      fz * V[..., 1, 1] - gy * V[..., 1, 2],
                      fz * V[..., 2, 1] - gy * V[..., 2, 2]], dim=-1)
    Y0 = (U0[..., :, None] * M).sum(dim=-2)
    Y1 = (U1[..., :, None] * M).sum(dim=-2)
    a = (Y0 * Y0).sum(dim=-1) + 0.3
    b = (Y0 * Y1).sum(dim=-1)
    c = (Y1 * Y1).sum(dim=-1) + 0.3

    det = a * c - b * b
    valid = (depth > 0.2) & (det > 0.0)
    det = torch.where(det == 0.0, torch.ones_like(det), det)
    inv_cov = torch.stack([c / det, -b / det, a / det], dim=-1)

    # the radius only selects tiles (ceil, then integer tile spans): no
    # gradient flows through it, so none is recorded
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
        # opacity-aware extent: beyond σ_max·√(2·ln(255·o)) the 1/255 alpha
        # cutoff kills every pixel; capped at the CUDA rasterizer's 3σ
        cut = torch.sqrt(torch.clamp(
            2.0 * torch.log(255.0 * torch.clamp_min(opacity, 1e-12)), 0.0, 9.0))
        radius = torch.ceil(cut * torch.sqrt(lam1))
    shape = depth.shape
    return (mean2d, inv_cov, depth, radius, color.expand(*shape, 3),
            opacity.expand(shape), valid)


def project_gaussians(gaussians: torch.Tensor, cam_view: torch.Tensor,
                      cam_view_proj: torch.Tensor, img_size: int, tan_half_fov: float):
    """``prepare_gaussians`` + ``project_prepared`` for [N, 14] Gaussians."""
    return project_prepared(prepare_gaussians(gaussians), cam_view, cam_view_proj,
                            img_size, tan_half_fov)


def _composite_pixels(px, mean2d, inv_cov, color, opacity, depth, order, chunk: int):
    """Exact front-to-back compositing of all Gaussians (depth order
    ``order``) over pixels ``px`` [P, 2], in Gaussian chunks with a carried
    transmittance. Returns (C [P, 3], alpha [P], D [P])."""
    n_pix = px.shape[0]
    T = torch.ones(n_pix, device=px.device)
    C = torch.zeros(n_pix, 3, device=px.device)
    D = torch.zeros(n_pix, device=px.device)
    for s in range(0, order.shape[0], chunk):
        idx = order[s:s + chunk]
        m, ic = mean2d[idx], inv_cov[idx]
        d0 = px[None, :, 0] - m[:, None, 0]          # [K, P]
        d1 = px[None, :, 1] - m[:, None, 1]
        power = (-0.5 * (ic[:, 0, None] * d0 ** 2 + ic[:, 2, None] * d1 ** 2)
                 - ic[:, 1, None] * d0 * d1)
        alpha = torch.clamp_max(opacity[idx][:, None] * torch.exp(power), 0.99)
        alpha = torch.where((power > 0) | (alpha < 1.0 / 255.0), torch.zeros_like(alpha), alpha)
        cp = torch.cumprod(1.0 - alpha, dim=0)
        T_excl = torch.cat([torch.ones_like(cp[:1]), cp[:-1]]) * T[None]
        w = alpha * T_excl
        C = C + w.T @ color[idx]
        D = D + w.T @ depth[idx]
        T = T * cp[-1]
    return C, 1.0 - T, D


def rasterize_dense(gaussians: torch.Tensor, cam_view: torch.Tensor,
                    cam_view_proj: torch.Tensor, img_size: int, tan_half_fov: float,
                    bg_color: torch.Tensor, chunk: int = 256, tile: int = 64):
    """One view, the dense oracle: [N, 14] Gaussians → (image [3, S, S],
    alpha [1, S, S], depth [1, S, S]). ``tile`` (pixels per side of a
    block) and ``chunk`` (Gaussians per step) only bound memory."""
    mean2d, inv_cov, depth, _, color, opacity, valid = project_gaussians(
        gaussians, cam_view, cam_view_proj, img_size, tan_half_fov)
    opacity = torch.where(valid, opacity, torch.zeros_like(opacity))
    depth_c = torch.where(valid, depth, torch.zeros_like(depth))
    order = torch.argsort(torch.where(valid, depth, torch.full_like(depth, math.inf)),
                          stable=True)
    S = img_size
    dev = mean2d.device
    ys, xs = torch.meshgrid(torch.arange(S, dtype=torch.float32, device=dev),
                            torch.arange(S, dtype=torch.float32, device=dev), indexing="ij")
    px_all = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    block = min(tile, S) ** 2
    parts = [_composite_pixels(px_all[s:s + block], mean2d, inv_cov, color, opacity,
                               depth_c, order, chunk)
             for s in range(0, S * S, block)]
    C = torch.cat([p[0] for p in parts])
    A = torch.cat([p[1] for p in parts])
    D = torch.cat([p[2] for p in parts])
    img = torch.clamp(C + (1.0 - A)[:, None] * bg_color.float()[None, :], 0.0, 1.0)
    return img.reshape(S, S, 3).permute(2, 0, 1), A.reshape(1, S, S), D.reshape(1, S, S)


def pair_capacity(n_gaussians: int, img_size: int) -> int:
    """The binned path's static pair capacity for one view (JAX
    ``render_gaussians``): ~4.5 tile-pairs per Gaussian, at least 16384, in
    4096 steps, capped at 2^20 (2^21 from 512² up). Overflow drops the
    deepest pairs."""
    cap = (1 << 21) if img_size >= 512 else (1 << 20)
    need = max(16384, -(-9 * n_gaussians // 2 // 4096) * 4096)
    return min(cap, need)


def render_gaussians(
    gaussians: torch.Tensor,
    cam_view: torch.Tensor,
    cam_view_proj: torch.Tensor,
    bg_color: Optional[torch.Tensor] = None,
    img_size: int = 512,
    fovy_deg: float = 39.6,
    backend: str = "auto",
    max_pairs: Optional[int] = None,
    packed: bool = False,
) -> Dict[str, torch.Tensor]:
    """Batched multi-view rendering, ``[B, N, 14]`` Gaussians through
    ``[B, V, 4, 4]`` cameras.

    backend: ``"auto"`` (the binned path with the CUDA composite kernel for
    CUDA tensors, ``"dense"`` for CPU tensors), ``"dense"`` or
    ``"binned"``. ``packed`` (binned only): the 8-row payload with colours,
    opacity and depth truncated to bf16, for inference; it is not
    differentiable and raises when a gradient is required."""
    if bg_color is None:
        bg_color = torch.ones(3, device=gaussians.device)
    bg_color = bg_color.to(device=gaussians.device, dtype=torch.float32)
    tan_half_fov = float(math.tan(0.5 * math.radians(fovy_deg)))
    if backend == "auto":
        backend = "binned" if gaussians.is_cuda else "dense"
    if backend == "binned":
        from .splat import rasterize_binned_batch

        if max_pairs is None:
            max_pairs = pair_capacity(int(gaussians.shape[1]), img_size)
        return rasterize_binned_batch(gaussians, cam_view, cam_view_proj, img_size,
                                      tan_half_fov, bg_color, max_pairs=max_pairs,
                                      packed=packed)
    if backend != "dense":
        raise ValueError(f"backend must be 'auto', 'dense' or 'binned', got {backend!r}")
    B, V = cam_view.shape[:2]
    outs = [[rasterize_dense(gaussians[b], cam_view[b, v], cam_view_proj[b, v], img_size,
                             tan_half_fov, bg_color)
             for v in range(V)] for b in range(B)]
    return {key: torch.stack([torch.stack([o[i] for o in row]) for row in outs])
            for i, key in enumerate(("image", "alpha", "depth"))}


def render_gaussians_view_sharded(
    mesh,
    gaussians: torch.Tensor,
    cam_view: torch.Tensor,
    cam_view_proj: torch.Tensor,
    axis: str = "sp",
    shard_dim: str = "view",
    **kwargs,
) -> Dict[str, torch.Tensor]:
    """``render_gaussians`` of this rank's share of a render spread over
    ``mesh[axis]`` (one process per device; no collective):

    - ``shard_dim='view'`` (frame-parallel serving): the scene ``[B, N, 14]``
      and the cameras ``[B, V, 4, 4]`` are every rank's, and the rank renders
      its block of ``V / n`` views (V must divide by n), the frames its
      sampler holds. Returns ``[B, V/n, ...]``;
    - ``shard_dim='batch'`` (data-parallel serving): the scenes and cameras
      passed are the rank's own rows, and it renders all their views.

    The JAX package's ``shard_map`` of the same name returns the global
    array laid out over the mesh; here each rank keeps its block."""
    if shard_dim == "batch":
        return render_gaussians(gaussians, cam_view, cam_view_proj, **kwargs)
    if shard_dim != "view":
        raise ValueError(f"shard_dim must be 'view' or 'batch', got {shard_dim!r}")
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    views = cam_view.shape[1]
    if views % n:
        raise ValueError(f"{views} views do not divide over {n} devices")
    k = views // n
    return render_gaussians(gaussians, cam_view[:, r * k:(r + 1) * k],
                            cam_view_proj[:, r * k:(r + 1) * k], **kwargs)
