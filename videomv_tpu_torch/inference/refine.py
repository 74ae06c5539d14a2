"""The 3D-aware refine inside the DDIM loop: LGM reconstruction and a splat
re-render whose re-encoded latents stand in for x0.

Port of ``videomv_tpu/inference/refine.py`` (reference unet_t2v.py:401-433
via diffusion_ddim.py:256-259). At a refine step the denoiser's eps becomes
a fake x0; four canonical views are VAE-decoded; the LGM reconstructs
Gaussians from them and their Plücker rays; every view is re-rendered
(background 0.5, the packed payload) and re-encoded with the VAE posterior
mode (no noise enters), and those latents are the x0 of the DDIM update.

With a serving mesh (``view_mesh``) the refine runs on one rank's share:

- ``view_mesh_dim='view'`` (frame-parallel serving): the rank holds a block
  of the frames. Each rank decodes the canonical views among its own frames,
  the four are all-gathered, the LGM runs on every rank (replicated), and
  each rank renders and encodes its own frames' views
  (``render_gaussians_view_sharded``);
- ``view_mesh_dim='batch'`` (data-parallel serving): the rank holds whole
  rows and refines them alone.

Each call is traced through ``utils.profiling``: the span ``refine`` (counter
``refine.calls``) and its five stages ``refine.unet`` (the denoiser and the
x0 estimate), ``refine.decode_views``, ``refine.lgm``, ``refine.render``
(projection, binning, composite) and ``refine.encode``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..data.cameras import GSCameraSettings
from ..ops.gaussian_splat import render_gaussians, render_gaussians_view_sharded
from ..parallel.infer import FrameShard
from ..utils import profiling

__all__ = ["REFINE_VIEW_IDXS", "make_refine_fn"]

# ImageNet normalisation of the LGM input (reference unet_t2v.py:383-385)
_VID_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
_VID_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

REFINE_VIEW_IDXS = (0, 6, 12, 18)  # reference unet_t2v.py:407


def make_refine_fn(
    *,
    unet,
    vae,
    lgm,
    diffusion,
    scale_factor: float,
    batch: int,
    gs_settings: GSCameraSettings,
    y: torch.Tensor,
    zero_y: torch.Tensor,
    cam: torch.Tensor,
    gs_rays: torch.Tensor,
    cam_view: torch.Tensor,
    cam_view_proj: torch.Tensor,
    uncond_mode: str = "full",
    view_idxs: tuple = REFINE_VIEW_IDXS,
    view_mesh=None,
    view_mesh_dim: str = "view",
) -> Callable:
    """Build ``refine_fn(xt, t) -> (cond_x0, uncond_x0)`` latents.

    ``gs_rays`` [1, V, 6, S, S] Plücker rays; ``cam_view`` /
    ``cam_view_proj`` [1, V, 4, 4] splat cameras (``data.cameras``).

    ``uncond_mode``: ``"full"`` (the reference's semantics) runs both CFG
    rows through the refine; ``"shared"`` (the shipped serving default)
    refines the cond row only and returns it for both rows, which collapses
    the guidance to the cond refine at half the cost.

    ``view_mesh`` / ``view_mesh_dim``: the serving mesh and how this rank's
    share of the sample lies on it (module docstring): its ``'sp'`` axis
    under ``'view'``, its ``'dp'`` axis under ``'batch'``.
    Under ``'view'``, ``xt`` holds the rank's frames, the UNet is called
    inside the caller's ``frame_sharded``, and ``gs_rays``, ``cam_view`` and
    ``cam_view_proj`` are every view's."""
    if uncond_mode not in ("full", "shared"):
        raise ValueError(f"uncond_mode must be 'full' or 'shared', got {uncond_mode!r}")
    shared = uncond_mode == "shared"
    dev = gs_rays.device
    idxs = torch.as_tensor(view_idxs, dtype=torch.long, device=dev)
    in_size, out_size = gs_settings.input_size, gs_settings.output_size
    vid_mean = torch.as_tensor(_VID_MEAN, device=dev).reshape(1, 1, 3, 1, 1)
    vid_std = torch.as_tensor(_VID_STD, device=dev).reshape(1, 1, 3, 1, 1)
    bg = torch.full((3,), 0.5, device=dev)  # the reference's bg_color_factor 0.5
    view_mesh_axis = "sp" if view_mesh_dim == "view" else "dp"
    shard = (FrameShard.of(view_mesh, cam_view.shape[1], view_mesh_axis)
             if view_mesh is not None and view_mesh_dim == "view" else None)
    if shard is not None:
        # which canonical views each rank holds, padded to the most any holds
        owned = [[i - r * shard.local for i in view_idxs
                  if r * shard.local <= i < (r + 1) * shard.local] for r in range(shard.size)]
        pad = max(len(o) for o in owned)
        mine = torch.as_tensor(owned[shard.index], dtype=torch.long, device=dev)
        # where each canonical view lands in the gathered [n · pad] views
        order = torch.as_tensor([r * pad + owned[r].index(i - r * shard.local)
                                 for i in view_idxs for r in [i // shard.local]],
                                dtype=torch.long, device=dev)

    def decode(lat: torch.Tensor) -> torch.Tensor:
        """[b2, 4ch, k, h, w] latents → [b2, k, 3, H, W] normalised LGM views."""
        b2, k = lat.shape[0], lat.shape[2]
        imgs = vae.decode(lat.permute(0, 2, 1, 3, 4).reshape(b2 * k, 4, *lat.shape[-2:])
                          / scale_factor)
        imgs = imgs.reshape(b2, k, 3, *imgs.shape[-2:])
        return ((imgs * 0.5 + 0.5).clamp(0.0, 1.0) - vid_mean) / vid_std

    def unet_x0(xt, t):
        """The denoiser's x0 estimate of the refined rows."""
        if shared:
            x2, t2, y2, c2 = xt, t, y, cam
        else:
            x2, t2 = torch.cat([xt, xt]), torch.cat([t, t])
            y2, c2 = torch.cat([y, zero_y]), torch.cat([cam, cam])
        eps = unet(x2, t2, y=y2, camera_data=c2)
        return diffusion.pred_to_x0(eps, x2, t2)

    def decode_views(fake_x0):
        """The canonical views of every row: [b2, 4, 3, H, W]."""
        if shard is None:
            return decode(fake_x0.index_select(2, idxs))
        # decode the canonical views among this rank's frames, gather every
        # rank's (padded to the same count) and put them in order
        local = decode(fake_x0.index_select(2, mine)) if len(mine) else None
        size = gs_rays.shape[-1]  # the LGM's input size, the decode's too
        part = fake_x0.new_zeros((fake_x0.shape[0], pad, 3, size, size))
        if local is not None:
            part[:, :len(mine)] = local
        return shard.gather(part, 1).index_select(1, order)

    def render(gaussians):
        """Every view of this rank's share: [b2, V, 3, S, S]."""
        b2 = gaussians.shape[0]
        kw = dict(bg_color=bg, img_size=out_size, fovy_deg=gs_settings.fovy, packed=True)
        cv = cam_view.expand(b2, -1, -1, -1)
        cvp = cam_view_proj.expand(b2, -1, -1, -1)
        if view_mesh is None:
            return render_gaussians(gaussians, cv, cvp, **kw)["image"]
        return render_gaussians_view_sharded(view_mesh, gaussians, cv, cvp, axis=view_mesh_axis,
                                             shard_dim=view_mesh_dim, **kw)["image"]

    def encode(renders):
        """The renders' latents [b2, 4, V, h, w]."""
        b2, V = renders.shape[:2]
        r = renders.reshape(b2 * V, 3, out_size, out_size)
        if out_size != in_size:  # pixel-centre nearest, as jax.image.resize
            r = F.interpolate(r, size=(in_size, in_size), mode="nearest-exact")
        z = vae.encode_first_stage((r - 0.5) / 0.5, scale_factor).float()
        return z.reshape(b2, V, 4, *z.shape[-2:]).permute(0, 2, 1, 3, 4)

    @torch.no_grad()
    def refine_fn(xt: torch.Tensor, t: torch.Tensor):
        profiling.count("refine.calls")
        with profiling.span("refine"):
            with profiling.span("refine.unet"):
                fake_x0 = unet_x0(xt, t)
            with profiling.span("refine.decode_views"):
                imgs = decode_views(fake_x0)
            with profiling.span("refine.lgm"):
                rays = gs_rays.index_select(1, idxs).expand(imgs.shape[0], -1, -1, -1, -1)
                gaussians = lgm(torch.cat([imgs, rays], dim=2))       # [b2, N, 14]
            with profiling.span("refine.render"):
                renders = render(gaussians)
            with profiling.span("refine.encode"):
                z = encode(renders)
        if shared:
            return z, z
        return z[:batch], z[batch:]

    return refine_fn
