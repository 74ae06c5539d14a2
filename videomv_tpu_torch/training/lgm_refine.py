"""LGM-refine training: 3D-consistency supervision through the renderer.

Port of ``videomv_tpu/training/lgm_refine.py`` (the reference's
``use_lgm_refine`` training path, unet_t2v.py:370-400): the frozen denoiser
predicts eps at a random t; a fake x0 is decoded for 4 randomly chosen
views; the LGM reconstructs Gaussians from those views and their Plücker
rays; 8 supervision views (4 extra random ones, then the same 4) are
splat-rendered and compared with the ground truth by MSE on image and alpha
plus ``lambda_lpips`` · LPIPS (reference core/models.py:136-188).

Against the JAX step:
  - the LGM is an ``nn.Module`` with fp32 master parameters; it is the only
    module that records a gradient. The UNet and the VAE decode run under
    ``torch.no_grad`` (JAX ``stop_gradient``), LPIPS is differentiated
    through, never into;
  - the view-chunk ``lax.scan`` under ``jax.checkpoint`` is a Python loop
    whose body runs under ``torch.utils.checkpoint``: one chunk's render and
    VGG activations live at a time, and each chunk's gradient accumulates
    into the Gaussians;
  - every random draw of a step (t, noise, the two view permutations, the
    background, the seed of the UNet's dropout) comes from one explicit
    ``torch.Generator`` (``draw_refine_randoms``) and can be passed in, so
    a test can feed another framework's draws;
  - rendering goes through ``render_gaussians``: on the card the tile-binned
    path with the composite's forward and backward CUDA kernels, on the CPU
    the dense oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.gaussian_splat import render_gaussians
from ..parallel.collectives import all_reduce
from ..parallel.train_step import sync_grads
from ..ops.gs_cameras import canonical_gs_poses, colmap_from_poses, plucker_rays_dev, proj_matrix

__all__ = ["LGMTrainState", "RefineDraws", "build_lgm_refine_step", "draw_refine_randoms"]

# ImageNet normalisation of the LGM input (reference unet_t2v.py:383-385)
_VID_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
_VID_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


@dataclasses.dataclass
class LGMTrainState:
    """What a step changes: the step count, the LGM and its optimizer."""

    step: int
    lgm: torch.nn.Module
    optimizer: object


@dataclasses.dataclass
class RefineDraws:
    """The random draws of one step."""

    t: torch.Tensor        # [B] int64 timesteps
    noise: torch.Tensor    # like the latents
    idxs: torch.Tensor     # [n_input_views] int64, the LGM's input views
    extra: torch.Tensor    # [n_supervise_extra] int64, extra supervision views
    bg: torch.Tensor       # [3] background colour in [0, 1)
    dropout_seed: int      # seeds the frozen UNet's dropout masks


def draw_refine_randoms(generator: torch.Generator, latents: torch.Tensor, diffusion,
                        n_input_views: int, n_supervise_extra: int,
                        rows: Optional[int] = None) -> RefineDraws:
    """One step's draws from ``generator`` (which lives on the latents'
    device or on the CPU), for ``rows`` rows shaped like ``latents``
    (default: its own rows)."""
    dev = generator.device
    b, f = (latents.shape[0] if rows is None else rows), latents.shape[2]
    t = torch.randint(0, diffusion.num_timesteps, (b,), generator=generator, device=dev)
    noise = diffusion.sample_noise(latents.new_empty((b,) + tuple(latents.shape[1:]), device=dev),
                                   generator)
    idxs = torch.randperm(f, generator=generator, device=dev)[:n_input_views]
    extra = torch.randperm(f, generator=generator, device=dev)[:n_supervise_extra]
    bg = torch.rand(3, generator=generator, device=dev)
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator, device=dev))
    to = latents.device
    return RefineDraws(t.to(to), noise.to(to), idxs.to(to), extra.to(to), bg.to(to), seed)


def build_lgm_refine_step(
    unet_apply_fn,
    vae,
    lgm,
    diffusion,
    scale_factor: float = 0.18215,
    n_input_views: int = 4,
    n_supervise_extra: int = 4,
    render_size: int = 256,
    fovy_deg: float = 39.6,
    ray_size: int = 256,
    znear: float = 0.5,
    zfar: float = 2.5,
    splat_backend: str = "auto",
    lpips=None,
    lambda_lpips: float = 1.0,
    view_chunk: int = 0,
    autocast_dtype: Optional[torch.dtype] = None,
    mesh=None,
):
    """Create ``refine_step(state, batch, generator=None, draws=None) ->
    (loss, aux)``, one LGM-finetune step. The frozen denoiser is called as
    ``unet_apply_fn(xt, t, y, batch)`` (``parallel.make_t2v_apply`` or
    ``make_i2v_apply``, as in the JAX step). ``refine_step.loss_fn(batch,
    draws)`` is its loss alone, the composition of ``refine_step.prepare``
    (the frozen, gradient-free part) and ``refine_step.loss_from`` (LGM →
    render → losses).

    batch: ``latents [B, 4, F, h, w]``, ``y_words``, optional
    ``camera_data [B, F, 16]``, what ``unet_apply_fn`` reads besides (the
    I2V reference frame), and the supervision block: ``images_gt
    [B, F, 3, R, R]`` in [0, 1] (or uint8, converted on the device so the
    host→device wire stays 4× thinner), ``masks_gt [B, F, 1, R, R]`` (same
    rule), plus either host-prepared ``gs_rays [B, F, 6, S, S]`` with
    ``cam_view`` / ``cam_view_proj [B, F, 4, 4]``, or nothing: then the step
    derives rays and colmap matrices on the device from ``camera_data``
    (``ops.gs_cameras``; ``ray_size`` / ``znear`` / ``zfar`` configure it).

    ``lpips``: an optional ``models.lpips.LPIPS``; the loss then adds
    ``lambda_lpips · LPIPS(gt, pred)`` on [-1, 1] views bilinear-resized to
    at most 256² (reference core/models.py:167-184).

    ``view_chunk`` > 0 renders and scores the supervision views in chunks of
    that many, each rematerialised in the backward pass; equal chunks make
    the mean of chunk means the global mean, so the loss is the unchunked
    one. ``autocast_dtype`` (bf16 on the card) runs the LGM's forward under
    autocast over its fp32 parameters.

    ``mesh``: the 1-D data mesh for the data-parallel step. ``batch`` holds
    this rank's rows; the draws (given or drawn) are the global batch's, of
    which the rank keeps its t and noise rows, while the views, the
    background and the dropout seed are the step's (the seed offset by the
    rank, so the frozen UNet's masks differ across ranks). The LGM is
    replicated: its gradients are averaged over the ranks, and the loss
    returned is the global mean (``aux`` is of this rank's rows)."""
    proj = proj_matrix(fovy_deg, znear, zfar)

    def prepare(batch: Dict[str, torch.Tensor], draws: RefineDraws) -> Dict[str, torch.Tensor]:
        """The part of the step that records no gradient: the frozen UNet and
        VAE decode, the cameras and the composited ground truth. Returns the
        LGM's input and what the render is scored against."""
        latents = batch["latents"]
        dev = latents.device
        b = latents.shape[0]
        vid_mean = torch.as_tensor(_VID_MEAN, device=dev).reshape(1, 1, 3, 1, 1)
        vid_std = torch.as_tensor(_VID_STD, device=dev).reshape(1, 1, 3, 1, 1)
        idxs, sup_idxs = draws.idxs, torch.cat([draws.extra, draws.idxs])  # reference order

        with torch.no_grad():
            xt = diffusion.q_sample(latents, draws.t, draws.noise)
            devices = [dev] if dev.type == "cuda" else []
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(draws.dropout_seed)  # the UNet's dropout masks
                eps = unet_apply_fn(xt, draws.t, batch["y_words"], batch)
            fake_x0 = diffusion.pred_to_x0(eps, xt, draws.t)

            if "gs_rays" in batch:
                rays = batch["gs_rays"].index_select(1, idxs)
                cv = batch["cam_view"].index_select(1, sup_idxs)
                cvp = batch["cam_view_proj"].index_select(1, sup_idxs)
            else:
                # the splat cameras from the 16-float camera conditioning
                poses = canonical_gs_poses(batch["camera_data"])
                rays = plucker_rays_dev(poses.index_select(1, idxs), ray_size, fovy_deg)
                cv, cvp, _ = colmap_from_poses(poses.index_select(1, sup_idxs), proj)

            dec = fake_x0.index_select(2, idxs).permute(0, 2, 1, 3, 4)
            dec = dec.reshape(b * n_input_views, 4, *dec.shape[-2:])
            imgs = vae.decode(dec / scale_factor).float()
            ray_hw = rays.shape[-1]
            if imgs.shape[-1] != ray_hw:  # pixel-centre nearest, as jax.image.resize
                imgs = F.interpolate(imgs, size=(ray_hw, ray_hw), mode="nearest-exact")
            imgs = imgs.reshape(b, n_input_views, 3, ray_hw, ray_hw)
            imgs = ((imgs * 0.5 + 0.5).clamp(0.0, 1.0) - vid_mean) / vid_std
            lgm_in = torch.cat([imgs, rays.float()], dim=2)    # [B, 4, 9, S, S]

            # random background as in LGM training (core/models.py:151-152)
            bg = draws.bg.float()
            gt_img = batch["images_gt"].index_select(1, sup_idxs)
            gt_mask = batch["masks_gt"].index_select(1, sup_idxs)
            if gt_img.dtype == torch.uint8:
                gt_img = gt_img.float() / 255.0
            if gt_mask.dtype == torch.uint8:
                gt_mask = gt_mask.float() / 255.0
            gt_img = gt_img * gt_mask + bg.reshape(1, 1, 3, 1, 1) * (1 - gt_mask)
        return dict(lgm_in=lgm_in, cam_view=cv, cam_view_proj=cvp, gt_img=gt_img,
                    gt_mask=gt_mask, bg=bg)

    def loss_from(prep: Dict[str, torch.Tensor], gaussians: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The differentiable part: LGM → render → losses. With ``gaussians``
        given, the LGM is skipped and they are rendered instead."""
        lgm_in, cv, cvp = prep["lgm_in"], prep["cam_view"], prep["cam_view_proj"]
        gt_img, gt_mask, bg = prep["gt_img"], prep["gt_mask"], prep["bg"]
        dev = lgm_in.device
        b = lgm_in.shape[0]
        if gaussians is None:
            if autocast_dtype is not None:
                with torch.autocast(device_type=dev.type, dtype=autocast_dtype):
                    gaussians = lgm(lgm_in)
            else:
                gaussians = lgm(lgm_in)
        nv = cv.shape[1]

        def chunk_losses(gaussians, cv_c, cvp_c, gt_img_c, gt_mask_c):
            out = render_gaussians(gaussians, cv_c, cvp_c, bg_color=bg, img_size=render_size,
                                   fovy_deg=fovy_deg, backend=splat_backend)
            l_img = ((out["image"] - gt_img_c) ** 2).mean()
            l_alpha = ((out["alpha"] - gt_mask_c) ** 2).mean()
            l_lp = torch.zeros((), device=dev)
            if lpips is not None and lambda_lpips > 0:
                vc = out["image"].shape[1]
                lp_size = min(256, render_size)
                pred = out["image"].reshape(b * vc, 3, render_size, render_size)
                gt = gt_img_c.reshape(b * vc, 3, render_size, render_size)
                if render_size != lp_size:  # jax.image.resize's bilinear, antialiased
                    kw = dict(size=(lp_size, lp_size), mode="bilinear", antialias=True,
                              align_corners=False)
                    pred, gt = F.interpolate(pred, **kw), F.interpolate(gt, **kw)
                l_lp = lpips(gt * 2.0 - 1.0, pred * 2.0 - 1.0).mean()
            return l_img, l_alpha, l_lp

        if 0 < view_chunk < nv and nv % view_chunk == 0:
            nc = nv // view_chunk
            sums = [torch.zeros((), device=dev) for _ in range(3)]
            for c in range(nc):
                sl = slice(c * view_chunk, (c + 1) * view_chunk)
                parts = checkpoint(chunk_losses, gaussians, cv[:, sl], cvp[:, sl],
                                   gt_img[:, sl], gt_mask[:, sl], use_reentrant=False)
                sums = [s + p for s, p in zip(sums, parts)]
            loss_img, loss_alpha, loss_lpips = (s / nc for s in sums)
        else:
            loss_img, loss_alpha, loss_lpips = chunk_losses(gaussians, cv, cvp, gt_img, gt_mask)
        loss = loss_img + loss_alpha + lambda_lpips * loss_lpips
        psnr = -10.0 * torch.log10(loss_img.detach() + 1e-12)
        return loss, {"psnr": psnr, "loss_lpips": loss_lpips.detach()}

    def loss_fn(batch: Dict[str, torch.Tensor], draws: RefineDraws
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return loss_from(prepare(batch, draws))

    n = 1 if mesh is None else mesh.size()
    r = 0 if mesh is None else mesh.get_local_rank()

    def refine_step(state: LGMTrainState, batch: Dict[str, torch.Tensor],
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[RefineDraws] = None):
        if draws is None:
            if generator is None:
                raise ValueError("refine_step needs a generator or the step's draws")
            draws = draw_refine_randoms(generator, batch["latents"], diffusion, n_input_views,
                                        n_supervise_extra, rows=n * batch["latents"].shape[0])
        if n > 1:
            k = draws.t.shape[0] // n
            draws = dataclasses.replace(draws, t=draws.t[r * k:(r + 1) * k],
                                        noise=draws.noise[r * k:(r + 1) * k],
                                        dropout_seed=draws.dropout_seed + r)
        state.optimizer.zero_grad()
        loss, aux = loss_fn(batch, draws)
        loss.backward()
        loss = loss.detach()
        if n > 1:
            sync_grads(state.lgm.parameters(), mesh.get_group(), n)
            loss = all_reduce(loss.clone(), mesh.get_group()).div_(n)
        state.optimizer.step()
        state.step += 1
        return loss, aux

    refine_step.loss_fn = loss_fn
    refine_step.prepare = prepare
    refine_step.loss_from = loss_from
    return refine_step
