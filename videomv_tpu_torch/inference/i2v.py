"""Image→multiview inference pipeline (the I2VGen-XL variant) on PyTorch.

Port of ``videomv_tpu/inference/i2v.py::I2VPipeline`` (reference
inference_i2vgen_entrance.py:65-349), frame-parallel serving included (the
T2V pipeline's ``frame_parallel``):
an RGBA input composited on white, the CLIP global image embedding and the
VAE latent of the reference frame as conditioning, an empty text prompt, a
zero image feature for the unconditional CFG row (``use_zero_infer``),
cosine / zero-terminal-SNR v-prediction diffusion, guidance 6.0, and the
Gaussian-splat refine of the T2V pipeline with the image conditioning kept
in its UNet forward. A request is traced as ``T2VPipeline.generate`` is, with
the image's encodes as ``pipeline.encode.image_clip`` and
``pipeline.encode.local_latent``.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion import ddim_sample_loop
from ..models.clip import VIT_MEAN, VIT_STD, OpenCLIPTextVisual
from ..models.unet_i2v import UNetSD_I2VGen
from ..training.checkpoints import rename_clip_joint_key
from ..utils import profiling
from .pipeline import T2VPipeline, unet_kwargs_from_cfg
from .refine import REFINE_VIEW_IDXS, make_refine_fn

__all__ = ["I2VPipeline", "load_white_composite"]

logger = logging.getLogger(__name__)


def load_white_composite(image_path: str, size: int = 256) -> np.ndarray:
    """RGBA file → white-255 composited float RGB [size, size, 3] in [0, 1]
    (inference_i2vgen_entrance.py:231-241)."""
    from PIL import Image

    img = Image.open(image_path).convert("RGBA")
    bg = Image.new("RGB", img.size, (255, 255, 255))
    bg.paste(img, (0, 0), mask=img)
    bg = bg.resize((size, size), Image.BILINEAR)
    return np.asarray(bg).astype(np.float32) / 255.0


class _ImageConditionedUNet:
    """The UNet as the refine calls it (``unet(x, t, y=, camera_data=)``)
    with the image conditioning added, sized to the incoming batch: ``b``
    rows in the ``shared`` refine (the cond row: the real image embedding),
    ``2b`` rows in ``full`` ([cond; uncond]: the zero image for the second)."""

    def __init__(self, unet, batch, local, img_emb, zero_img):
        self._unet, self._batch = unet, batch
        self._local, self._img, self._zero = local, img_emb, zero_img

    def __call__(self, x2, t2, **kw):
        if x2.shape[0] == self._batch:
            local, image = self._local, self._img
        else:
            local = torch.cat([self._local, self._local])
            image = torch.cat([self._img, self._zero])
        return self._unet(x2, t2, local_image=local, image=image, **kw)


class I2VPipeline(T2VPipeline):
    """Image-conditioned multiview generation on ``device``."""

    _clip_rename = staticmethod(rename_clip_joint_key)

    def __init__(self, cfg, device, seed: int = 0):
        super().__init__(cfg, device, seed=seed)
        with torch.device("meta"):
            self.unet = UNetSD_I2VGen(**unet_kwargs_from_cfg(cfg.get("UNet", {})))
            self.clip = OpenCLIPTextVisual()  # text and visual towers

    # -------------------------------------------------------- conditioning

    @torch.no_grad()
    def encode_image_clip(self, rgb: np.ndarray) -> torch.Tensor:
        """float RGB [H, W, 3] in [0, 1] → CLIP image embedding [1, embed_dim].
        The resize to 224² is bilinear and antialiased (it shrinks), as
        ``jax.image.resize`` does."""
        with profiling.span("pipeline.encode.image_clip"):
            x = torch.as_tensor(np.asarray(rgb, np.float32), device=self.device)
            x = x.permute(2, 0, 1)[None]
            if x.shape[-2:] != (224, 224):
                x = F.interpolate(x, size=(224, 224), mode="bilinear", antialias=True,
                                  align_corners=False)
            mean = torch.as_tensor(VIT_MEAN, device=self.device).reshape(1, 3, 1, 1)
            std = torch.as_tensor(VIT_STD, device=self.device).reshape(1, 3, 1, 1)
            return self.clip.encode_image(((x - mean) / std).to(self.dtype))

    @torch.no_grad()
    def encode_local_latent(self, rgb: np.ndarray) -> torch.Tensor:
        """float RGB [H, W, 3] → VAE latent [1, 4, 1, h, w] (posterior mode,
        scale-factored)."""
        with profiling.span("pipeline.encode.local_latent"):
            x = torch.as_tensor(np.asarray(rgb, np.float32), device=self.device)
            x = x.permute(2, 0, 1)[None] * 2.0 - 1.0
            z = self.vae.encode_first_stage(x.to(self.dtype), self.scale_factor)
            return z[:, :, None]

    # ------------------------------------------------------------- sampler

    @torch.no_grad()
    def sample_i2v(self, noise: torch.Tensor, y: torch.Tensor, zero_y: torch.Tensor,
                   cam: torch.Tensor, local: torch.Tensor, img_emb: torch.Tensor,
                   zero_img: torch.Tensor, steps: int, guide_scale: float,
                   gs: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                   view_mesh=None) -> torch.Tensor:
        """DDIM with CFG from ``noise`` [B, 4, F, h, w]: latents, float32. The
        CFG rows are ``[cond; uncond]``: ``y2 = [y; zero_y]``, the reference
        latent twice, ``image = [img_emb; zero_img]``. ``gs`` = (rays,
        cam_view, cam_view_proj) turns the Gaussian-splat refine on;
        ``view_mesh`` is the frame-parallel mesh whose rank's frames
        ``noise`` and ``cam`` hold (``make_refine_fn``)."""
        b = noise.shape[0]
        unet = self.unet

        def cfg_model(xt, t):
            out = unet(torch.cat([xt, xt]), torch.cat([t, t]), y=torch.cat([y, zero_y]),
                       camera_data=torch.cat([cam, cam]),
                       local_image=torch.cat([local, local]),
                       image=torch.cat([img_emb, zero_img]))
            return out[:b], out[b:]

        refine_fn = None
        if gs is not None:
            if self.lgm is None:
                raise ValueError("the Gaussian-splat refine needs UNet.use_lgm_refine True")
            rays, cam_view, cam_view_proj = gs
            refine_fn = make_refine_fn(
                unet=_ImageConditionedUNet(unet, b, local, img_emb, zero_img), vae=self.vae,
                lgm=self.lgm, diffusion=self.diffusion, scale_factor=self.scale_factor,
                batch=b, gs_settings=self.gs_settings, y=y, zero_y=zero_y, cam=cam,
                gs_rays=rays, cam_view=cam_view, cam_view_proj=cam_view_proj,
                uncond_mode=str(self.cfg.get("gs_refine_uncond", "full")),
                view_idxs=tuple(self.cfg.get("gs_refine_views", REFINE_VIEW_IDXS)),
                view_mesh=view_mesh)
        return ddim_sample_loop(
            self.diffusion, cfg_model, noise, ddim_timesteps=steps, guide_scale=guide_scale,
            refine_fn=refine_fn,
            refine_steps=tuple(self.cfg.get("gs_refine_steps", (20, 30, 40))))

    # ------------------------------------------------------------ generate

    @torch.no_grad()
    def generate_from_image(
        self,
        image_path: str,
        steps: int = 50,
        guide_scale: Optional[float] = None,
        use_gs_refine: bool = False,
        seed: Optional[int] = None,
        elevation: float = 15.0,
        camera_distance: float = 2.0,
        frame_parallel: bool = False,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, np.ndarray]:
        """One image → ``max_frames`` orbit views: frames uint8 [F, H, W, 3]
        and latents [1, 4, F, h, w]. The text prompt is empty; the negative
        prompt's encoding is cached. Deterministic in ``seed`` (noise from a
        ``torch.Generator`` on the device); ``noise`` replaces it.
        ``frame_parallel`` spreads the sample's frames over the ranks, as
        ``T2VPipeline.generate`` does."""
        with profiling.request("pipeline.request", self.device):
            cfg = self.cfg
            if guide_scale is None:
                guide_scale = float(cfg.get("guide_scale", 6.0))
            seed = seed if seed is not None else int(cfg.get("seed", 0))

            rgb = load_white_composite(image_path, self.resolution[0])
            y_words = self.encode_text([""])
            negative_words = self._negative()
            y_visual = self.encode_image_clip(rgb)
            zero_img = (torch.zeros_like(y_visual) if bool(cfg.get("use_zero_infer", True))
                        else y_visual)
            local = self.encode_local_latent(rgb)

            cam, *gs = self._get_cameras(elevation, camera_distance)
            gs = tuple(gs) if use_gs_refine else None
            if noise is None:
                noise = self._noise(1, seed)
            mesh = self._serving_mesh() if frame_parallel else None
            if mesh is None:
                self._whole_unet("generate_from_image(frame_parallel=False)")
                latents = self.sample_i2v(noise, y_words, negative_words, cam, local, y_visual,
                                          zero_img, steps, guide_scale, gs=gs)
                frames = self._decode_latents(latents)
            else:
                latents, frames = self._frame_parallel(
                    mesh, noise, cam, lambda nz, cm: self.sample_i2v(
                        nz, y_words, negative_words, cm, local, y_visual, zero_img, steps,
                        guide_scale, gs=gs, view_mesh=mesh if gs else None))
            return self._to_host(frames, latents)
