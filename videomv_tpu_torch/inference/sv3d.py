"""Image→orbit inference with Stable Video 3D (``sv3d_p``) on PyTorch.

The sampling of ``scripts/sampling/simple_video_sample.py`` (``version ==
"sv3d_p"``, Stability-AI/generative-models) with the models of
``scripts/sampling/configs/sv3d_p.yaml``, on one explicit ``device``:

1. the input: an RGBA file composited on white at the config's
   ``resolution`` (576²), in [-1, 1];
2. the conditioning, once a request: the CLIP image token (the ViT-H visual
   tower's pooled projection, ``pipeline.encode.image_clip``), repeated over
   the frames; the concat latent, the SD VAE encoder's mode of the image plus
   ``cond_aug``·n, unscaled (``pipeline.encode.cond_latent``); the camera
   vector of each frame (``camera_vector``: the sinusoidal embeddings of
   cond_aug, the polar angle 90° − elevation and the azimuth);
3. 50 Euler steps (``diffusion/edm.py``) from the seed's noise, each a CFG
   forward of ``2T`` rows, ``[cond; uncond]``: the uncond rows take a zero
   CLIP token and a zero concat latent and the same camera vectors; the
   guidance is the triangle scale over the frames;
4. the decode: latents / 0.18215 through the SD VAE decoder, ``decoding_t``
   frames at a time (14), to uint8 views on the device.

The UNet's forward is served from a CUDA graph (``unet.graphs``,
``models/graphed.py``), one for the request's single signature. A request
is traced as the other pipelines' are (``utils.profiling``): the root span
``pipeline.request``, the two encodes, the sampler's steps and forwards,
``pipeline.decode`` and ``pipeline.to_host``.

Departures from the source, each for the port's serving path: the image is
composited on white and resized, not re-centred on its alpha's bounding box;
the CLIP tower's 224² resize is the port's bilinear, antialiased one (the
source's is bicubic); the last view is the decoded frame, not the input
image pasted over it.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AttrDict
from ..diffusion.edm import GuidedDenoiser, edm_sigmas, euler_sample_loop, triangle_scale
from ..models.autoencoder import AutoencoderKL
from ..models.blocks import sinusoidal_embedding
from ..models.clip import VIT_MEAN, VIT_STD, CLIPVisionTower
from ..models.graphed import GraphedForward
from ..models.unet_sv3d import VideoUNet
from ..training.checkpoints import init_models
from ..utils import profiling
from .i2v import load_white_composite

__all__ = ["SV3DPipeline", "camera_vector", "orbit_angles"]

logger = logging.getLogger(__name__)


def orbit_angles(frames: int, elevations_deg: Union[float, Sequence[float]]):
    """``(polars_rad, azimuths_rad)`` [frames] of the source script: polar =
    90° − elevation; azimuths evenly spaced and shifted so that the last
    frame sits at the input's view (0)."""
    elev = np.broadcast_to(np.asarray(elevations_deg, np.float64), (frames,))
    az = np.linspace(0, 360, frames + 1)[1:] % 360
    az = (az - az[-1]) % 360
    return np.deg2rad(90.0 - elev), np.deg2rad(az)


def camera_vector(cond_aug: float, polars_rad, azimuths_rad, device=None) -> torch.Tensor:
    """[frames, 1280] fp32: each frame's sinusoidal embeddings of cond_aug
    (256), its polar angle (512) and its azimuth (512), concatenated (the
    source's three ``ConcatTimestepEmbedderND``)."""
    pol = torch.as_tensor(np.asarray(polars_rad, np.float64), device=device).float()
    azi = torch.as_tensor(np.asarray(azimuths_rad, np.float64), device=device).float()
    aug = torch.full_like(pol, float(cond_aug))
    return torch.cat([sinusoidal_embedding(aug, 256), sinusoidal_embedding(pol, 512),
                      sinusoidal_embedding(azi, 512)], dim=1)


class SV3DPipeline:
    """Builds the SV3D models from a merged config and serves images on
    ``device`` (``generate_from_image``)."""

    def __init__(self, cfg: AttrDict, device, seed: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        self.seed = seed
        sd = str(cfg["sampling_dtype"]).lower()
        self.dtype = torch.float32 if sd in ("float32", "fp32", "f32") else torch.bfloat16
        self.resolution = int(list(cfg["resolution"])[0])
        self.latent_hw = self.resolution // int(cfg["scale"])
        self.scale_factor = float(cfg["scale_factor"])
        self.cond_aug = float(cfg["cond_aug"])
        self.decoding_t = int(cfg["decoding_t"])
        s = cfg["Sampler"]
        self.sigmas = edm_sigmas(int(s["num_steps"]), float(s["sigma_min"]),
                                 float(s["sigma_max"]), float(s["rho"]))
        with torch.device("meta"):
            self.unet = VideoUNet(**dict(cfg["VideoUNet"]))
            self.vae = AutoencoderKL(**dict(cfg["models"]["vae"]))
            self.clip = CLIPVisionTower(**dict(cfg["models"]["clip_visual"]))
        self.num_frames = self.unet.num_frames
        g = s["guider"]
        self.guide = triangle_scale(self.num_frames, float(g["max_scale"]),
                                    float(g["min_scale"]), float(g["period"]))
        self.denoiser: Optional[GuidedDenoiser] = None

    @property
    def models(self) -> Dict[str, torch.nn.Module]:
        return {"unet": self.unet, "vae": self.vae, "clip": self.clip}

    # ------------------------------------------------------------ params

    def init_params(self) -> None:
        """Seed every model on ``device`` (zero-init layers zeroed)."""
        t0 = time.time()
        init_models([(m, self.seed + i) for i, m in enumerate(self.models.values())],
                    device=self.device)
        logger.info("param init took %.1fs", time.time() - t0)
        self._finalize()

    def load_state_dicts(self, **state_dicts: Dict[str, torch.Tensor]) -> None:
        """Load complete state dicts by model name (``unet=``, ``vae=``,
        ``clip=``; strict)."""
        for name, sd in state_dicts.items():
            m = self.models[name]
            if any(p.device.type == "meta" for p in m.parameters()):
                m.to_empty(device=self.device)
            m.load_state_dict(sd, strict=True)
        self._finalize()

    def _finalize(self) -> None:
        for m in self.models.values():
            if any(p.device.type == "meta" for p in m.parameters()):
                continue
            m.to(device=self.device, dtype=self.dtype).eval().requires_grad_(False)
        # the served forward's CUDA graphs, none captured yet for these weights
        self.unet.graphs = GraphedForward()
        self.denoiser = GuidedDenoiser(self.unet, self.guide.to(self.device))

    # ------------------------------------------------------- conditioning

    def load_image(self, image_path: str) -> torch.Tensor:
        """RGBA file → RGB [1, 3, R, R] in [-1, 1] on the device, composited
        on white."""
        rgb = load_white_composite(image_path, self.resolution)
        x = torch.as_tensor(rgb, device=self.device).permute(2, 0, 1)[None]
        return x * 2.0 - 1.0

    @torch.no_grad()
    def encode_image_clip(self, image: torch.Tensor) -> torch.Tensor:
        """Image [1, 3, R, R] in [-1, 1] → the CLIP image token [1, 1, 1024]."""
        with profiling.span("pipeline.encode.image_clip"):
            x = (image + 1.0) / 2.0
            if x.shape[-2:] != (224, 224):
                x = F.interpolate(x, size=(224, 224), mode="bilinear", antialias=True,
                                  align_corners=False)
            mean = torch.as_tensor(VIT_MEAN, device=self.device).reshape(1, 3, 1, 1)
            std = torch.as_tensor(VIT_STD, device=self.device).reshape(1, 3, 1, 1)
            return self.clip(((x - mean) / std).to(self.dtype))[:, None]

    @torch.no_grad()
    def encode_cond_latent(self, image: torch.Tensor, aug_noise: torch.Tensor) -> torch.Tensor:
        """The concat latent [1, 4, h, w] (fp32): the VAE encoder's mode of
        ``image + cond_aug·aug_noise``, unscaled."""
        with profiling.span("pipeline.encode.cond_latent"):
            x = image + self.cond_aug * aug_noise
            return self.vae.encode_first_stage(x.to(self.dtype), 1.0).float()

    def draws(self, seed: int):
        """The seed's sampler noise [T, 4, h, w] and cond-aug noise [1, 3,
        R, R], drawn in that order from one generator on the device."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        h, r = self.latent_hw, self.resolution
        noise = torch.randn((self.num_frames, 4, h, h), generator=gen, device=self.device)
        aug = torch.randn((1, 3, r, r), generator=gen, device=self.device)
        return noise, aug

    # ------------------------------------------------------------- sample

    @torch.no_grad()
    def sample(self, noise: torch.Tensor, token: torch.Tensor, latent: torch.Tensor,
               vector: torch.Tensor) -> torch.Tensor:
        """Euler with the triangle CFG from ``noise`` [T, 4, h, w]: latents,
        float32. ``token`` [1, 1, 1024], ``latent`` [1, 4, h, w] and
        ``vector`` [T, 1280] are the cond row's; the uncond rows zero the
        first two."""
        t = self.num_frames
        context = torch.cat([token.expand(t, -1, -1), torch.zeros_like(token).expand(t, -1, -1)])
        concat = torch.cat([latent.expand(t, -1, -1, -1),
                            torch.zeros_like(latent).expand(t, -1, -1, -1)])
        y = torch.cat([vector, vector]).to(self.dtype)
        denoiser = self.denoiser

        def denoise(x, sigma):
            return denoiser(x, sigma, context=context, concat=concat, y=y)

        return euler_sample_loop(denoise, noise, self.sigmas)

    @torch.no_grad()
    def _decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """[T, 4, h, w] → [T, R, R, 3] uint8 on the device, ``decoding_t``
        frames at a time."""
        with profiling.span("pipeline.decode"):
            z = latents / self.scale_factor
            img = torch.cat([self.vae.decode(z[i:i + self.decoding_t])
                             for i in range(0, z.shape[0], self.decoding_t)])
            img = (img * 0.5 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)
            return torch.round(img * 255.0).to(torch.uint8)

    @staticmethod
    def _to_host(frames: torch.Tensor, latents: torch.Tensor) -> Dict[str, np.ndarray]:
        with profiling.span("pipeline.to_host"):
            return {"frames": frames.cpu().numpy(), "latents": latents.cpu().numpy()}

    @torch.no_grad()
    def generate_from_image(self, image_path: str, seed: Optional[int] = None,
                            elevations: Union[float, Sequence[float], None] = None
                            ) -> Dict[str, np.ndarray]:
        """One image → ``num_frames`` orbit views: frames uint8 [T, R, R, 3]
        and latents [T, 4, h, w]. ``elevations`` (degrees; one, or one a
        frame) defaults to the config's ``elevation``. Deterministic in
        ``seed`` (``draws``)."""
        with profiling.request("pipeline.request", self.device):
            seed = int(seed if seed is not None else self.cfg["seed"])
            if elevations is None:
                elevations = float(self.cfg["elevation"])
            image = self.load_image(image_path)
            noise, aug = self.draws(seed)
            token = self.encode_image_clip(image)
            latent = self.encode_cond_latent(image, aug)
            polars, azimuths = orbit_angles(self.num_frames, elevations)
            vector = camera_vector(self.cond_aug, polars, azimuths, self.device)
            latents = self.sample(noise, token, latent, vector)
            return self._to_host(self._decode_latents(latents), latents)
