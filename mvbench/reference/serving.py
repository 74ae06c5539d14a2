"""The served request, plainly: text (and for I2V image) conditioning, the
CFG denoiser and its DDIM step, the Gaussian-splat refine, the final decode.

``ServeReference`` builds the configuration's models from the benchmark's
state dicts in the dtype it is given (float32 for the reference) and works
each stage out again from the request's own inputs (prompt, image file,
noise) or, where the sampler's state is the program's (a denoising step
taken from the program's x_t), from that state. It imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import cameras, nets, render, tokenizer
from .diffusion import DDIM, guided, implied_eps

VID_MEAN = (0.485, 0.456, 0.406)
VID_STD = (0.229, 0.224, 0.225)
VIT_MEAN = (0.48145466, 0.4578275, 0.40821073)
VIT_STD = (0.26862954, 0.26130258, 0.27577711)
REFINE_VIEWS = (0, 6, 12, 18)


UNET_SIZES = ("in_dim", "dim", "context_dim", "out_dim", "dim_mult", "num_heads", "head_dim",
              "num_res_blocks", "attn_scales")


def build_models(config: dict, i2v: bool) -> Dict[str, torch.nn.Module]:
    """The configuration's models (on the current default device): the
    denoiser at the widths of the shipped ``UNet`` block, the others at the
    sizes under ``models``."""
    sizes, shipped = config["models"], config["pipeline"]["UNet"]
    u = {k: shipped[k] for k in UNET_SIZES + (("y_dim",) if i2v else ())}
    models = {"unet": nets.UNetI2V(**u) if i2v else nets.UNetT2V(**u),
              "vae": nets.VAE(**sizes["vae"]),
              "clip": nets.CLIPText(**sizes["clip"])}
    if config["pipeline"]["UNet"].get("use_lgm_refine", False):
        models["lgm"] = nets.LGM(**nets.lgm_options(sizes["lgm"]))
    return models


def white_composite(path: str, size: int) -> np.ndarray:
    """An RGBA file over white, resized bilinearly: float RGB [size, size, 3]."""
    from PIL import Image

    img = Image.open(path).convert("RGBA")
    bg = Image.new("RGB", img.size, (255, 255, 255))
    bg.paste(img, (0, 0), mask=img)
    return np.asarray(bg.resize((size, size), Image.BILINEAR)).astype(np.float32) / 255.0


class ServeReference:
    def __init__(self, config: dict, i2v: bool, state_dicts: Dict[str, Dict[str, torch.Tensor]],
                 device, dtype=torch.float32, models: Optional[dict] = None):
        self.cfg = config["pipeline"]
        self.i2v, self.device, self.dtype = i2v, torch.device(device), dtype
        if models is None:
            with torch.device("meta"):
                models = build_models(config, i2v)
            for name, m in models.items():
                m.to_empty(device=self.device)
                m.load_state_dict({k: v.to(self.device, dtype) for k, v in
                                   state_dicts[name].items()}, strict=True)
                m.eval().requires_grad_(False)
        self.m = models
        self.ddim = DDIM(self.cfg["Diffusion"])
        self.frames = int(self.cfg.get("max_frames", 24))
        self.scale_factor = float(self.cfg.get("scale_factor", 0.18215))
        self.res = int(self.cfg.get("resolution", [256, 256])[0])
        lgm_sizes = nets.lgm_options(config["models"].get("lgm", "big"))
        self.in_size = int(self.cfg.get("gs_input_size", lgm_sizes["input_size"]))
        self.out_size = int(self.cfg.get("gs_render_size", 256))
        self.fovy = float(lgm_sizes["fovy"])
        self.splat = int(lgm_sizes["splat_size"])
        self.views = tuple(self.cfg.get("gs_refine_views", REFINE_VIEWS))
        self.shared = str(self.cfg.get("gs_refine_uncond", "full")) == "shared"
        cam = cameras.orbit_camera_for_t2v(self.frames, 15.0, 2.0)
        gs = cameras.prepare_gs_training(
            cameras.orbit_c2w_opengl(self.frames, 15.0, 2.0),
            cameras.GSCameraSettings(input_size=self.in_size, output_size=self.out_size),
            ray_size=self.in_size)
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)
        self.cam, self.rays = as_t(cam), as_t(gs["input_rays"])
        self.cam_view, self.cam_view_proj = as_t(gs["cam_view"]), as_t(gs["cam_view_proj"])

    # ----------------------------------------------------------- conditioning

    @torch.no_grad()
    def text(self, prompt: str) -> torch.Tensor:
        toks = torch.as_tensor(tokenizer.tokenize([prompt]), dtype=torch.long,
                               device=self.device)
        return self.m["clip"].encode_text(toks).float()

    @torch.no_grad()
    def conditioning(self, item: dict) -> Dict[str, torch.Tensor]:
        """The CFG rows' conditioning of a request: ``y`` and ``zero_y``
        [1, 77, W]; for I2V also ``image`` [1, E] and ``local`` [1, 4, 1, h, w]."""
        neg = self.text(str(self.cfg.get("negative_prompt", "")))
        if not self.i2v:
            prompt = item["prompt"]
            if "3d asset" not in prompt:
                prompt = prompt + ", 3d asset"
            return {"y": self.text(prompt), "zero_y": neg}
        rgb = torch.as_tensor(white_composite(item["image"], self.res), device=self.device)
        x = rgb.permute(2, 0, 1)[None]
        x224 = F.interpolate(x, size=(224, 224), mode="bilinear", antialias=True,
                             align_corners=False)
        mean = torch.tensor(VIT_MEAN, device=self.device).reshape(1, 3, 1, 1)
        std = torch.tensor(VIT_STD, device=self.device).reshape(1, 3, 1, 1)
        image = self.m["clip"].visual((x224 - mean) / std).float()
        local = self.scale_factor * self.m["vae"].encode_mode(x * 2.0 - 1.0).float()
        return {"y": self.text(""), "zero_y": neg, "image": image, "local": local[:, :, None]}

    # ---------------------------------------------------------------- denoiser

    def _unet(self, x, t: int, c: Dict[str, torch.Tensor], rows: str):
        """The denoiser over ``rows``: ``"cfg"`` ([cond; uncond]) or ``"cond"``."""
        b = x.shape[0]
        two = rows == "cfg"
        xx = torch.cat([x, x]) if two else x
        tt = torch.full((xx.shape[0],), t, dtype=torch.long, device=self.device)
        y = torch.cat([c["y"], c["zero_y"]]) if two else c["y"]
        cam = self.cam.expand(xx.shape[0], -1, -1)
        if not self.i2v:
            out = self.m["unet"](xx.float(), tt, y=y, camera_data=cam)
        else:
            local = c["local"].expand(xx.shape[0], -1, -1, -1, -1)
            img = torch.cat([c["image"], torch.zeros_like(c["image"])]) if two else c["image"]
            out = self.m["unet"](xx.float(), tt, y=y, camera_data=cam, local_image=local,
                                 image=img)
        return (out[:b], out[b:]) if two else out

    @torch.no_grad()
    def step_eps(self, xt: torch.Tensor, x_next: torch.Tensor, i: int, steps: int,
                 guide_scale: float, c: Dict[str, torch.Tensor]):
        """A plain DDIM step at loop index ``i`` from the program's x_t: the
        eps the program's update to ``x_next`` used, and the reference's
        (the guided prediction of the CFG rows, through x0), float64."""
        t = self.ddim.timesteps(steps)[i]
        a, a_prev = self.ddim._a(t), self.ddim._a(t - self.ddim.T // steps)
        cond, uncond = self._unet(xt, t, c, "cfg")
        x0 = self.ddim.x0(guided(cond.double(), uncond.double(), guide_scale), xt, t)
        eps_ref = (math.sqrt(1 / max(a, 1e-12)) * xt.double() - x0) / math.sqrt(
            1 / max(a, 1e-12) - 1)
        return implied_eps(x_next, xt, a, a_prev), eps_ref

    @torch.no_grad()
    def lgm_input(self, xt: torch.Tensor, i: int, steps: int, c: Dict[str, torch.Tensor]):
        """The refine's first stage from x_t at loop index ``i``: the cond
        row's x0 estimate, the refine views decoded and normalised, beside
        their rays: the LGM's input [1, k, 9, S, S]."""
        if not self.shared:
            raise ValueError("the reference refines the cond row only (gs_refine_uncond shared)")
        t = self.ddim.timesteps(steps)[i]
        fake_x0 = self.ddim.x0(self._unet(xt, t, c, "cond"), xt, t).float()
        idx = list(self.views)
        lat = fake_x0[:, :, idx][0].permute(1, 0, 2, 3)                     # [k, 4, h, w]
        imgs = (self.m["vae"].decode(lat / self.scale_factor) * 0.5 + 0.5).clamp(0.0, 1.0)
        mean = torch.tensor(VID_MEAN, device=self.device).reshape(1, 3, 1, 1)
        std = torch.tensor(VID_STD, device=self.device).reshape(1, 3, 1, 1)
        return torch.cat([(imgs - mean) / std, self.rays[0, idx]], dim=1)[None]

    @torch.no_grad()
    def gaussians(self, lgm_input: torch.Tensor) -> torch.Tensor:
        """The LGM's Gaussians [1, N, 14] of an input [1, k, 9, S, S]."""
        return self.m["lgm"](lgm_input.float())

    @torch.no_grad()
    def render_encode(self, gaussians: torch.Tensor):
        """The refine's last stage: every view of the Gaussians [1, N, 14]
        rendered over the 0.5 background and encoded to x0 latents
        [1, 4, F, h, w]; and the pairs each view demanded."""
        g = gaussians[0].float()
        cap = render.capacity(g.shape[0], self.out_size)
        views, demanded = render.render(g, self.cam_view[0], self.cam_view_proj[0],
                                        self.out_size, self.fovy, 0.5, cap)
        if self.out_size != self.in_size:
            views = F.interpolate(views, size=(self.in_size, self.in_size), mode="nearest-exact")
        z = self.scale_factor * self.m["vae"].encode_mode((views - 0.5) / 0.5).float()
        return z.permute(1, 0, 2, 3)[None], demanded

    def refine(self, xt: torch.Tensor, i: int, steps: int, c: Dict[str, torch.Tensor]):
        """The whole refine from x_t: x0 latents [1, 4, F, h, w] and the
        pairs each view demanded."""
        return self.render_encode(self.gaussians(self.lgm_input(xt, i, steps, c)))

    @torch.no_grad()
    def frames_of(self, latents: torch.Tensor, chunk: int = 8) -> torch.Tensor:
        """Final latents [1, 4, F, h, w] → uint8 views [F, H, W, 3]."""
        z = latents[0].permute(1, 0, 2, 3).float() / self.scale_factor
        out = []
        for s in range(0, z.shape[0], chunk):
            img = (self.m["vae"].decode(z[s:s + chunk]) * 0.5 + 0.5).clamp(0.0, 1.0)
            out.append(torch.round(img * 255.0).to(torch.uint8).permute(0, 2, 3, 1))
        return torch.cat(out)
