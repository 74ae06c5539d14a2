"""Training engine of the port: the LGM-refine finetune on one device.

Port of the refine branch of ``videomv_tpu/training/engine.py::T2VTrainer``
(``cfg.UNet.use_lgm_refine``; reference train_i2v_enterance.py:154-165):
every tower except the LGM is frozen, and the LGM is trained through
re-rendered-view supervision (``training.lgm_refine``). One explicit
``device``, no mesh:

  JAX engine                          → here
  jitted step over a device mesh      → eager step on ``device``
  fp32 params, bf16 module dtype      → fp32 LGM masters under bf16 autocast;
                                        frozen UNet / VAE / CLIP stored bf16
  optax AdamW (bf16 first moment)     → ``training.optim.AdamW``, the same update
  orbax checkpoints                   → ``torch.save`` of the LGM state
  ``jax.random`` keys per step        → one ``torch.Generator`` for every draw

The frozen VAE encode and CLIP text encode run on the device before the
step. The video and the supervision views cross the host→device wire as
uint8 (``wire_uint8``), and the splat cameras are derived on the device
from the 16-float camera conditioning (``gs_wire_cameras``), as in the JAX
engine. The plain and joint-LAION UNet finetune (``use_lgm_refine False``),
EMA, the visualisation hooks and the G-Objaverse dataset are not ported yet.
"""

from __future__ import annotations

import logging
import os
import re
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AttrDict
from ..data.cameras import GSCameraSettings, prepare_gs_training
from ..data.datasets import SyntheticMVDataset, batch_iterator, prefetch_host
from ..data.tokenizer import tokenize
from ..diffusion import GaussianDiffusion
from ..inference.pipeline import unet_kwargs_from_cfg
from ..models import AutoencoderKL, CLIPTextTower, UNetSD_T2VBase
from ..models.lgm import LGM, LGMOptions
from ..models.lpips import LPIPS
from .checkpoints import (
    init_weights,
    load_matched,
    load_torch_checkpoint,
    rename_lgm_key,
    rename_lpips_key,
    rename_unet_key,
)
from .lgm_refine import LGMTrainState, build_lgm_refine_step
from .optim import build_optimizer

__all__ = ["T2VTrainer"]

logger = logging.getLogger(__name__)

# seeds of the numpy initialisation, by model
_INIT_SEEDS = {"unet": 0, "vae": 1, "clip": 2, "lgm": 7, "lpips": 8}


class T2VTrainer:
    """Builds every tower on ``device`` and drives the training loop."""

    def __init__(self, cfg: AttrDict, device, dtype: Optional[torch.dtype] = None):
        self.cfg = cfg
        self.device = torch.device(device)
        if dtype is None:
            td = str(cfg.get("training_dtype", "bfloat16")).lower()
            dtype = torch.float32 if td in ("float32", "fp32", "f32") else torch.bfloat16
        self.dtype = dtype
        d = dict(cfg.get("Diffusion", {}))
        d.pop("type", None)
        d.pop("ddim_timesteps", None)
        self.diffusion = GaussianDiffusion(**d)
        if (cfg.get("TASK_TYPE", "") == "train_i2v_entrance"
                or cfg.get("UNet", {}).get("type") == "UNetSD_I2VGen"):
            raise NotImplementedError("I2V training is not ported yet (it comes with I2V)")
        self.use_lgm_refine = bool(cfg.get("UNet", {}).get("use_lgm_refine", False))
        if not self.use_lgm_refine:
            raise NotImplementedError(
                "only the LGM-refine finetune (UNet.use_lgm_refine True) is ported; the plain "
                "and joint-LAION UNet finetune is slice D2 of the port")
        self.max_frames = int(cfg.get("frame_lens", [24])[0])
        self.resolution = list(cfg.get("resolution", [256, 256]))
        self.scale_factor = float(cfg.get("scale_factor", 0.18215))
        with torch.device("meta"):
            self.unet = UNetSD_T2VBase(**unet_kwargs_from_cfg(cfg.get("UNet", {})))
            self.vae = AutoencoderKL()
            self.clip = CLIPTextTower()
        self.lgm_state: Optional[LGMTrainState] = None
        self.resume_step = 0

    # ------------------------------------------------------------- setup

    def init(self, zero_init: bool = True):
        """Materialise every model on the device from numpy seeds, load the
        checkpoints whose config paths exist, freeze all but the LGM and
        build the refine step. ``zero_init=False`` gives the zero-initialised
        layers seeded weights too (for smoke runs without checkpoints)."""
        cfg = self.cfg
        for name in ("unet", "vae", "clip"):
            init_weights(getattr(self, name), _INIT_SEEDS[name], zero_init=zero_init,
                         device=self.device)
        ckpt = cfg.get("Pretrain", {}).get("resume_checkpoint")
        if ckpt and os.path.exists(ckpt):  # tolerant pretrain load
            report = load_matched(self.unet, load_torch_checkpoint(ckpt), rename_unet_key)
            logger.info("pretrain load %s: %d matched / %d missing / %d unexpected", ckpt,
                        len(report["matched"]), len(report["missing"]),
                        len(report["unexpected"]))
            m = re.search(r"(\d+)\.pth", os.path.basename(ckpt))
            if m:
                self.resume_step = int(m.group(1))
        self._init_lgm_refine(cfg, zero_init)
        return self

    def _init_lgm_refine(self, cfg: AttrDict, zero_init: bool):
        """The LGM is the only optimised module; UNet, VAE, CLIP and LPIPS
        ride along frozen."""
        preset = cfg.get("lgm_opts", "big")
        if isinstance(preset, str):
            opts = getattr(LGMOptions, preset)()
        else:  # a dict of LGMOptions fields (tiny test configs)
            opts = LGMOptions(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in dict(preset).items()})
        # memory levers of the 512² refine finetune: per-block LGM
        # rematerialisation and chunked supervision rendering, on by default
        # from output_size 512 up
        big_render = int(opts.output_size) >= 512
        lgm_remat = bool(cfg.get("lgm_use_checkpoint", big_render))
        view_chunk = int(cfg.get("refine_view_chunk", 2 if big_render else 0))
        with torch.device("meta"):
            self.lgm = LGM(opts, use_checkpoint=lgm_remat)
            self.lpips = LPIPS()
        init_weights(self.lgm, _INIT_SEEDS["lgm"], zero_init=zero_init, device=self.device)
        init_weights(self.lpips, _INIT_SEEDS["lpips"], zero_init=zero_init, device=self.device)
        lp = cfg.get("lgm_pretrain")
        if lp and os.path.exists(lp):
            rep = load_matched(self.lgm, load_torch_checkpoint(lp), rename_lgm_key)
            logger.info("lgm pretrain %s: %d matched / %d missing", lp, len(rep["matched"]),
                        len(rep["missing"]))
        lpp = cfg.get("lpips_pretrain")
        if lpp and os.path.exists(lpp):
            load_matched(self.lpips, load_torch_checkpoint(lpp), rename_lpips_key)

        # Frozen towers take no gradient and every compute path runs in the
        # module dtype, so bf16 storage under bf16 compute is the same
        # numbers at half the memory; ``frozen_dtype: float32`` opts out.
        # The UNet stays in training mode: its dropout acts, as in the JAX
        # step (deterministic=False), which also keeps its FFN on the plain
        # path. LPIPS computes in fp32, as the JAX module does.
        fd = str(cfg.get("frozen_dtype", "bfloat16" if self.dtype == torch.bfloat16
                         else "float32")).lower()
        frozen_dtype = (torch.bfloat16 if fd in ("bfloat16", "bf16")
                        and self.dtype == torch.bfloat16 else torch.float32)
        for m in (self.unet, self.vae, self.clip):
            m.to(frozen_dtype).requires_grad_(False)
        self.unet.train()
        self.vae.eval()
        self.clip.eval()
        self.lpips.float().eval().requires_grad_(False)
        self.lgm.float().train().requires_grad_(True)

        optimizer = build_optimizer(
            self.lgm.parameters(),
            lr=float(cfg.get("lr", 3e-5)),
            weight_decay=float(cfg.get("weight_decay", 0.0)),
            warmup_steps=int(cfg.get("warmup_steps", 10)),
            total_steps=int(cfg.get("num_steps", 1_000_000)),
            decay_mode=str(cfg.get("decay_mode", "cosine")),
            optimizer=str(cfg.get("optimizer", "adamw")))
        self.lgm_state = LGMTrainState(step=self.resume_step, lgm=self.lgm, optimizer=optimizer)
        self._step_kwargs = dict(
            scale_factor=self.scale_factor,
            n_input_views=int(opts.num_input_views),
            n_supervise_extra=max(int(opts.num_views) - int(opts.num_input_views), 0),
            render_size=int(opts.output_size), fovy_deg=float(opts.fovy),
            ray_size=int(opts.input_size), znear=float(opts.znear), zfar=float(opts.zfar),
            splat_backend=str(cfg.get("splat_backend", "auto")), lpips=self.lpips,
            lambda_lpips=float(cfg.get("lambda_lpips", opts.lambda_lpips)),
            view_chunk=view_chunk,
            autocast_dtype=torch.bfloat16 if self.dtype == torch.bfloat16 else None)
        self.refine_step = build_lgm_refine_step(self.unet, self.vae, self.lgm, self.diffusion,
                                                 **self._step_kwargs)

    # -------------------------------------------------------------- data

    def make_dataset(self):
        vd = self.cfg.get("vid_dataset", {})
        if any(os.path.exists(p) for p in vd.get("data_list", [])):
            raise NotImplementedError(
                "the G-Objaverse dataset is not ported yet (it comes with the UNet finetune); "
                "remove vid_dataset.data_list to train on SyntheticMVDataset")
        logger.warning("no dataset assets found; using SyntheticMVDataset")
        return SyntheticMVDataset(resolution=tuple(self.resolution), max_frames=self.max_frames)

    @torch.no_grad()
    def encode_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch → device features: the frozen VAE encode of every
        frame and the CLIP text sequence. The video crosses host→device as
        uint8 (4× fewer bytes; sources are 8-bit images) and is normalised
        back to [-1, 1] on the device; ``wire_uint8: false`` keeps fp32."""
        video = np.asarray(batch["video"])
        if bool(self.cfg.get("wire_uint8", True)) and video.dtype != np.uint8:
            video = np.clip((video + 1.0) * 127.5 + 0.5, 0.0, 255.0).astype(np.uint8)
        video = torch.from_numpy(video).to(self.device)
        if video.dtype == torch.uint8:
            video = video.float() / 127.5 - 1.0
        b, f, c, hh, ww = video.shape
        z = self.vae.encode_first_stage(video.reshape(b * f, c, hh, ww), self.scale_factor)
        z = z.float().reshape(b, f, 4, *z.shape[-2:]).permute(0, 2, 1, 3, 4).contiguous()
        toks = torch.as_tensor(tokenize(list(batch["caption"])), dtype=torch.long,
                               device=self.device)
        out = {"latents": z, "y_words": self.clip(toks)[1]}
        if "camera_data" in batch:
            out["camera_data"] = torch.from_numpy(np.asarray(batch["camera_data"])).to(self.device)
        return out

    @torch.no_grad()
    def _gs_features(self, host_batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The supervision block of the refine step.

        Default wire (``gs_wire_cameras: true``): only the ground-truth views
        and masks cross host→device, as uint8 when ``wire_uint8`` is on (the
        frames are float after the dataset's resize and compositing, so this
        quantises by at most 1/510 per pixel; ``wire_uint8: false`` is the
        exact fp32 wire), and the step derives rays and colmap matrices on
        the device from ``camera_data``. ``gs_wire_cameras: false`` prepares
        the cameras on the host, from ``camera_data`` with the same LGMOptions
        geometry. (A dataset's own ``gs_data`` block comes with the
        G-Objaverse dataset.)"""
        opts = self.lgm.opt
        wire_u8 = bool(self.cfg.get("wire_uint8", True))
        dev_cams = bool(self.cfg.get("gs_wire_cameras", True)) and "camera_data" in host_batch
        host_cams = None
        imgs = np.asarray(host_batch["video"]) * 0.5 + 0.5
        masks = np.asarray(host_batch.get("mask", np.ones_like(imgs[:, :, :1])))
        if not dev_cams:
            st = GSCameraSettings(input_size=opts.input_size, output_size=opts.output_size,
                                  fovy=opts.fovy, znear=opts.znear, zfar=opts.zfar)
            cams = np.asarray(host_batch["camera_data"])
            # canonicalisation is per sample (pose 0 of each)
            per = [prepare_gs_training(cams[i][None], st, ray_size=opts.input_size)
                   for i in range(cams.shape[0])]
            host_cams = tuple(np.concatenate([g[k] for g in per])
                              for k in ("input_rays", "cam_view", "cam_view_proj"))
        if wire_u8 and imgs.dtype != np.uint8:
            imgs = np.clip(imgs * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
            masks = np.clip(masks * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
        imgs = torch.from_numpy(imgs).to(self.device)
        masks = torch.from_numpy(masks).to(self.device)
        r = int(opts.output_size)
        if imgs.shape[-1] != r:
            if imgs.dtype == torch.uint8:  # resize in float; the wire stays uint8
                imgs, masks = imgs.float() / 255.0, masks.float() / 255.0
            b, f = imgs.shape[:2]
            # jax.image.resize's bilinear: antialiased when it shrinks
            kw = dict(size=(r, r), mode="bilinear", antialias=True, align_corners=False)
            imgs = F.interpolate(imgs.flatten(0, 1), **kw).reshape(b, f, 3, r, r)
            masks = F.interpolate(masks.flatten(0, 1), **kw).reshape(b, f, 1, r, r)
        out = {"images_gt": imgs, "masks_gt": masks}
        if host_cams is not None:
            for key, arr in zip(("gs_rays", "cam_view", "cam_view_proj"), host_cams):
                out[key] = torch.from_numpy(np.asarray(arr, np.float32)).to(self.device)
        return out

    # -------------------------------------------------------------- loop

    def train(self, num_steps: Optional[int] = None, batch_size: Optional[int] = None) -> float:
        cfg = self.cfg
        num_steps = num_steps or int(cfg.get("num_steps", 1000))
        bs = batch_size or int(cfg.get("batch_sizes", {}).get(str(self.max_frames), 1))
        # background-thread host pipeline: batch collation overlaps the step
        batches = prefetch_host(batch_iterator(self.make_dataset(), bs))
        log_dir = cfg.get("log_dir", "workspace/experiment")
        os.makedirs(log_dir, exist_ok=True)
        try:
            return self._train_loop(num_steps, batches, log_dir)
        finally:
            # stop, drain and join the prefetch worker: no thread outlives
            # the trainer's loop
            batches.close()

    def _train_loop(self, num_steps: int, batches, log_dir: str) -> float:
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(cfg.get("seed", 0)) + 1)
        log_interval = int(cfg.get("log_interval", 1))
        save_interval = int(cfg.get("save_ckp_interval", 500))
        t_start = time.time()
        losses = []
        for i in range(num_steps):
            host_batch = next(batches)
            feats = self.encode_batch(host_batch)
            feats.update(self._gs_features(host_batch))
            loss, aux = self.refine_step(self.lgm_state, feats, generator=gen)
            losses.append(loss)
            step = self.lgm_state.step
            if step % log_interval == 0:
                # the only device→host reads of the loop
                lv = float(torch.stack(losses[-log_interval:]).mean())
                logger.info("refine psnr %.2f lpips %.4f", float(aux["psnr"]),
                            float(aux["loss_lpips"]))
                logger.info("step %d loss %.4f (%.2f it/s)", step, lv,
                            (i + 1) / (time.time() - t_start))
            if save_interval and step % save_interval == 0 and step > 0:
                self.save(os.path.join(log_dir, "checkpoints"))
        return float(losses[-1])

    # ------------------------------------------------------------- ckpt

    def save(self, ckpt_dir: str) -> str:
        """``torch.save`` of the LGM train state (parameters, both optimizer
        moments, the step) as ``step_XXXXXXXX.pth``."""
        step = int(self.lgm_state.step)
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}.pth"))
        torch.save({"lgm_params": self.lgm.state_dict(),
                    "opt_state": self.lgm_state.optimizer.state_dict(), "step": step}, path)
        logger.info("saved checkpoint %s", path)
        return path

    def restore(self, path: str):
        """Resume the full LGM train state, optimizer moments included."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.lgm.load_state_dict(state["lgm_params"], strict=True)
        self.lgm_state.optimizer.load_state_dict(state["opt_state"])
        self.lgm_state.step = int(state["step"])
        return self
