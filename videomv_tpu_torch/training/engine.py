"""Training engine of the port on one device: the plain and joint-LAION
UNet finetune, and the LGM-refine finetune.

Port of ``videomv_tpu/training/engine.py::T2VTrainer``. One explicit
``device``, no mesh:

  JAX engine                          → here
  jitted step over a device mesh      → eager step on ``device``
  fp32 params, bf16 module dtype      → fp32 trained masters under bf16
                                        autocast; frozen towers stored bf16
  optax AdamW / Adafactor chains      → ``training.optim``, the same updates
  orbax checkpoints                   → ``torch.save`` of the train state
  ``jax.random`` keys per step        → one ``torch.Generator`` for every draw

Plain finetune (``UNet.use_lgm_refine False``, configs/t2v_train.yaml): the
UNet trains with the eps-prediction loss (``parallel.train_step``), its
classifier-free drop swapping a row's text for the negative prompt's
embedding; the VAE and the text tower are frozen. With ``image_every`` and a
LAION ``img_dataset`` (configs/t2v_train_laion.yaml) every
``image_every``-th step is an image step at f = 1. ``viz_interval`` samples
the validation prompts with the live (or EMA) UNet.

LGM-refine finetune (``use_lgm_refine True``; reference
train_i2v_enterance.py:154-165): every tower except the LGM is frozen and
the LGM is trained through re-rendered-view supervision
(``training.lgm_refine``); the splat cameras are derived on the device from
the 16-float camera conditioning (``gs_wire_cameras``) unless the dataset
brings its own.

Both run the frozen VAE encode and the text encode on the device before the
step, with the video crossing host → device as uint8 (``wire_uint8``).
``prng_impl`` (the JAX package's dropout-stream generator) is read and
ignored: the port's dropout draws from the step's generator. I2V training and ``param_sharding: fsdp`` are not ported and
raise; ``dp_devices`` > 1 runs the whole batch on the one device, which is
the JAX mesh's step, with a warning.
"""

from __future__ import annotations

import contextlib
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
from ..data.datasets import (
    GObjaverseVideoDataset,
    SyntheticMVDataset,
    batch_iterator,
    cycle_epochs,
    prefetch_host,
)
from ..data.laion import LaionImageDataset, expand_shard_spec
from ..data.tokenizer import tokenize
from ..diffusion import GaussianDiffusion
from ..inference.pipeline import T2VPipeline, unet_kwargs_from_cfg
from ..models import AutoencoderKL, CLIPTextTower, UNetSD_T2VBase
from ..models.lgm import LGM, LGMOptions
from ..models.lpips import LPIPS
from ..parallel import TrainState, build_train_step, make_t2v_apply
from .checkpoints import (
    init_weights,
    load_matched,
    load_torch_checkpoint,
    rename_lgm_key,
    rename_lpips_key,
    rename_unet_key,
)
from .hooks import VisualTrainHook
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
            raise NotImplementedError(
                "I2V training is not ported yet: it is the I2V training slice of the port")
        if str(cfg.get("param_sharding", "replicated")) == "fsdp":
            raise NotImplementedError(
                "param_sharding: fsdp shards the state over several devices; it comes with "
                "slice E (multi-device) of the port")
        if cfg.get("dp_devices") and int(cfg.get("dp_devices")) > 1:
            # the JAX mesh's step over the whole batch is this device's step
            # (configs/lgm_refine_train_tiny.yaml sets 2): run, and say so
            logger.warning("dp_devices %s: the port runs the whole batch on %s; data "
                           "parallelism comes with slice E (multi-device)",
                           cfg.get("dp_devices"), device)
        if cfg.get("prng_impl"):
            logger.info("prng_impl %s ignored: the port's dropout draws from the step's "
                        "generator", cfg.get("prng_impl"))
        self.use_lgm_refine = bool(cfg.get("UNet", {}).get("use_lgm_refine", False))
        self.max_frames = int(cfg.get("frame_lens", [24])[0])
        self.resolution = list(cfg.get("resolution", [256, 256]))
        self.scale_factor = float(cfg.get("scale_factor", 0.18215))
        with torch.device("meta"):
            self.unet = UNetSD_T2VBase(**unet_kwargs_from_cfg(cfg.get("UNet", {})))
            self.vae = AutoencoderKL()
            self.clip = CLIPTextTower()
        self.lgm_state: Optional[LGMTrainState] = None
        self.state: Optional[TrainState] = None
        self.lgm = None
        self.zero_y: Optional[torch.Tensor] = None
        self.resume_step = 0

    # ------------------------------------------------------------- setup

    def init(self, zero_init: bool = True):
        """Materialise every model on the device from numpy seeds, load the
        checkpoints whose config paths exist, then build the trained state
        and the step: the UNet's, or with ``use_lgm_refine`` the LGM's.
        ``zero_init=False`` gives the zero-initialised layers seeded weights
        too (for smoke runs without checkpoints: with the zero output conv
        every upstream gradient of the UNet is 0)."""
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
        if self.use_lgm_refine:
            self._init_lgm_refine(cfg, zero_init)
        else:
            self._init_unet_finetune(cfg)
        return self

    def _frozen_dtype(self) -> torch.dtype:
        """Frozen towers take no gradient and every compute path runs in the
        module dtype, so bf16 storage under bf16 compute is the same numbers
        at half the memory; ``frozen_dtype: float32`` opts out."""
        bf16 = self.dtype == torch.bfloat16
        fd = str(self.cfg.get("frozen_dtype", "bfloat16" if bf16 else "float32")).lower()
        return torch.bfloat16 if fd in ("bfloat16", "bf16") and bf16 else torch.float32

    def _init_unet_finetune(self, cfg: AttrDict):
        """The UNet trains in fp32 (every parameter, as in the reference);
        the VAE and the text tower are frozen. Builds the optimizer (the SD
        keys' gradient scale from ``Pretrain``; ``fix_weight`` is a scale of
        0, as in JAX), the EMA copy, the negative prompt's embedding for the
        dropped rows, and the step."""
        frozen = self._frozen_dtype()
        for m in (self.vae, self.clip):
            m.to(frozen).eval().requires_grad_(False)
        self.unet.float().train().requires_grad_(True)
        pre = cfg.get("Pretrain", {})
        optimizer = build_optimizer(
            self.unet.named_parameters(),
            lr=float(cfg.get("lr", 3e-5)),
            weight_decay=float(cfg.get("weight_decay", 0.0)),
            warmup_steps=int(cfg.get("warmup_steps", 10)),
            total_steps=int(cfg.get("num_steps", 1_000_000)),
            decay_mode=str(cfg.get("decay_mode", "cosine")),
            grad_scale=0.0 if pre.get("fix_weight") else pre.get("grad_scale"),
            sd_keys_path=pre.get("sd_keys_path"),
            optimizer=str(cfg.get("optimizer", "adamw")))
        use_ema = bool(cfg.get("use_ema", False))
        ema = [p.detach().clone() for p in self.unet.parameters()] if use_ema else None
        self.state = TrainState(step=self.resume_step, unet=self.unet, optimizer=optimizer,
                                ema=ema)
        toks = torch.as_tensor(tokenize([str(cfg.get("negative_prompt", ""))]), dtype=torch.long,
                               device=self.device)
        with torch.no_grad():
            self.zero_y = self.clip(toks)[1]
        self.train_step = build_train_step(
            make_t2v_apply(self.unet), self.diffusion,
            ema_decay=float(cfg.get("ema_decay", 0.9999)), use_ema=use_ema,
            p_zero=float(cfg.get("p_zero", 0.1)), zero_y=self.zero_y,
            autocast_dtype=torch.bfloat16 if self.dtype == torch.bfloat16 else None)

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

        # The frozen UNet stays in training mode: its dropout acts, as in
        # the JAX step (deterministic=False), which also keeps its FFN on the
        # plain path. LPIPS computes in fp32, as the JAX module does.
        frozen_dtype = self._frozen_dtype()
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
        """G-Objaverse renders when a ``vid_dataset.data_list`` exists and
        lists objects, else the procedural ``SyntheticMVDataset``."""
        vd = self.cfg.get("vid_dataset", {})
        if any(os.path.exists(p) for p in vd.get("data_list", [])):
            extra = {}
            if self.lgm is not None:
                # one geometry: the dataset's ground truth and the device's
                # camera derivation both read LGMOptions
                o = self.lgm.opt
                extra["gs_settings"] = GSCameraSettings(
                    fovy=float(o.fovy), znear=float(o.znear), zfar=float(o.zfar),
                    input_size=int(o.input_size), output_size=int(o.output_size))
            ds = GObjaverseVideoDataset(
                data_list=vd.get("data_list", []), data_dir_list=vd.get("data_dir_list", []),
                caption_dir=vd.get("caption_dir"),
                resolution=tuple(vd.get("resolution", self.resolution)),
                max_frames=self.max_frames, prepare_lgm=bool(vd.get("prepare_lgm", False)),
                # the host camera chain is dead weight when the device derives it
                prepare_gs_cameras=not bool(self.cfg.get("gs_wire_cameras", True)), **extra)
            if len(ds.items) > 0:
                return ds
        logger.warning("no dataset assets found; using SyntheticMVDataset")
        return SyntheticMVDataset(resolution=tuple(self.resolution), max_frames=self.max_frames)

    def make_image_dataset(self):
        """The LAION image stream of joint training (``img_dataset.type:
        LAIONImageDataset``): items at f = 1 from the tar shards its
        ``shards`` specs match, or None when there are none."""
        idc = self.cfg.get("img_dataset", {})
        if idc.get("type") != "LAIONImageDataset":
            return None
        shards = []
        for spec in idc.get("shards", []):
            found = expand_shard_spec(spec)
            if not found:
                logger.warning("img_dataset shard spec %r matched no files", spec)
            shards.extend(found)
        if not shards:
            return None
        return LaionImageDataset(shards=shards,
                                 resolution=tuple(idc.get("resolution", self.resolution)),
                                 max_frames=1)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """Host array → device tensor."""
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    @torch.no_grad()
    def encode_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch → device features: the frozen VAE encode of every
        frame and the CLIP text sequence. The video crosses host→device as
        uint8 (4× fewer bytes; sources are 8-bit images) and is normalised
        back to [-1, 1] on the device; ``wire_uint8: false`` keeps fp32."""
        video = np.asarray(batch["video"])
        if bool(self.cfg.get("wire_uint8", True)) and video.dtype != np.uint8:
            video = np.clip((video + 1.0) * 127.5 + 0.5, 0.0, 255.0).astype(np.uint8)
        video = self._to_device(video)
        if video.dtype == torch.uint8:
            video = video.float() / 127.5 - 1.0
        b, f, c, hh, ww = video.shape
        z = self.vae.encode_first_stage(video.reshape(b * f, c, hh, ww), self.scale_factor)
        z = z.float().reshape(b, f, 4, *z.shape[-2:]).permute(0, 2, 1, 3, 4).contiguous()
        toks = self._to_device(np.asarray(tokenize(list(batch["caption"])), np.int64))
        out = {"latents": z, "y_words": self.clip(toks)[1]}
        if "camera_data" in batch:
            out["camera_data"] = self._to_device(np.asarray(batch["camera_data"]))
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
        geometry, or takes them from the dataset's own ``gs_data`` block,
        whose full-size views and masks are the supervision."""
        opts = self.lgm.opt
        wire_u8 = bool(self.cfg.get("wire_uint8", True))
        dev_cams = bool(self.cfg.get("gs_wire_cameras", True)) and "camera_data" in host_batch
        host_cams = None
        if "gs_data" in host_batch:
            gs = host_batch["gs_data"]
            imgs, masks = np.asarray(gs["images_output"]), np.asarray(gs["masks_output"])
            if not dev_cams and "input" in gs:
                host_cams = (gs["input"], gs["cam_view"], gs["cam_view_proj"])
        else:
            imgs = np.asarray(host_batch["video"]) * 0.5 + 0.5
            masks = np.asarray(host_batch.get("mask", np.ones_like(imgs[:, :, :1])))
        if not dev_cams and host_cams is None:
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
        imgs, masks = self._to_device(imgs), self._to_device(masks)
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
                out[key] = self._to_device(np.asarray(arr, np.float32))
        return out

    # -------------------------------------------------------------- loop

    def train(self, num_steps: Optional[int] = None, batch_size: Optional[int] = None) -> float:
        """``num_steps`` steps (default ``num_steps`` of the config) at
        ``batch_size`` (default ``batch_sizes[frame_lens[0]]``); returns the
        last step's loss."""
        cfg = self.cfg
        num_steps = num_steps or int(cfg.get("num_steps", 1000))
        bs = batch_size or int(cfg.get("batch_sizes", {}).get(str(self.max_frames), 1))
        # background-thread host pipeline: batch collation overlaps the step
        batches = prefetch_host(batch_iterator(self.make_dataset(), bs))
        # joint LAION training: every image_every-th step is an image step
        image_every = int(cfg.get("image_every", 0))
        image_batches = None
        if image_every:
            img_ds = self.make_image_dataset()
            if img_ds is not None:
                img_bs = int(cfg.get("batch_sizes", {}).get("1", bs))
                # the shards are finite: cycle epochs, reshuffled each time
                image_batches = batch_iterator(cycle_epochs(img_ds), img_bs)
            else:
                logger.warning("image_every set but no LAION shards found")
        log_dir = cfg.get("log_dir", "workspace/experiment")
        os.makedirs(log_dir, exist_ok=True)
        viz_interval = int(cfg.get("viz_interval", 0))
        viz_hook = (self.make_viz_hook(log_dir)
                    if viz_interval and not self.use_lgm_refine else None)
        try:
            return self._train_loop(num_steps, batches, image_batches, image_every, viz_hook,
                                    log_dir)
        finally:
            # stop, drain and join the prefetch worker: no thread outlives
            # the trainer's loop
            batches.close()

    def _train_loop(self, num_steps: int, batches, image_batches, image_every: int, viz_hook,
                    log_dir: str) -> float:
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(int(cfg.get("seed", 0)) + 1)
        log_interval = int(cfg.get("log_interval", 1))
        save_interval = int(cfg.get("save_ckp_interval", 500))
        viz_interval = int(cfg.get("viz_interval", 0))
        step0 = self.lgm_state.step if self.use_lgm_refine else self.state.step
        t_start = time.time()
        losses = []
        for i in range(num_steps):
            use_image = image_batches is not None and i % image_every == image_every - 1
            host_batch = next(image_batches if use_image else batches)
            feats = self.encode_batch(host_batch)
            if self.use_lgm_refine:
                feats.update(self._gs_features(host_batch))
                loss, aux = self.refine_step(self.lgm_state, feats, generator=gen)
            else:
                loss = self.train_step(self.state, feats, generator=gen)
            losses.append(loss)
            step = step0 + i + 1
            if step % log_interval == 0:
                # the only device→host reads of the loop
                lv = float(torch.stack(losses[-log_interval:]).mean())
                if self.use_lgm_refine:
                    logger.info("refine psnr %.2f lpips %.4f", float(aux["psnr"]),
                                float(aux["loss_lpips"]))
                logger.info("step %d loss %.4f (%.2f it/s)%s", step, lv,
                            (i + 1) / (time.time() - t_start), " image" if use_image else "")
            if viz_hook is not None and viz_interval and step % viz_interval == 0:
                with self._ema_weights():
                    viz_hook(step, self.unet)
            if save_interval and step % save_interval == 0 and step > 0:
                self.save(os.path.join(log_dir, "checkpoints"))
        return float(losses[-1])

    @contextlib.contextmanager
    def _ema_weights(self):
        """Within ``with``, the UNet's parameters hold the EMA weights (when
        EMA is on); the trained ones are swapped back on exit."""
        ema = self.state.ema if self.state is not None else None
        if ema is None:
            yield
            return
        params = list(self.unet.parameters())

        def swap():
            for i, p in enumerate(params):
                p.data, ema[i] = ema[i], p.data

        swap()
        try:
            yield
        finally:
            swap()

    def make_viz_hook(self, log_dir: str) -> Optional[VisualTrainHook]:
        """In-training DDIM visualisation (reference visual_train hook,
        train_t2v_enterance.py:326-388) of the prompts in
        ``validation_prompts`` (default data/validation_prompts.txt), through
        a ``T2VPipeline`` that holds the trainer's VAE and text tower and is
        handed the live UNet at each call. None without a prompt file."""
        prompts_path = self.cfg.get("validation_prompts", "data/validation_prompts.txt")
        if not os.path.exists(prompts_path):
            logger.warning("viz hook unavailable: no prompt file %s", prompts_path)
            return None
        with open(prompts_path) as f:
            prompts = [line.strip() for line in f if line.strip()]

        def factory():
            pipe = T2VPipeline(self.cfg, self.device)
            pipe.vae, pipe.clip = self.vae, self.clip
            return pipe

        return VisualTrainHook(
            factory, prompts, os.path.join(log_dir, "viz"),
            guide_scale=float(self.cfg.get("visual_train", {}).get("guide_scale", 9.0)),
            steps=int(self.cfg.get("ddim_timesteps", 50)),
            autocast_dtype=torch.bfloat16 if self.dtype == torch.bfloat16 else None)

    # ------------------------------------------------------------- ckpt

    def save(self, ckpt_dir: str) -> str:
        """``torch.save`` of the train state as ``step_XXXXXXXX.pth``: the
        trained parameters, the optimizer's moments and count, the EMA
        weights (UNet finetune) and the step."""
        if self.use_lgm_refine:
            step = int(self.lgm_state.step)
            payload = {"lgm_params": self.lgm.state_dict(),
                       "opt_state": self.lgm_state.optimizer.state_dict(), "step": step}
        else:
            step = int(self.state.step)
            payload = {"params": self.unet.state_dict(), "ema": self.state.ema or [],
                       "opt_state": self.state.optimizer.state_dict(), "step": step}
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}.pth"))
        torch.save(payload, path)
        logger.info("saved checkpoint %s", path)
        return path

    def restore(self, path: str):
        """Resume the full train state, optimizer moments included."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        if self.use_lgm_refine:
            self.lgm.load_state_dict(state["lgm_params"], strict=True)
            self.lgm_state.optimizer.load_state_dict(state["opt_state"])
            self.lgm_state.step = int(state["step"])
            return self
        self.unet.load_state_dict(state["params"], strict=True)
        self.state.optimizer.load_state_dict(state["opt_state"])
        if self.state.ema is not None:
            if len(state["ema"]) != len(self.state.ema):
                raise ValueError(f"{path} holds no EMA weights for this UNet")
            with torch.no_grad():
                torch._foreach_copy_(self.state.ema, list(state["ema"]))
        self.state.step = int(state["step"])
        return self
