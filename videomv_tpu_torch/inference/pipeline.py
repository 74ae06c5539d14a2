"""Text→multiview inference pipeline on PyTorch.

Port of ``videomv_tpu/inference/pipeline.py::T2VPipeline``: CLIP text tower
→ DDIM with classifier-free guidance over ``UNetSD_T2VBase`` (cond and
uncond rows in one batched forward), optionally with the Gaussian-splat
refine at DDIM steps {20, 30, 40} (LGM reconstruction, splat re-render, VAE
re-encode; ``inference/refine.py``) → VAE decode to uint8 views, on one
explicit ``device`` per process. ``export_ply`` writes the LGM's Gaussians
of a generated orbit.

Several processes (``torch.distributed``, one device each) serve in three
ways, as the JAX pipeline does over a mesh:

- ``generate(frame_parallel=True)``: one sample's frames over an ``('sp',)``
  mesh (``parallel.infer``), or with ``serving_tp`` > 1 in the config over
  an ``('sp', 'tp')`` mesh whose tp ranks split the attention heads
  (``parallel.tp``). Each rank samples and decodes its frames; the frames
  are all-gathered, and ranks outside the mesh receive them from rank 0;
- ``generate_batch(data_parallel=True)``: the prompts padded to a multiple
  of the world (the last one repeated), each rank samples its rows batched,
  and the rows are all-gathered;
- ``generate_batch(force_batched=True)``: one batched program over all the
  prompts on each rank (on one process, without either flag, it loops
  ``generate``).

Every rank holds the same weights: the seeded init and the checkpoints are
read alike on each.

Behaviour kept from the JAX pipeline: the ", 3d asset" prompt suffix, the
cached negative-prompt encoding as ``zero_y``, the ``[cond; uncond]`` CFG
rows, decoding ``z / scale_factor`` → ``clip(0.5x + 0.5)`` → round to uint8
on the device, bf16 compute by default with ``sampling_dtype: float32`` as
the escape hatch (bf16 is what reaches the CUDA kernels). ``generate(seed=s)``
is deterministic (noise from a ``torch.Generator`` seeded with ``s``) but is
not the JAX package's sample for ``s``: the two generators differ.

A request (``generate``) is traced through ``utils.profiling``: the root span
``pipeline.request``, the encodes (``pipeline.encode.*``), the sampler's
steps, the decode (``pipeline.decode``) and the copies to the host
(``pipeline.to_host``).

The pipeline serves its UNet's forward from CUDA graphs (``unet.graphs``,
``models/graphed.py``): one a signature (the 48-row CFG forward, the refine's
cond rows), captured at the second call of each on one device and replayed
from then on; frame-parallel and tensor-parallel serving stay eager.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import AttrDict
from ..data.cameras import (
    GSCameraSettings,
    orbit_c2w_opengl,
    orbit_camera_for_t2v,
    prepare_gs_cameras,
    prepare_gs_training,
)
from ..data.tokenizer import tokenize
from ..diffusion import GaussianDiffusion, ddim_sample_loop
from ..models import AutoencoderKL, CLIPTextTower, UNetSD_T2VBase
from ..models.graphed import GraphedForward
from ..models.lgm import LGM, LGMOptions
from ..ops.ply_io import save_ply
from ..parallel.collectives import all_gather_cat, broadcast
from ..parallel.infer import (
    FrameShard,
    frame_parallel_mesh,
    frame_sharded,
    in_mesh,
    shard_on_axis,
)
from ..parallel.mesh import make_mesh, shard_batch, world_size
from ..parallel.tp import place_params_tp
from ..utils import profiling
from ..training.checkpoints import (
    init_models,
    load_matched,
    load_torch_checkpoint,
    rename_clip_key,
    rename_lgm_key,
    rename_unet_key,
    rename_vae_key,
)
from .refine import _VID_MEAN, _VID_STD, REFINE_VIEW_IDXS, make_refine_fn

__all__ = ["T2VPipeline", "unet_kwargs_from_cfg"]

logger = logging.getLogger(__name__)


def unet_kwargs_from_cfg(unet_cfg: dict) -> dict:
    """The YAML ``UNet`` block as module kwargs (as the JAX pipeline reads it)."""
    m = dict(unet_cfg)
    return dict(
        in_dim=m.get("in_dim", 4),
        dim=m.get("dim", 320),
        y_dim=m.get("y_dim", 1024),
        context_dim=m.get("context_dim", 1024),
        out_dim=m.get("out_dim", 4),
        dim_mult=tuple(m.get("dim_mult", (1, 2, 4, 4))),
        num_heads=m.get("num_heads", 8),
        head_dim=m.get("head_dim", 64),
        num_res_blocks=m.get("num_res_blocks", 2),
        attn_scales=tuple(m.get("attn_scales", (1.0, 0.5, 0.25))),
        dropout=m.get("dropout", 0.1),
        temporal_attention=m.get("temporal_attention", True),
        # the dormant variants through `temporal_block`, or the reference's
        # boolean mirror (use_temporal_transformer False: rotary)
        temporal_block=m.get(
            "temporal_block",
            "transformer" if m.get("use_temporal_transformer", True) else "rotary"),
        temporal_attn_times=m.get("temporal_attn_times", 1),
        use_sim_mask=m.get("use_sim_mask", False),
        use_fps_condition=m.get("use_fps_condition", False),
        use_camera_condition=m.get("use_camera_condition", True),
        use_checkpoint=m.get("use_checkpoint", False),
        remat_policy=m.get("remat_policy", "full"),
    )


class T2VPipeline:
    """Builds the models from a merged config and drives generation on
    ``device``."""

    _clip_rename = staticmethod(rename_clip_key)  # the text tower's keys of a CLIP file

    def __init__(self, cfg: AttrDict, device, seed: int = 0):
        self.cfg = cfg
        self.device = torch.device(device)
        self.seed = seed
        sd = str(cfg.get("sampling_dtype", "")).lower()
        self.dtype = torch.float32 if sd in ("float32", "fp32", "f32") else torch.bfloat16
        d = dict(cfg.get("Diffusion", {}))
        d.pop("type", None)
        d.pop("ddim_timesteps", None)
        self.diffusion = GaussianDiffusion(**d)

        self.max_frames = int(cfg.get("max_frames", 24))
        self.resolution = list(cfg.get("resolution", [256, 256]))
        self.scale = int(cfg.get("scale", 8))
        self.latent_hw = (self.resolution[1] // self.scale, self.resolution[0] // self.scale)
        self.scale_factor = float(cfg.get("scale_factor", 0.18215))
        self.use_lgm_refine = bool(cfg.get("UNet", {}).get("use_lgm_refine", False))

        # built without storage; init_params() materialises them on device
        with torch.device("meta"):
            self.unet = UNetSD_T2VBase(**unet_kwargs_from_cfg(cfg.get("UNet", {})))
            self.vae = AutoencoderKL()
            self.clip = CLIPTextTower()
            self.lgm = (LGM(getattr(LGMOptions, str(cfg.get("lgm_variant", "big")))())
                        if self.use_lgm_refine else None)
        # the refine renders at gs_render_size directly (the reference renders
        # 512² and downsamples to 256²)
        self.gs_settings = GSCameraSettings(
            input_size=int(cfg.get("gs_input_size",
                                   self.lgm.opt.input_size if self.lgm else 256)),
            output_size=int(cfg.get("gs_render_size", 256)))
        self._camera_cache: Dict[tuple, tuple] = {}
        self._negative_cache: Dict[str, torch.Tensor] = {}
        self._sp_mesh, self._sp_tried, self._dp_mesh = None, False, None
        self._tp_cut = False

    @property
    def models(self) -> Dict[str, torch.nn.Module]:
        models = {"unet": self.unet, "vae": self.vae, "clip": self.clip}
        if self.lgm is not None:
            models["lgm"] = self.lgm
        return models

    # ------------------------------------------------------------ params

    def init_params(self, load: bool = True):
        """Initialise every model on ``device`` from numpy seeds (zero-init
        layers zeroed, as in the JAX package), then load the released
        checkpoints whose config paths exist."""
        t0 = time.time()
        init_models([(m, self.seed + i) for i, m in enumerate(self.models.values())],
                    device=self.device)
        logger.info("param init took %.1fs", time.time() - t0)
        if load:
            self.load_weights()
        self._finalize()

    def load_state_dicts(self, **state_dicts: Dict[str, torch.Tensor]):
        """Load complete state dicts by model name (``unet=``, ``vae=``,
        ``clip=``, ``lgm=``; strict), e.g. from ``state_dict_from_flax``."""
        for name, sd in state_dicts.items():
            m = self.models[name]
            if any(p.device.type == "meta" for p in m.parameters()):
                m.to_empty(device=self.device)
            m.load_state_dict(sd, strict=True)
        self._finalize()

    def load_weights(self):
        """Load the released torch checkpoints whose config paths exist
        (tolerant, with the JAX pipeline's ``min_matched_fraction`` guard)."""
        cfg = self.cfg
        jobs = []
        if cfg.get("test_model") and os.path.exists(cfg.test_model):
            jobs.append(("unet", cfg.test_model, rename_unet_key))
            if self.lgm is not None:
                jobs.append(("lgm", cfg.test_model, rename_lgm_key))
        ae = cfg.get("auto_encoder", {})
        if ae.get("pretrained") and os.path.exists(ae.pretrained):
            jobs.append(("vae", ae.pretrained, rename_vae_key))
        emb = cfg.get("embedder", {})
        if emb.get("pretrained") and os.path.exists(emb.pretrained):
            jobs.append(("clip", emb.pretrained, self._clip_rename))
        lgm_path = cfg.get("lgm_pretrain")
        if lgm_path and os.path.exists(lgm_path) and self.lgm is not None:
            jobs.append(("lgm", lgm_path, rename_lgm_key))
        min_matched = float(cfg.get("min_matched_fraction", 0.9))
        for name, path, rename in jobs:
            report = load_matched(self.models[name], load_torch_checkpoint(path), rename)
            n_target = len(report["matched"]) + len(report["missing"])
            frac = len(report["matched"]) / max(n_target, 1)
            logger.info("loaded %s from %s: %d matched (%.0f%%), %d missing, %d unexpected",
                        name, path, len(report["matched"]), 100 * frac,
                        len(report["missing"]), len(report["unexpected"]))
            if frac < min_matched:
                raise ValueError(
                    f"checkpoint {path} matched only {frac:.1%} of the {name} state dict "
                    f"(threshold {min_matched:.0%}); first missing: {report['missing'][:5]}; "
                    f"first mismatched: {report['mismatched'][:3]}. Set "
                    "min_matched_fraction in the config to override.")
        self._negative_cache.clear()

    def _check_params_dtype(self):
        """``params_dtype`` (the JAX pipeline's storage switch): this
        pipeline stores every weight in the sampling dtype already, so
        ``bfloat16`` asks for what bf16 sampling does and is ignored, with a
        warning, under fp32 sampling; anything else raises."""
        pd = str(self.cfg.get("params_dtype", "")).lower()
        if pd in ("", "none", "float32", "fp32", "f32"):
            return
        if pd not in ("bfloat16", "bf16"):
            raise ValueError(f"params_dtype must be bfloat16 or float32, got {pd!r}")
        if self.dtype != torch.bfloat16:
            logger.warning("params_dtype bfloat16 ignored: sampling_dtype is fp32")

    def _finalize(self):
        self._check_params_dtype()
        for m in self.models.values():
            if any(p.device.type == "meta" for p in m.parameters()):
                continue  # not initialised or loaded (e.g. a test feeding y_words)
            m.to(device=self.device, dtype=self.dtype).eval().requires_grad_(False)
        # the served forward's CUDA graphs, none captured yet for these weights
        self.unet.graphs = GraphedForward()
        self._negative_cache.clear()

    # ---------------------------------------------------------- builders

    @torch.no_grad()
    def encode_text(self, prompts: Sequence[str]) -> torch.Tensor:
        """Prompts → y_words [B, 77, width] (penultimate-layer sequence)."""
        with profiling.span("pipeline.encode.text"):
            toks = torch.as_tensor(tokenize(list(prompts)), dtype=torch.long, device=self.device)
            return self.clip.encode_text(toks)[1]

    def _get_cameras(self, elevation: float, camera_distance: float):
        """The orbit's camera conditioning [1, F, 16] and its splat cameras:
        Plücker rays [1, F, 6, S, S] at the LGM input size, cam_view and
        cam_view_proj [1, F, 4, 4]; on the device, cached per orbit. The
        splat cameras follow the training chain (the LGM's convention), or
        the reference inference engine's mirrored chain when the config sets
        ``reference_inference_cameras``."""
        ref_cams = bool(self.cfg.get("reference_inference_cameras", False))
        key = (self.max_frames, float(elevation), float(camera_distance), ref_cams)
        cached = self._camera_cache.get(key)
        if cached is None:
            cam = orbit_camera_for_t2v(self.max_frames, elevation, camera_distance)
            size = self.gs_settings.input_size
            if ref_cams:
                gs = prepare_gs_cameras(cam, self.gs_settings, ray_size=size)
            else:
                gs = prepare_gs_training(
                    orbit_c2w_opengl(self.max_frames, elevation, camera_distance),
                    self.gs_settings, ray_size=size)
            cached = tuple(torch.as_tensor(a, device=self.device) for a in (
                cam, gs["input_rays"], gs["cam_view"], gs["cam_view_proj"]))
            self._camera_cache[key] = cached
        return cached

    def _serving_mesh(self):
        """The single-sample serving mesh of ``generate(frame_parallel=True)``,
        built once: the ``('sp',)`` frame-parallel mesh (the largest divisor
        of ``max_frames`` within the world), or with ``serving_tp`` > 1 an
        ``('sp', 'tp')`` mesh whose tp ranks hold their heads of the UNet's
        attention (``place_params_tp``, in place: from then on the pipeline
        serves only ``frame_parallel`` requests, ``_whole_unet``). None on one
        rank."""
        if self._sp_tried:
            return self._sp_mesh
        self._sp_tried = True
        tp_n = int(self.cfg.get("serving_tp", 1))
        if tp_n <= 1:
            self._sp_mesh = frame_parallel_mesh(self.max_frames, device_type=self.device.type)
            return self._sp_mesh
        avail = world_size()
        sp_n = max(d for d in range(1, max(avail // tp_n, 1) + 1) if self.max_frames % d == 0)
        if sp_n * tp_n > avail:
            logger.warning("serving_tp=%d: no usable mesh on %d devices — single-device", tp_n,
                           avail)
            return None
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh(self.device.type, torch.arange(sp_n * tp_n).reshape(sp_n, tp_n),
                          mesh_dim_names=("sp", "tp"))
        if in_mesh(mesh):
            self._tp_cut = place_params_tp(mesh, self.unet, head_dim=self.unet.head_dim) > 0
            if self._tp_cut:  # the cut weights are never replayed from a whole UNet's graph
                self.unet.graphs = None
        self._sp_mesh = mesh
        return mesh

    def _whole_unet(self, what: str) -> None:
        """Raise when ``serving_tp`` has cut the UNet's attention to this
        rank's heads: ``what`` would run the cut modules outside the
        ``('sp', 'tp')`` program, and their all-reduce would sum other
        ranks' partial sums of other samples into its own."""
        if self._tp_cut:
            raise RuntimeError(
                f"{what}: this pipeline's UNet holds only this rank's attention heads "
                f"(serving_tp={self.cfg.get('serving_tp')}); it serves generate("
                "frame_parallel=True) alone — build another pipeline for other requests")

    def _frame_parallel(self, mesh, noise: torch.Tensor, cam: torch.Tensor, sample_fn):
        """``sample_fn(noise, cam)`` on this rank's frames of the sample
        under ``frame_sharded``, decoded here; returns every frame's latents
        and uint8 views, gathered over the mesh's sp ranks and broadcast from
        rank 0 to the ranks outside the mesh."""
        b, f = noise.shape[0], self.max_frames
        if in_mesh(mesh):
            shard = FrameShard.of(mesh, f)
            with frame_sharded(shard):
                latents = sample_fn(shard_on_axis(mesh, noise, 2), shard_on_axis(mesh, cam, 1))
            frames = self._decode_latents(latents)
            latents, frames = shard.gather(latents, 2), shard.gather(frames, 1)
        else:
            h, w = self.latent_hw
            latents = torch.empty(noise.shape, device=self.device)
            frames = torch.empty((b, f, h * self.scale, w * self.scale, 3), dtype=torch.uint8,
                                 device=self.device)
        if world_size() > mesh.size():
            broadcast(latents, 0)
            broadcast(frames, 0)
        return latents, frames

    def _data_mesh(self):
        if self._dp_mesh is None:
            self._dp_mesh = make_mesh(device_type=self.device.type)
        return self._dp_mesh

    @torch.no_grad()
    def sample(self, noise: torch.Tensor, y: torch.Tensor, zero_y: torch.Tensor,
               cam: torch.Tensor, steps: int, guide_scale: float,
               gs: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
               view_mesh=None, view_mesh_dim: str = "view") -> torch.Tensor:
        """DDIM with CFG from ``noise`` [B, 4, F, h, w]: latents, float32.
        ``gs`` = (rays, cam_view, cam_view_proj) turns the Gaussian-splat
        refine on, with the config's ``gs_refine_uncond`` (default
        ``full``), ``gs_refine_views`` and ``gs_refine_steps``; ``view_mesh``
        and ``view_mesh_dim`` say how this rank's share of the sample lies on
        a serving mesh (``make_refine_fn``)."""
        b = noise.shape[0]
        unet = self.unet

        def cfg_model(xt, t):
            out = unet(torch.cat([xt, xt]), torch.cat([t, t]), y=torch.cat([y, zero_y]),
                       camera_data=torch.cat([cam, cam]))
            return out[:b], out[b:]

        refine_fn = None
        if gs is not None:
            if self.lgm is None:
                raise ValueError("the Gaussian-splat refine needs UNet.use_lgm_refine True")
            rays, cam_view, cam_view_proj = gs
            refine_fn = make_refine_fn(
                unet=unet, vae=self.vae, lgm=self.lgm, diffusion=self.diffusion,
                scale_factor=self.scale_factor, batch=b, gs_settings=self.gs_settings,
                y=y, zero_y=zero_y, cam=cam, gs_rays=rays, cam_view=cam_view,
                cam_view_proj=cam_view_proj,
                uncond_mode=str(self.cfg.get("gs_refine_uncond", "full")),
                view_idxs=tuple(self.cfg.get("gs_refine_views", REFINE_VIEW_IDXS)),
                view_mesh=view_mesh, view_mesh_dim=view_mesh_dim)
        return ddim_sample_loop(
            self.diffusion, cfg_model, noise, ddim_timesteps=steps, guide_scale=guide_scale,
            refine_fn=refine_fn,
            refine_steps=tuple(self.cfg.get("gs_refine_steps", (20, 30, 40))))

    @torch.no_grad()
    def _decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, 4, F, h, w] → [B, F, H, W, 3] uint8, on the device."""
        with profiling.span("pipeline.decode"):
            b, c, f, h, w = latents.shape
            z = latents.permute(0, 2, 1, 3, 4).reshape(b * f, c, h, w) / self.scale_factor
            img = (self.vae.decode(z) * 0.5 + 0.5).clamp(0.0, 1.0)
            img = img.reshape(b, f, 3, img.shape[-2], img.shape[-1]).permute(0, 1, 3, 4, 2)
            return torch.round(img * 255.0).to(torch.uint8)

    @staticmethod
    def _to_host(frames: torch.Tensor, latents: torch.Tensor) -> Dict[str, np.ndarray]:
        """A request's result: the first sample's views and every latent."""
        with profiling.span("pipeline.to_host"):
            return {"frames": frames[0].cpu().numpy(), "latents": latents.cpu().numpy()}

    # ---------------------------------------------------------- generate

    def _negative(self) -> torch.Tensor:
        neg = self.cfg.get("negative_prompt", "")
        words = self._negative_cache.get(neg)
        if words is None:
            words = self.encode_text([neg])
            self._negative_cache[neg] = words
        return words

    @torch.no_grad()
    def generate(
        self,
        prompt: str,
        steps: int = 50,
        guide_scale: Optional[float] = None,
        use_gs_refine: bool = False,
        seed: Optional[int] = None,
        elevation: float = 15.0,
        camera_distance: float = 2.0,
        y_words: Optional[torch.Tensor] = None,
        negative_words: Optional[torch.Tensor] = None,
        frame_parallel: bool = False,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, np.ndarray]:
        """One prompt → ``max_frames`` orbit views: frames uint8 [F, H, W, 3]
        and latents [1, 4, F, h, w]. ``use_gs_refine`` samples with the
        Gaussian-splat refine (the config must set ``UNet.use_lgm_refine``).
        ``frame_parallel`` spreads the sample's frames over the ranks (module
        docstring; every rank calls and returns the whole sample; one rank
        runs it alone). ``noise`` [1, 4, F, h, w] replaces the seed's."""
        with profiling.request("pipeline.request", self.device):
            cfg = self.cfg
            if guide_scale is None:
                guide_scale = float(cfg.get("guide_scale", 9.0))
            seed = seed if seed is not None else int(cfg.get("seed", 0))
            if "3d asset" not in prompt:
                prompt = prompt + ", 3d asset"
            if y_words is None:
                y_words = self.encode_text([prompt])
            if negative_words is None:
                negative_words = self._negative()
            cam, *gs = self._get_cameras(elevation, camera_distance)
            gs = tuple(gs) if use_gs_refine else None
            if noise is None:
                noise = self._noise(1, seed)
            mesh = self._serving_mesh() if frame_parallel else None
            if mesh is None:
                self._whole_unet("generate(frame_parallel=False)")
                latents = self.sample(noise, y_words, negative_words, cam, steps, guide_scale,
                                      gs=gs)
                frames = self._decode_latents(latents)
            else:
                latents, frames = self._frame_parallel(
                    mesh, noise, cam, lambda nz, cm: self.sample(
                        nz, y_words, negative_words, cm, steps, guide_scale, gs=gs,
                        view_mesh=mesh if gs else None))
            return self._to_host(frames, latents)

    def _noise(self, b: int, seed: int) -> torch.Tensor:
        """The initial noise [b, 4, F, h, w] of ``seed``, on the device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        h, w = self.latent_hw
        return torch.randn((b, 4, self.max_frames, h, w), generator=gen, device=self.device)

    @torch.no_grad()
    def generate_batch(self, prompts, steps: int = 50, guide_scale: Optional[float] = None,
                       use_gs_refine: bool = False, seed: Optional[int] = None,
                       elevation: float = 15.0, camera_distance: float = 2.0,
                       data_parallel: bool = False, force_batched: bool = False,
                       y_words: Optional[torch.Tensor] = None,
                       negative_words: Optional[torch.Tensor] = None,
                       noise: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
        """Several prompts → frames uint8 [B, F, H, W, 3] and latents
        [B, 4, F, h, w].

        One batched program over the B prompts (CFG rows ``[B cond; B
        uncond]``, the refine over 2B rows or B in ``shared``), from noise
        [B, ...] of ``seed``. With ``data_parallel`` on several ranks the
        prompts are padded to a multiple of the world by repeating the last,
        each rank samples its rows, and the rows are gathered (every rank
        returns the batch). On one rank without ``force_batched``, each prompt
        is one ``generate`` (prompt i with seed + i), as the JAX pipeline does
        on one device. ``y_words`` [B, L, C] and ``negative_words`` [1, L, C]
        replace the text encodes, ``noise`` the seed's noise."""
        cfg = self.cfg
        guide_scale = guide_scale if guide_scale is not None else float(cfg.get("guide_scale", 9.0))
        seed = seed if seed is not None else int(cfg.get("seed", 0))
        self._whole_unet("generate_batch")
        b = len(prompts)
        prompts = [p if "3d asset" in p else p + ", 3d asset" for p in prompts]
        if y_words is None:
            y_words = self.encode_text(prompts)
        zero1 = self._negative() if negative_words is None else negative_words
        n = world_size()
        if not force_batched and b > 1 and n == 1:
            outs = [self.generate(p, steps=steps, guide_scale=guide_scale,
                                  use_gs_refine=use_gs_refine, seed=seed + i,
                                  elevation=elevation, camera_distance=camera_distance,
                                  y_words=y_words[i:i + 1], negative_words=zero1)
                    for i, p in enumerate(prompts)]
            return {"frames": np.stack([o["frames"] for o in outs]),
                    "latents": np.stack([o["latents"][0] for o in outs])}
        cam1, *gs = self._get_cameras(elevation, camera_distance)
        gs = tuple(gs) if use_gs_refine else None
        rows = [noise if noise is not None else self._noise(b, seed), y_words,
                zero1.expand(b, *zero1.shape[1:]), cam1.expand(b, *cam1.shape[1:])]
        if data_parallel and n > 1:
            pad = (-b) % n
            if pad:  # pad-and-mask: repeat the last prompt's rows, drop them after
                rows = [torch.cat([x, x[-1:].expand(pad, *x.shape[1:])]) for x in rows]
            mesh = self._data_mesh()
            noise_r, y_r, zero_r, cam_r = (shard_batch(mesh, x) for x in rows)
            latents = self.sample(noise_r, y_r, zero_r, cam_r, steps, guide_scale, gs=gs,
                                  view_mesh=mesh if gs else None, view_mesh_dim="batch")
            frames = self._decode_latents(latents)
            group = mesh.get_group()
            latents = all_gather_cat(latents, group)[:b]
            frames = all_gather_cat(frames, group)[:b]
        else:
            latents = self.sample(*rows, steps, guide_scale, gs=gs)
            frames = self._decode_latents(latents)
        return {"frames": frames.cpu().numpy(), "latents": latents.cpu().numpy()}

    # ------------------------------------------------------- 3D export

    @torch.no_grad()
    def reconstruct_gaussians(self, frames: np.ndarray, elevation: float = 15.0,
                              camera_distance: float = 2.0) -> np.ndarray:
        """The LGM's Gaussians [N, 14] (pos | opacity | scale | quat | rgb,
        activated) from 4 evenly spaced views of a generated orbit
        (``generate()["frames"]``, uint8 or [0, 1] float)."""
        if self.lgm is None:
            raise ValueError("reconstruct_gaussians needs UNet.use_lgm_refine True")
        f = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
        if f.max() > 1.5:
            f = f / 255.0
        idxs = [i * f.shape[0] // 4 for i in range(4)]
        views = f[idxs].permute(0, 3, 1, 2)  # [4, 3, H, W]
        s = self.gs_settings.input_size
        if views.shape[-1] != s:  # jax.image.resize's bilinear, antialiased
            views = F.interpolate(views, size=(s, s), mode="bilinear", antialias=True,
                                  align_corners=False)
        mean = torch.as_tensor(_VID_MEAN, device=self.device).reshape(1, 3, 1, 1)
        std = torch.as_tensor(_VID_STD, device=self.device).reshape(1, 3, 1, 1)
        rays = self._get_cameras(elevation, camera_distance)[1][0, idxs]
        gaussians = self.lgm(torch.cat([(views - mean) / std, rays], dim=1)[None])
        return gaussians[0].cpu().numpy()

    def export_ply(self, frames: np.ndarray, path: str, **kw) -> np.ndarray:
        """``reconstruct_gaussians`` + the reference-compatible ``.ply``."""
        gaussians = self.reconstruct_gaussians(frames, **kw)
        save_ply(gaussians, path)
        return gaussians
