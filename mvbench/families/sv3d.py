"""The ``sv3d`` family: Stable Video 3D (``sv3d_p``) served by the port's
``SV3DPipeline`` (``videomv_tpu_torch/inference/sv3d.py``) as its CLI serves
an image (``generate_from_image``), with the benchmark's seeded weights
loaded through ``load_state_dicts``, and judged by the plain reference
``reference/sv3d.py``.

Each request's orbit is drawn from its seed (``orbit_of``): the elevation of
frame f is ``e0 + A·sin(2πf/T + φ)`` with e0, A and φ uniform in the mix's
``orbit`` ranges; the azimuths are the source script's.

What the check reads of the program, which a change to it has to keep: the
entry returns ``latents`` [T, 4, h, w] and ``frames`` [T, R, R, 3] uint8; the
guided denoiser ``pipe.denoiser`` is a module whose forward hooks fire on
every Euler step, called as ``denoiser(x, sigma, context=, concat=, y=)``
with x the sampler's fp32 state and the conditioning's 2T rows, cond first;
the UNet ``pipe.unet`` is a module. While the window runs, the watch keeps on
pinned host buffers every step's state of the requests that the seed's
reservoir sample holds (``videomv.Recorder``'s Algorithm R), and the
conditioning of their first step. After the window the check holds them to
the reference (``check_requests``): ``cond``, ``step``, ``frames`` and
``missing``. With ``--trace 1`` the watch also takes fenced spans around the
encodes and the decode and CUDA events around each UNet forward.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference import lowp
from ..reference import sv3d as ref
from ..traffic import rng_for
from ..weights import sub_seed


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", non_blocking=True)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def orbit_of(item: dict, orbit: dict, frames: int) -> List[float]:
    """The request's elevations in degrees, one a frame, from its seed."""
    rng = np.random.default_rng(sub_seed(int(item["seed"]), "orbit"))
    e0 = rng.uniform(*orbit["e0_deg"])
    amp = rng.uniform(*orbit["amplitude_deg"])
    phase = rng.uniform(0.0, 2 * math.pi)
    return [float(e0 + amp * math.sin(2 * math.pi * f / frames + phase)) for f in range(frames)]


class Program:
    def __init__(self, config: dict, mix: dict, device):
        from videomv_tpu_torch.config import AttrDict
        from videomv_tpu_torch.inference.sv3d import SV3DPipeline

        cfg = AttrDict(dict(config["pipeline"], models=config["models"]))
        self.pipe = SV3DPipeline(cfg, device=device, seed=0)
        self.orbit = mix["orbit"]

    def shapes(self) -> Dict[str, list]:
        return {n: [(k, t.shape) for k, t in m.state_dict().items()]
                for n, m in self.pipe.models.items()}

    def load(self, state_dicts) -> None:
        self.pipe.load_state_dicts(**state_dicts)

    def swap(self, models) -> None:
        """Other modules in the place of the pipeline's (the control)."""
        for name, m in models.items():
            setattr(self.pipe, name, m)
        self.pipe.denoiser = type(self.pipe.denoiser)(self.pipe.unet, self.pipe.denoiser.scale)

    def request(self, item: dict) -> dict:
        return self.pipe.generate_from_image(
            item["image"], seed=item["seed"],
            elevations=orbit_of(item, self.orbit, self.pipe.num_frames))

    @staticmethod
    def finite(out: dict) -> bool:
        return bool(np.isfinite(np.asarray(out["latents"])).all())


def steps_to_check(steps: int, n: int, seed: int, place: int) -> set:
    """The last step and ``n − 1`` more drawn from the seed, per place."""
    rng = rng_for(seed, f"check_steps.{place}")
    return {steps - 1} | {int(i) for i in rng.choice(steps - 1, n - 1, replace=False)}


class Watch:
    """The recorder on ``pipe.denoiser`` (module docstring)."""

    def __init__(self, program, config: dict, mix: dict, seed: int, spans, trace: bool):
        self.config, self.mix, self.seed, self.spans = config, mix, seed, spans
        self.k = int(mix["check"]["requests"])
        self.steps = len(program.pipe.sigmas) - 1
        self.rng = rng_for(seed, "check_sample")
        self.slots: Dict[int, dict] = {}
        self.cur: Optional[dict] = None
        self._free: List[torch.Tensor] = []
        self.pin = torch.cuda.is_available()
        self.events = trace and spans.device.type == "cuda"
        self.fwd: List[tuple] = []
        self._ev = None
        self.on = False
        self.sample: Dict[int, dict] = {}
        pipe = program.pipe
        self._hooks = [pipe.denoiser.register_forward_pre_hook(self._pre, with_kwargs=True)]
        if self.events:
            self._hooks += [pipe.unet.register_forward_pre_hook(self._unet_pre),
                            pipe.unet.register_forward_hook(self._unet_post)]
        if trace:
            for name in ("encode_image_clip", "encode_cond_latent"):
                setattr(pipe, name, spans.wrap(getattr(pipe, name), "encode"))
            pipe._decode_latents = spans.wrap(pipe._decode_latents, "decode")

    def begin(self, j: Optional[int]) -> None:
        place = -1 if j is None else j if j < self.k else int(self.rng.integers(0, j + 1))
        self.cur = {"index": j, "place": place, "n": 0, "buf": None} if place < self.k else None

    def end(self) -> None:
        r, self.cur = self.cur, None
        if r is None or r["buf"] is None:
            return
        if r["place"] < 0:  # the warm-up: its buffer and one for each place
            self._free += [r["buf"]] + [torch.empty_like(r["buf"], pin_memory=self.pin)
                                        for _ in range(self.k)]
            return
        old = self.slots.get(r["place"])
        if old is not None:
            self._free.append(old["buf"])
        self.slots[r["place"]] = r

    def _pre(self, module, args, kwargs):
        r = self.cur if self.on else None
        if r is None:
            return
        x = args[0]
        if r["buf"] is None:
            r["buf"] = (self._free.pop() if self._free else
                        torch.empty((self.steps,) + tuple(x.shape), dtype=x.dtype,
                                    pin_memory=self.pin))
        j = r["n"]
        r["n"] += 1
        if j == 0:
            t = x.shape[0]
            r["cond"] = {"token": _host(kwargs["context"][:1]),
                         "latent": _host(kwargs["concat"][:1]),
                         "vector": _host(kwargs["y"][:t]),
                         "uncond": _host(torch.stack([kwargs["context"][t:].abs().amax(),
                                                      kwargs["concat"][t:].abs().amax()]))}
        if j < self.steps:
            r["buf"][j].copy_(x, non_blocking=True)

    def _unet_pre(self, module, args):
        if self.on and self.spans.on:
            self._ev = (args[0].shape[0], torch.cuda.Event(enable_timing=True))
            self._ev[1].record()

    def _unet_post(self, module, args, out):
        if self.on and self.spans.on and self._ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.fwd.append((self._ev[0], self._ev[1], end))

    def readings(self) -> dict:
        """The CFG forwards' CUDA-event milliseconds (``sampler.unet_fwd_ms``)."""
        return {"cfg_forward_ms": [a.elapsed_time(b) for rows, a, b in self.fwd if rows > 1]}

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
        if self.pin:
            torch.cuda.synchronize()
        self.sample = {r["index"]: r for r in self.slots.values()}
        self.slots, self._free = {}, []

    def check(self, state_dicts, items, outputs, device):
        return check_requests(self.config, self.mix, state_dicts, items, self.sample, outputs,
                              self.seed, device)


def check_requests(config, mix, state_dicts, items, records, outputs, seed, device):
    """The readings of the sampled requests against the fp32 reference, each
    the largest relative L2 gap over the sample: ``cond`` (the CLIP token,
    the concat latent and the camera vectors the denoiser received, and the
    uncond rows' token and latent, which must be zero); ``step`` (at the
    checked steps, the guided network output that the program's Euler
    update from its state x to its next state used, against the reference's
    from the same x: the output, not D, which at σ = 0.002 is x to 6
    digits); ``frames`` (the views of the final latents); ``missing``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = ref.Reference(config, state_dicts, device)
    steps = len(r.sigmas) - 1
    read, detail = {"cond": 0.0, "step": 0.0, "frames": 0.0, "missing": 0}, []
    for place, k in enumerate(sorted(records)):
        rec, out = records[k], outputs[k]
        if out is None:  # raised: counted as failed
            continue
        if rec["n"] != steps or "cond" not in rec:
            read["missing"] += abs(steps - rec["n"]) + ("cond" not in rec)
            print(f"mvbench: request {k}: {rec['n']} denoiser calls recorded of {steps} (the "
                  f"check reads them through forward hooks on pipe.denoiser)", file=sys.stderr,
                  flush=True)
            continue
        item = items[k]
        latents = torch.as_tensor(np.asarray(out["latents"]), device=device)
        xs = rec["buf"]

        def x(i):  # the program's state before step i; after the last, its latents
            return xs[i].to(device) if i < steps else latents
        c = r.conditioning(item, orbit_of(item, mix["orbit"], r.frames))
        for key, want in c.items():
            read["cond"] = max(read["cond"], _rel(rec["cond"][key].to(device), want))
        read["cond"] = max(read["cond"], float(rec["cond"]["uncond"].max()))
        for i in sorted(steps_to_check(steps, int(mix["check"]["steps"]), seed, place)):
            got = r.implied_output(x(i), x(i + 1), i)
            detail.append(("step", k, i, _rel(got, r.guided_output(x(i), i, c))))
            read["step"] = max(read["step"], detail[-1][-1])
        frames = torch.as_tensor(np.asarray(out["frames"]), device=device).float()
        read["frames"] = max(read["frames"], _rel(frames, r.frames_of(latents).float()))
    return read, detail


def work(config: dict, mix: dict) -> Dict[str, object]:
    """The model FLOPs and the attention and feed-forward calls of one
    request, counted over the reference on the meta device: the CLIP tower,
    the VAE encode, ``num_steps`` CFG forwards of 2T rows and the decode."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference import nets

    p = config["pipeline"]
    t = int(p["VideoUNet"]["num_frames"])
    res = int(p["resolution"][0])
    h = res // int(p["scale"])
    steps = int(p["Sampler"]["num_steps"])
    with torch.device("meta"):
        m = ref.build_models(config)
        vi = config["models"]["clip_visual"]["image_size"]
        parts = [(1, lambda: m["clip"](torch.zeros(1, 3, vi, vi))),
                 (1, lambda: m["vae"].encode_mode(torch.zeros(1, 3, res, res))),
                 (steps, lambda: m["unet"](torch.zeros(2 * t, 8, h, h), torch.zeros(2 * t),
                                           torch.zeros(2 * t, 1, p["VideoUNet"]["context_dim"]),
                                           torch.zeros(2 * t, p["VideoUNet"]["adm_in_channels"]))),
                 (1, lambda: m["vae"].decode(torch.zeros(t, 4, h, h)))]
        flops, calls = 0.0, []
        for times, fn in parts:
            with FlopCounterMode(display=False) as fc, nets.record_calls() as cl:
                fn()
            flops += times * float(fc.get_total_flops())
            calls += list(cl) * times
    return {"flops": flops, "calls": calls}


def control(config: dict, state_dicts, device) -> dict:
    """The control's models for ``Program.swap``: the reference in fp8 (its
    weights and every product's input rounded to e4m3, ``reference/lowp.py``).
    TF32 is allowed for its products: an fp8 value is exact in TF32, so only
    the speed changes (the check turns TF32 off again)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    r = ref.Reference(config, state_dicts, device)
    m = lowp.fp8_models(r.m)
    return {"unet": m["unet"], "vae": lowp._Vae(m["vae"]), "clip": m["clip"]}
