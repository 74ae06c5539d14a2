"""What the VideoMV families (``t2v``, ``i2v``) decide in a serving run:
what the benchmark records of the program's requests, and how the plain
reference (``reference.serving``) judges them. The serving window
(``mvbench/serve.py``) reaches it through the family's ``Watch``.

While the window runs, the watch keeps on the host what the check needs of
the requests that the seed's sample holds: the conditioning the denoiser
received, the sampler's state at every step, and each refine's input,
stages and output; the entry returns the final latents and views. After
the window, once the peak is read and the program is freed, the reference
judges the sampled requests.

What the check reads of the program, which a change to it has to keep:
the entry (``Program.request``) returns ``latents`` and ``frames``; the
denoiser ``pipe.unet`` runs as a module whose forward hooks fire on every
call, called as ``unet(x, t, **cond)`` with x the sampler's fp32 state (the
cond rows first, the uncond rows after them in a CFG call) and t the
schedule's integer timestep of the step; its keyword inputs named in the
program's ``COND_KWARGS`` carry the conditioning, cond row first and the
uncond row second in ``y``; at a refine step the refine calls the same
denoiser on the cond rows; the LGM ``pipe.lgm`` is a module whose hooks fire;
and the pipeline builds its refine function from the factories the program
names. A planned record that is missing is counted under ``missing`` (limit
0) and named on standard error.

With ``--trace 1`` the watch also takes fenced spans around the encodes,
the decode and each refine and CUDA events around each denoiser forward.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference.diffusion import DDIM, implied_x0
from ..reference.lowp import fp8_models, program_facing
from ..reference.serving import ServeReference
from ..traffic import rng_for
from ..tracing import Spans


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", non_blocking=True)


class Recorder:
    """Forward hooks on the program's denoiser and LGM and a wrapper of its
    refine function. They record the requests that the seed's reservoir
    sample holds (Algorithm R: request j of the window takes one of the
    ``k`` places with chance k/(j+1)), which is uniform over the requests
    whatever their number. Of each recorded request every denoiser forward's
    timestep and x (its cond rows) go to pinned host buffers without a wait,
    with the conditioning of its first forward and each refine's timestep,
    input, LGM input, Gaussians and output; with ``events``, a CUDA-event
    pair around every forward. ``records`` keys them by loop index."""

    def __init__(self, program, seed: int, k: int, steps: int, spans: Spans, events: bool):
        self.cond_kwargs, self.k, self.steps, self.spans = program.COND_KWARGS, k, steps, spans
        self.rng = rng_for(seed, "check_sample")
        self.slots: Dict[int, dict] = {}      # place in the sample -> record
        self.cur: Optional[dict] = None       # the record of the request in flight
        self._refine: Optional[dict] = None   # the record of the refine in flight
        self._free: List[dict] = []           # pinned buffers no record holds
        self._ev = None
        self.pin = torch.cuda.is_available()
        self.fwd: List[tuple] = []
        self.events = events
        self.on = False
        unet, lgm = program.pipe.unet, program.pipe.lgm
        self._hooks = [unet.register_forward_pre_hook(self._pre, with_kwargs=True),
                       unet.register_forward_hook(self._post, with_kwargs=True)]
        if lgm is not None:
            self._hooks += [lgm.register_forward_pre_hook(self._lgm_pre),
                            lgm.register_forward_hook(self._lgm_post)]
        self._patched = []
        for module, name in program.refine_factories():
            orig = getattr(module, name)
            setattr(module, name, self._factory(orig))
            self._patched.append((module, name, orig))

    def close(self):
        for h in self._hooks:
            h.remove()
        for module, name, orig in self._patched:
            setattr(module, name, orig)

    def begin(self, j: Optional[int]):
        """Request ``j`` of the window starts (``None``: the warm-up, which
        is recorded to size the buffers and then dropped)."""
        place = -1 if j is None else j if j < self.k else int(self.rng.integers(0, j + 1))
        self.cur = ({"index": j, "place": place, "n": 0, "refine": [], "buf": None}
                    if place < self.k else None)

    def end(self):
        r, self.cur = self.cur, None
        if r is None:
            return
        if r["place"] < 0:
            if r["buf"] is None:
                return
            self._free.append(r["buf"])
            # one buffer a place in the sample, and one for the request in flight
            self._free += [self._buffer_like(r["buf"]) for _ in range(self.k)]
            return
        old = self.slots.get(r["place"])
        if old is not None:
            self._free.append(old["buf"])
        self.slots[r["place"]] = r

    def _buffer_like(self, buf: dict) -> dict:
        return {k: torch.empty_like(v, pin_memory=self.pin) for k, v in buf.items()}

    def _buffer(self, x: torch.Tensor, t: torch.Tensor) -> dict:
        cap = 2 * self.steps + 8  # room for a step split over two calls
        while self._free:
            buf = self._free.pop()
            if buf["x"].shape[1:] == x.shape and buf["x"].dtype == x.dtype:
                return buf
        return {"x": torch.empty((cap,) + tuple(x.shape), dtype=x.dtype, pin_memory=self.pin),
                "t": torch.empty((cap,), dtype=t.dtype, pin_memory=self.pin)}

    def _pre(self, module, args, kwargs):
        if not self.on:
            return
        if self.events and self.spans.on:
            self._ev = (args[0].shape[0], torch.cuda.Event(enable_timing=True))
            self._ev[1].record()
        r = self.cur
        if r is None:
            return
        x = args[0]
        t = args[1] if len(args) > 1 else kwargs["t"]
        j = r["n"]
        r["n"] += 1
        if j == 0:
            y = kwargs["y"]
            r["cond"] = {k: _host(kwargs[kw][:1]) for k, kw in self.cond_kwargs.items()}
            if y.shape[0] > 1:
                r["cond"]["zero_y"] = _host(y[1:2])
        half = x[:max(x.shape[0] // 2, 1)]
        if r["buf"] is None:
            r["buf"] = self._buffer(half, t)
        buf = r["buf"]
        if j < buf["t"].shape[0]:
            buf["x"][j].copy_(half, non_blocking=True)
            buf["t"][j:j + 1].copy_(t[:1], non_blocking=True)

    def _post(self, module, args, kwargs, out):
        if self.on and self.events and self.spans.on:
            rows, ev = self._ev
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.fwd.append((rows, ev, end))

    def _lgm_pre(self, module, args):
        if self._refine is not None:
            self._refine["lgm_in"] = _host(args[0])

    def _lgm_post(self, module, args, out):
        if self._refine is not None:
            self._refine["gaussians"] = _host(out)

    def _factory(self, make):
        rec = self

        def make_recorded(*a, **kw):
            fn = make(*a, **kw)

            def refine_fn(xt, t):
                r = rec.cur if rec.on else None
                rec._refine = {} if r is not None else None
                with rec.spans("refine"):
                    out = fn(xt, t)
                if r is not None:
                    rec._refine.update(t=_host(t[:1]), x=_host(xt), z=_host(out[0]))
                    r["refine"].append(rec._refine)
                rec._refine = None
                return out
            return refine_fn
        return make_recorded

    def records(self, timesteps: List[int]) -> Dict[int, dict]:
        """The sample's records by request index, once the device is done:
        ``x`` {loop index: x_t of the cond rows}, ``refine`` {loop index:
        the refine's record} and ``cond``. A forward whose timestep is not
        the schedule's, or that found no room, is left out."""
        if self.pin:
            torch.cuda.synchronize()
        index = {int(s): i for i, s in enumerate(timesteps)}
        step_of = lambda t: index.get(int(round(float(t))))
        out = {}
        for r in self.slots.values():
            buf, xs = r.pop("buf"), {}
            for j in range(min(r["n"], buf["t"].shape[0] if buf is not None else 0)):
                if step_of(buf["t"][j]) is not None:
                    xs.setdefault(step_of(buf["t"][j]), buf["x"][j])
            r.update(x=xs, refine={step_of(e["t"][0]): e for e in r["refine"]})
            out[r["index"]] = r
        return out

    def forward_ms(self) -> List[tuple]:
        return [(rows, a.elapsed_time(b)) for rows, a, b in self.fwd]


class Watch(Recorder):
    """A VideoMV family's part of a serving run (``mvbench/serve.py``): the
    recorder on the program, and with ``trace`` the encode and decode spans
    wrapped around the pipeline's methods. After ``close()`` it keeps the
    sample's records, which ``check`` judges with the reference."""

    def __init__(self, program, config: dict, mix: dict, seed: int, spans: Spans, trace: bool):
        self.config, self.i2v = config, program.I2V
        self.pl = plan(config, mix)
        super().__init__(program, seed, int(mix["check"]["requests"]), self.pl["steps"], spans,
                         events=trace and spans.device.type == "cuda")
        self.seed, self.sample = seed, {}
        if trace:
            for name in program.ENCODE_METHODS:
                setattr(program.pipe, name, spans.wrap(getattr(program.pipe, name), "encode"))
            program.pipe._decode_latents = spans.wrap(program.pipe._decode_latents, "decode")

    def readings(self) -> dict:
        """The traced window's readings that the per-layer metrics take:
        the CFG forwards' CUDA-event milliseconds."""
        return {"cfg_forward_ms": [ms for rows, ms in self.forward_ms() if rows > 1]}

    def close(self) -> None:
        """The hooks and patches off; the sample's records kept, the other
        pinned buffers let go."""
        super().close()
        self.sample = self.records(self.pl["timesteps"])
        self.slots, self._free = {}, []

    def check(self, state_dicts, items, outputs, device):
        """``check_requests`` over the sample: the readings and each stage's."""
        return check_requests(self.config, self.i2v, state_dicts, items, self.sample, outputs,
                              self.pl, self.seed, device)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check_requests(config, i2v, state_dicts, items, records, outputs, pl, seed, device):
    """The readings of the sampled requests against the fp32 reference, each
    the largest relative L2 gap over the sample: ``cond`` (the conditioning
    the denoiser received); ``step`` (at the checked plain steps, the eps
    that the program's DDIM update from x_t to its next state used, against
    the reference's guided eps from the same x_t); the refine stage by stage
    from the program's input to each stage (``lgm_in``: the x0 estimate
    decoded into the LGM's input; ``lgm``: the Gaussians; ``refine``: the x0
    that the program's DDIM update at the refine step used, from its x_t and
    next state, against the views of the program's Gaussians rendered and
    encoded); ``frames`` (the decoded views of the final latents); and
    ``missing``, the planned records that the program's run left out.
    Returns the readings and each stage's reading."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ServeReference(config, i2v, state_dicts, device)
    steps, refine_at = pl["steps"], pl["refine_at"]
    ts = ref.ddim.timesteps(steps)
    stride = ref.ddim.T // steps
    read = {"cond": 0.0, "step": 0.0, "frames": 0.0, "missing": 0}
    if refine_at:
        read.update(lgm_in=0.0, lgm=0.0, refine=0.0)
    pairs, detail = [], []
    for place, k in enumerate(sorted(records)):
        item, rec, out = items[k], records[k], outputs[k]
        if out is None:  # raised: counted as failed
            continue
        check_steps = steps_to_check(pl, seed, place)
        need = sorted(set(check_steps) | refine_at |
                      {i + 1 for i in check_steps | refine_at if i + 1 < steps})
        gone = [f"x_t at loop index {i}" for i in need if i not in rec["x"]]
        gone += [f"the refine at loop index {i}" for i in sorted(refine_at - set(rec["refine"]))]
        if "zero_y" not in rec.get("cond", {}):
            gone.append("the conditioning")
        if gone:
            read["missing"] += len(gone)
            print(f"mvbench: request {k}: the check found no record of {', '.join(gone)} (it "
                  f"reads the denoiser's (x, t) and conditioning through forward hooks on "
                  f"pipe.unet, the refine through its factory and pipe.lgm's hooks)",
                  file=sys.stderr, flush=True)
            continue
        latents = torch.as_tensor(np.asarray(out["latents"]), device=device)

        def x(i):  # the program's x_t at loop index i; after the last step, its latents
            return rec["x"][i].to(device) if i < steps else latents
        c = ref.conditioning(item)
        for key, want in c.items():
            read["cond"] = max(read["cond"], _rel(rec["cond"][key].to(device), want))
        for i in sorted(check_steps):
            eps, eps_ref = ref.step_eps(x(i), x(i + 1), i, steps, pl["guide_scale"], c)
            detail.append(("step", k, i, _rel(eps, eps_ref)))
            read["step"] = max(read["step"], detail[-1][-1])
        for i in sorted(refine_at):
            r = rec["refine"][i]
            # stage by stage, each from the program's own input to it
            lgm_in = ref.lgm_input(r["x"].to(device), i, steps, c)
            read["lgm_in"] = max(read["lgm_in"], _rel(r["lgm_in"].to(device), lgm_in))
            gauss = ref.gaussians(r["lgm_in"].to(device))
            read["lgm"] = max(read["lgm"], _rel(r["gaussians"].to(device), gauss))
            z_ref, demanded = ref.render_encode(r["gaussians"].to(device))
            a, a_prev = ref.ddim._a(ts[i]), ref.ddim._a(ts[i] - stride)
            used = implied_x0(x(i + 1), x(i), a, a_prev)
            detail.append(("refine", k, i, _rel(used, z_ref)))
            detail.append(("refine_output", k, i, _rel(r["z"].to(device), z_ref)))
            read["refine"] = max(read["refine"], detail[-2][-1])
            pairs.append(demanded)
        frames = torch.as_tensor(np.asarray(out["frames"]), device=device).float()
        read["frames"] = max(read["frames"], _rel(frames, ref.frames_of(latents).float()))
    if pairs:
        cap = render_capacity(config)
        print(f"mvbench: refine pairs demanded per view (reference render of the program's "
              f"Gaussians): min {min(map(min, pairs))}, max {max(map(max, pairs))}, capacity "
              f"{cap}", flush=True)
    return read, detail


def render_capacity(config: dict) -> int:
    from ..reference import nets, render

    lgm = nets.lgm_options(config["models"]["lgm"])
    n = 4 * lgm["splat_size"] ** 2
    return render.capacity(n, int(config["pipeline"].get("gs_render_size", 256)))


def plan(config: dict, mix: dict) -> dict:
    """What a run of this mix does: the sampler's settings, the loop indices
    at which it refines, and how many plain steps the check reads."""
    p = config["pipeline"]
    steps = int(p.get("ddim_timesteps", 50))
    refine_at = ({int(i) for i in p.get("gs_refine_steps", (20, 30, 40))} if mix["refine"]
                 else set())
    return {"steps": steps, "guide_scale": float(p.get("guide_scale", 9.0)),
            "refine_at": refine_at, "check_steps": int(mix["check"]["steps"]),
            "timesteps": DDIM(p["Diffusion"]).timesteps(steps)}


def steps_to_check(pl: dict, seed: int, place: int) -> set:
    """The plain steps the check reads of the request at ``place`` in the
    sample: the last step, and the rest drawn from the seed, per place."""
    plain = [i for i in range(pl["steps"]) if i not in pl["refine_at"]]
    last, rest = plain[-1], plain[:-1]
    rng = rng_for(seed, f"check_steps.{place}")
    return {last} | {int(i) for i in rng.choice(rest, pl["check_steps"] - 1, replace=False)}


def control(config: dict, i2v: bool, state_dicts, device) -> dict:
    """The control's models for ``Program.swap``: the reference in fp8."""
    ref = ServeReference(config, i2v, state_dicts, device)
    return program_facing(fp8_models(ref.m))
