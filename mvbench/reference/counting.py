"""The work of one unit of a cell, counted over the plain reference on the
``meta`` device at the cell's shapes: the model FLOPs that
``torch.utils.flop_counter.FlopCounterMode`` counts (the products and
convolutions), and every attention and feed-forward call with its shape
(``nets.record_calls``). The count depends on the configuration and the
traffic alone, not on what implements them."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import nets
from .serving import build_models


def _count(fn) -> Tuple[float, list]:
    with FlopCounterMode(display=False) as fc, nets.record_calls() as calls:
        fn()
    return float(fc.get_total_flops()), list(calls)


def serve_request(config: dict, i2v: bool, refine: bool, steps: int) -> Dict[str, object]:
    """``{"flops": model FLOPs of one request, "calls": [(kind, shape,
    masked) × times]}``: one text encode (the negative prompt's is cached
    per process), for I2V the visual tower and the reference-frame encode,
    ``steps`` CFG denoiser forwards (the refine steps: a cond-row forward,
    the decode of the refine views, the LGM and the encode of every view),
    and the final decode. The splat render's compositing is not counted."""
    p = config["pipeline"]
    f = int(p.get("max_frames", 24))
    res = int(p.get("resolution", [256, 256])[0])
    h = res // int(p.get("scale", 8))
    ctx = int(config["models"]["clip"].get("width", 1024))
    refine_steps = ([i for i in p.get("gs_refine_steps", (20, 30, 40)) if 0 <= int(i) < steps]
                    if refine else [])
    with torch.device("meta"):
        m = build_models(config, i2v)
        parts: List[Tuple[int, object]] = []
        toks = torch.zeros(1, 77, dtype=torch.long)
        parts.append((1, lambda: m["clip"].encode_text(toks)))
        kw = {}
        if i2v:
            parts.append((1, lambda: m["clip"].visual(torch.zeros(1, 3, 224, 224))))
            parts.append((1, lambda: m["vae"].encode_mode(torch.zeros(1, 3, res, res))))
            emb = int(config["pipeline"]["UNet"].get("y_dim", 1024))
            kw = lambda b: dict(local_image=torch.zeros(b, 4, 1, h, h), image=torch.zeros(b, emb))
        cam = lambda b: torch.zeros(b, f, 16)

        def unet(b):
            t = torch.zeros(b, dtype=torch.long)
            extra = kw(b) if i2v else {}
            return m["unet"](torch.zeros(b, 4, f, h, h), t, y=torch.zeros(b, 77, ctx),
                             camera_data=cam(b), **extra)

        parts.append((steps - len(refine_steps), lambda: unet(2)))
        if refine_steps:
            n = len(refine_steps)
            lgm = nets.lgm_options(config["models"]["lgm"])
            s = int(p.get("gs_input_size", lgm["input_size"]))
            k = len(p.get("gs_refine_views", (0, 6, 12, 18)))
            parts.append((n, lambda: unet(1)))
            parts.append((n, lambda: m["vae"].decode(torch.zeros(k, 4, h, h))))
            parts.append((n, lambda: m["lgm"](torch.zeros(1, k, 9, s, s))))
            parts.append((n, lambda: m["vae"].encode_mode(torch.zeros(f, 3, s, s))))
        parts.append((1, lambda: m["vae"].decode(torch.zeros(f, 4, h, h))))
        flops, calls = 0.0, []
        for times, fn in parts:
            fl, cl = _count(fn)
            flops += times * fl
            calls += cl * times
    return {"flops": flops, "calls": calls}


def work(config: dict, i2v: bool, mix: dict) -> Dict[str, object]:
    """The work of one unit of the traffic mix ``mix``."""
    steps = int(config["pipeline"].get("ddim_timesteps", 50))
    return serve_request(config, i2v, bool(mix["refine"]), steps)
