"""The general request generator: a traffic mix is a data file of parameters
under ``mvbench/traffic/``; this file turns it and ``--seed`` into the
cell's requests. The same seed gives the same requests.

Serving mixes (``"kind": "serve"``) hold:

- ``refine``: whether each request takes the Gaussian-splat refine;
- ``source``: ``"prompts"`` (each request draws a prompt from the file
  ``prompts`` beside the mix) or ``"images"`` (each request is an RGBA
  object image of ``image_size``² drawn from the seed: ``objects`` filled
  ellipses and polygons over a transparent background, written under
  ``TMPDIR``);
- ``pool``: how many distinct requests the seed draws; the client sends
  them in order, round after round, so every seed sends requests of the
  same size;
- ``check``: how many finished requests the check samples, and how many
  plain denoising steps of each it reads (the last, and the rest drawn from
  the seed for each request).
"""

from __future__ import annotations

import os
import tempfile
from typing import List

import numpy as np

from .weights import sub_seed


def rng_for(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


def _object_image(rng: np.random.Generator, size: int, objects: int, path: str) -> None:
    from PIL import Image, ImageDraw

    img = Image.new("RGBA", (size, size), (0, 0, 0, 0))
    draw = ImageDraw.Draw(img)
    for _ in range(objects):
        c = tuple(int(v) for v in rng.integers(0, 256, 3)) + (255,)
        cx, cy = rng.uniform(0.3, 0.7, 2) * size
        r = rng.uniform(0.08, 0.25) * size
        if rng.random() < 0.5:
            draw.ellipse([cx - r, cy - r * rng.uniform(0.5, 1.5), cx + r,
                          cy + r * rng.uniform(0.5, 1.5)], fill=c)
        else:
            n = int(rng.integers(3, 7))
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            draw.polygon([(float(cx + r * np.cos(a)), float(cy + r * np.sin(a))) for a in ang],
                         fill=c)
    img.save(path)


def serve_requests(mix: dict, mix_dir: str, seed: int) -> List[dict]:
    """The pool of requests of a serving mix: ``{"prompt" | "image", "seed"}``."""
    rng = rng_for(seed, "traffic")
    n = int(mix["pool"])
    if mix["source"] == "prompts":
        with open(os.path.join(mix_dir, mix["prompts"])) as f:
            prompts = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
        picks = rng.integers(0, len(prompts), n)
        items = [{"prompt": prompts[int(p)]} for p in picks]
    elif mix["source"] == "images":
        out_dir = os.path.join(tempfile.gettempdir(), "mvbench_images", str(int(seed)))
        os.makedirs(out_dir, exist_ok=True)
        items = []
        for k in range(n):
            path = os.path.join(out_dir, f"object_{k}.png")
            _object_image(rng, int(mix["image_size"]), int(mix["objects"]), path)
            items.append({"image": path})
    else:
        raise ValueError(f"unknown request source {mix['source']!r}")
    for item in items:
        item["seed"] = int(rng.integers(0, 2 ** 62))
    return items
