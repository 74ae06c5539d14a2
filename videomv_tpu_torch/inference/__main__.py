"""CLI entry of the port: text → multiview generation on one device.

    python -m videomv_tpu_torch.inference --cfg configs/t2v_infer.yaml \
        [--debug] [--seed N] [--device cuda] [k v ...]

Takes the arguments of the JAX package's ``inference.py`` plus ``--device``.
It runs on the card: without a CUDA device it stops with an error, and
``--device cpu`` is the only way onto the CPU. It reads the same YAML files
(merging the linked train YAML via ``vldm_cfg``), reads prompts from
``test_list_path`` and writes under ``log_dir``, for every prompt, the
plain sample; with ``UNet.use_lgm_refine`` (as ``configs/t2v_infer.yaml``
ships) also the Gaussian-splat refined sample (``_gs``), and with
``save_ply`` its Gaussians as a ``.ply``. Videos are mp4, PNG frames or
``.npy``, whichever writer the machine has.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import time
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="videomv_tpu_torch inference")
    p.add_argument("--cfg", dest="cfg_file", default="configs/t2v_infer.yaml")
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked for)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Run the CLI; returns the paths it wrote."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(levelname)s: %(message)s")

    import torch

    from ..config import load_inference_config
    from ..utils.device import resolve_device
    from ..utils.video_io import save_multiview_video
    from .pipeline import T2VPipeline

    device = resolve_device(args.device)
    cfg = load_inference_config(args.cfg_file, opts=args.opts or [])
    if args.seed is not None:
        cfg.seed = args.seed
    cfg.debug = args.debug

    task = cfg.get("TASK_TYPE", "inference_text2video_entrance")
    if task == "inference_i2vgen_entrance":
        raise NotImplementedError("I2V is not ported yet (a later slice of the port)")
    if task != "inference_text2video_entrance":
        raise SystemExit(f"unknown TASK_TYPE {task}")

    logging.info("torch %s device %s", torch.__version__, device)
    pipe = T2VPipeline(cfg, device=device, seed=int(cfg.get("seed", 0)))
    pipe.init_params()

    items = []
    lp = cfg.get("test_list_path")
    if lp and os.path.exists(lp):
        with open(lp) as f:
            items = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    if not items:
        items = ["a wooden chair"]
    if args.debug:
        items = items[:1]

    log_dir = cfg.get("log_dir", "workspace/visualization")
    os.makedirs(log_dir, exist_ok=True)
    use_refine = bool(cfg.get("UNet", {}).get("use_lgm_refine", False))
    rounds = 1 if args.debug else int(cfg.get("round", 1))
    steps = int(cfg.get("ddim_timesteps", 50))
    written = []
    for r in range(rounds):
        for idx, item in enumerate(items):
            seed = int(cfg.get("seed", 0)) + r
            logging.info("[%d/%d] sampling %r (seed %d)", idx, len(items), item, seed)
            cap_name = re.sub(r"[^\w\s]", "", item).replace(" ", "_")[:60]
            stem = os.path.join(log_dir, f"{idx:04d}_{cap_name}_{seed}")
            t0 = time.time()
            out = pipe.generate(item, steps=steps, seed=seed)
            written.append(save_multiview_video(stem + ".mp4", out["frames"], caption=item))
            logging.info("saved %s (%.1fs)", written[-1], time.time() - t0)
            if use_refine:
                t0 = time.time()
                out_gs = pipe.generate(item, steps=steps, use_gs_refine=True, seed=seed)
                written.append(save_multiview_video(stem + "_gs.mp4", out_gs["frames"],
                                                    caption=item))
                logging.info("saved %s (%.1fs)", written[-1], time.time() - t0)
                if bool(cfg.get("save_ply", False)):
                    pipe.export_ply(out_gs["frames"], stem + ".ply")
                    written.append(stem + ".ply")
                    logging.info("saved %s", written[-1])
    logging.info("inference complete")
    return written


if __name__ == "__main__":
    main()
