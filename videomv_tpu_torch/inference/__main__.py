"""CLI entry of the port: text or image → multiview generation.

    python -m videomv_tpu_torch.inference --cfg configs/t2v_infer.yaml \
        [--debug] [--seed N] [--device cuda] [k v ...]
    python -m videomv_tpu_torch.inference --cfg configs/i2vgen_xl_infer.yaml --debug
    torchrun --nproc-per-node N -m videomv_tpu_torch.inference --cfg ... frame_parallel True

Under ``torchrun`` each process drives ``cuda:LOCAL_RANK`` (NCCL; gloo with
``--device cpu``): with ``frame_parallel: true`` in the config each sample's
frames are spread over the processes (``serving_tp: N`` also splits the
attention heads N ways), as the JAX package's ``inference.py`` reads them;
without it every process serves the whole sample. Rank 0 writes.

Takes the arguments of the JAX package's ``inference.py`` plus ``--device``.
It runs on the card: without a CUDA device it stops with an error, and
``--device cpu`` is the only way onto the CPU. It reads the same YAML files
(merging the linked train YAML via ``vldm_cfg``), reads prompts from
``test_list_path`` and writes under ``log_dir``, for every prompt, the
plain sample; with ``UNet.use_lgm_refine`` (as ``configs/t2v_infer.yaml``
ships) also the Gaussian-splat refined sample (``_gs``), and with
``save_ply`` its Gaussians as a ``.ply``. Videos are mp4, PNG frames or
``.npy``, whichever writer the machine has. With ``TASK_TYPE:
inference_i2vgen_entrance`` the items of ``test_list_path`` are image paths
(an empty list is an error), the outputs are named after the image file, and
no ``.ply`` is written. With ``TASK_TYPE: inference_sv3d_entrance``
(``videomv_tpu_torch/configs/sv3d_p_infer.yaml``) each image path is served
by Stable Video 3D (``inference/sv3d.py``): ``num_frames`` orbit views at the
config's resolution, no refine. ``VIDEOMV_ENABLE_FUSED_SPATIAL=1`` in the environment
runs the UNet's 32² spatial transformers as one fused CUDA kernel each.

``--trace DIR`` traces every request (``utils.profiling``): it logs one line
a request (host and device ms by span, the counters, the render's pairs kept
of those demanded, the peak device memory), writes the first item's Chrome
trace to ``DIR/trace.json`` and logs that trace's idle device time by span.
"""

from __future__ import annotations

import argparse
import contextlib
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
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="trace every request and write the first item's trace under DIR")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Run the CLI; returns the paths it wrote (rank 0 writes; the other
    ranks of a process group return none)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(levelname)s: %(message)s")

    import torch

    from ..config import load_inference_config
    from ..parallel.mesh import init_distributed, local_device
    from ..utils import profiling
    from ..utils.device import resolve_device
    from ..utils.video_io import save_multiview_video
    from .i2v import I2VPipeline
    from .pipeline import T2VPipeline
    from .sv3d import SV3DPipeline

    device = local_device(str(resolve_device(args.device)))
    rank = init_distributed(device)
    cfg = load_inference_config(args.cfg_file, opts=args.opts or [])
    if args.seed is not None:
        cfg.seed = args.seed
    cfg.debug = args.debug

    task = cfg.get("TASK_TYPE", "inference_text2video_entrance")
    pipes = {"inference_text2video_entrance": T2VPipeline,
             "inference_i2vgen_entrance": I2VPipeline, "inference_sv3d_entrance": SV3DPipeline}
    if task not in pipes:
        raise SystemExit(f"unknown TASK_TYPE {task}")
    is_sv3d = task == "inference_sv3d_entrance"
    is_i2v = task == "inference_i2vgen_entrance" or is_sv3d

    logging.info("torch %s device %s", torch.__version__, device)
    pipe_cls = pipes[task]
    pipe = pipe_cls(cfg, device=device, seed=int(cfg.get("seed", 0)))
    pipe.init_params()

    items = []
    lp = cfg.get("test_list_path")
    if lp and os.path.exists(lp):
        with open(lp) as f:
            items = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    if not items and not is_i2v:
        items = ["a wooden chair"]
    if args.debug:
        items = items[:1]
    if not items:
        raise SystemExit(f"no inputs in {lp}")

    log_dir = cfg.get("log_dir", "workspace/visualization")
    os.makedirs(log_dir, exist_ok=True)
    use_refine = not is_sv3d and bool(cfg.get("UNet", {}).get("use_lgm_refine", False))
    rounds = 1 if args.debug else int(cfg.get("round", 1))
    steps = int(cfg.get("ddim_timesteps", 50))
    fp = bool(cfg.get("frame_parallel", False))
    written = []

    if args.trace:
        profiling.enable()

    def run(item, seed, refine):
        """One request: its output and seconds."""
        t0 = time.time()
        if args.trace and device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        if is_sv3d:
            out = pipe.generate_from_image(item, seed=seed)
        elif is_i2v:
            out = pipe.generate_from_image(item, steps=steps, use_gs_refine=refine, seed=seed,
                                           frame_parallel=fp)
        else:
            out = pipe.generate(item, steps=steps, use_gs_refine=refine, seed=seed,
                                frame_parallel=fp)
        if args.trace:
            log_request(profiling.requests()[-1], device)
        return out, time.time() - t0

    def save(path, frames, caption, seconds):
        """Rank 0 writes (every rank sampled)."""
        if rank == 0:
            t0 = time.time()
            written.append(save_multiview_video(path, frames, caption=caption))
            logging.info("saved %s (%.1fs)", written[-1], seconds + time.time() - t0)

    first = profiling.trace(args.trace) if args.trace else contextlib.nullcontext()
    for r in range(rounds):
        for idx, item in enumerate(items):
            seed = int(cfg.get("seed", 0)) + r
            logging.info("[%d/%d] sampling %r (seed %d)", idx, len(items), item, seed)
            name = os.path.splitext(os.path.basename(item))[0] if is_i2v else item
            cap_name = re.sub(r"[^\w\s]", "", name).replace(" ", "_")[:60]
            stem = os.path.join(log_dir, f"{idx:04d}_{cap_name}_{seed}")
            with first as prof:  # the first item's requests, under the profiler
                out, dt = run(item, seed, refine=False)
                out_gs, dt_gs = run(item, seed, refine=True) if use_refine else (None, 0)
            if prof is not None:
                logging.info("trace of the first item in %s; idle device seconds by span: %s",
                             args.trace, {k: round(v, 4) for k, v in
                                          profiling.idle_by_span(prof).items()})
                first = contextlib.nullcontext()
            save(stem + ".mp4", out["frames"], name, dt)
            if out_gs is not None:
                save(stem + "_gs.mp4", out_gs["frames"], name, dt_gs)
                if bool(cfg.get("save_ply", False)) and not is_i2v and rank == 0:
                    pipe.export_ply(out_gs["frames"], stem + ".ply")
                    written.append(stem + ".ply")
                    logging.info("saved %s", written[-1])
    logging.info("inference complete")
    return written


def log_request(record: dict, device) -> None:
    """One line for a traced request: host and device ms by span, the
    counters, the render's pairs kept of those demanded, the peak memory."""
    from ..utils import profiling

    spans = "; ".join(f"{k} x{v['n']} {v['host_ms']:.1f}/{v['dev_ms']:.1f}"
                      for k, v in profiling.summarize(record).items())
    counts = record["counts"]
    pairs = (f"{counts['splat.pairs_kept']} of {counts['splat.pairs_demanded']}"
             if "splat.pairs_demanded" in counts else "no render")
    peak = profiling.device_memory_stats(device)["peak_bytes_in_use_gb"]
    logging.info("request %d, ms by span (host/device): %s; counters %s; pairs kept %s; "
                 "peak %.2f GiB", record["id"], spans, counts, pairs, peak)


if __name__ == "__main__":
    main()
