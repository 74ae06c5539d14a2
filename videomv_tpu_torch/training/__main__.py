"""CLI entry of the port: training on one device, or data-parallel under
``torchrun``.

    python -m videomv_tpu_torch.training --cfg configs/t2v_train.yaml \
        [--debug] [--steps N] [--batch-size B] [--device cuda] [k v ...]
    torchrun --nproc-per-node N -m videomv_tpu_torch.training --cfg ...

Takes the arguments of the JAX package's ``train_net.py`` plus ``--device``.
It runs on the card: without a CUDA device it stops with an error, and
``--device cpu`` is the only way onto the CPU. ``--debug`` limits the run to
3 steps at batch 1. Every shipped training config runs: the plain UNet
finetune (``configs/t2v_train.yaml``; ``configs/t2v_train_tiny.yaml`` at a
small size), the joint LAION finetune (``configs/t2v_train_laion.yaml``, image
steps at f = 1 when its shards exist), the I2V UNet finetune
(``configs/i2vgen_xl_train.yaml``, ``TASK_TYPE: train_i2v_entrance``) and the
LGM-refine finetune behind either denoiser (``UNet.use_lgm_refine True``, or
``configs/lgm_refine_train_tiny.yaml``). Under ``torchrun`` each process
drives ``cuda:LOCAL_RANK`` (NCCL; gloo with ``--device cpu``), the batch is
the global one split over the processes, ``param_sharding: fsdp`` shards the
UNet, and rank 0 logs and writes (``training.engine``).
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="videomv_tpu_torch training")
    p.add_argument("--cfg", dest="cfg_file", default="configs/t2v_train.yaml")
    p.add_argument("--debug", action="store_true", default=False)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked for)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> float:
    """Run the CLI; returns the last step's loss."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="[%(asctime)s] %(levelname)s: %(message)s")

    import torch

    from ..config import load_config
    from ..parallel.mesh import init_distributed, local_device
    from ..utils.device import resolve_device
    from .engine import T2VTrainer

    device = local_device(str(resolve_device(args.device)))
    init_distributed(device)
    cfg = load_config(args.cfg_file, opts=args.opts or [])
    cfg.debug = args.debug
    task = cfg.get("TASK_TYPE", "train_t2v_entrance")
    if task not in ("train_t2v_entrance", "train_i2v_entrance"):
        raise SystemExit(f"unknown TASK_TYPE {task}")
    logging.info("torch %s device %s", torch.__version__, device)

    trainer = T2VTrainer(cfg, device=device).init()
    steps = args.steps if args.steps is not None else (3 if args.debug else None)
    bs = args.batch_size if args.batch_size is not None else (1 if args.debug else None)
    loss = trainer.train(num_steps=steps, batch_size=bs)
    logging.info("training done, final loss %.4f", loss)
    return loss


if __name__ == "__main__":
    main()
