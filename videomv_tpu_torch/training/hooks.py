"""In-training visualisation.

Port of ``videomv_tpu/training/hooks.py`` (reference
``VisualTrainTextImageToVideo``, visual_train_it2v_video.py:15-123): every
``viz_interval`` steps the CFG DDIM sampler runs on fixed validation prompts
with the live (or EMA) UNet, and a grid video of the views plus a latent
mosaic per prompt are written. A failure is logged and never reaches the
training loop.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..utils.video_io import save_video_grid

__all__ = ["VisualTrainHook"]

logger = logging.getLogger(__name__)


class VisualTrainHook:
    """Samples validation videos during training through a pipeline from
    ``pipeline_factory`` (built at the first call), whose UNet is the one
    handed to each call: sampled in eval mode, under autocast to
    ``autocast_dtype`` when given (bf16 on the card over fp32 masters), and
    left in the mode it came in."""

    def __init__(self, pipeline_factory: Callable, prompts: Sequence[str], out_dir: str,
                 guide_scale: float = 9.0, steps: int = 50, max_prompts: int = 4,
                 autocast_dtype: Optional[torch.dtype] = None):
        self.pipeline_factory = pipeline_factory
        self.prompts = list(prompts)[:max_prompts]
        self.out_dir = out_dir
        self.guide_scale = guide_scale
        self.steps = steps
        self.autocast_dtype = autocast_dtype
        self._pipe = None

    def __call__(self, step: int, unet: torch.nn.Module) -> Optional[str]:
        """Write ``viz_step_XXXXXXXX`` (and the mosaics) under ``out_dir``;
        returns the written path, or None when nothing was written."""
        was_training = unet.training
        try:
            if self._pipe is None:
                self._pipe = self.pipeline_factory()
            pipe = self._pipe
            pipe.unet = unet.eval()
            autocast = (torch.autocast(device_type=pipe.device.type, dtype=self.autocast_dtype)
                        if self.autocast_dtype is not None else contextlib.nullcontext())
            videos, captions = [], []
            for prompt in self.prompts:
                try:
                    with autocast:
                        out = pipe.generate(prompt, steps=self.steps,
                                            guide_scale=self.guide_scale, seed=step)
                    videos.append(out["frames"])
                    captions.append(prompt)
                    # latent mosaic (visual_train_it2v_video.py:49-62)
                    mosaic = out["latents"][0].transpose(1, 2, 3, 0)[..., :3]
                    mosaic = (mosaic - mosaic.min()) / (np.ptp(mosaic) + 1e-8)
                    self._save_mosaic(mosaic, step, prompt)
                except Exception as e:  # noqa: BLE001 - visualisation never stops training
                    logger.warning("viz failed for %r: %s", prompt, e)
            if not videos:
                return None
            os.makedirs(self.out_dir, exist_ok=True)
            path = save_video_grid(os.path.join(self.out_dir, f"viz_step_{step:08d}.mp4"),
                                   videos, captions)
            logger.info("wrote visualization %s", path)
            return path
        except Exception as e:  # noqa: BLE001 - visualisation never stops training
            logger.warning("viz failed at step %d: %s", step, e)
            return None
        finally:
            unet.train(was_training)

    def _save_mosaic(self, mosaic: np.ndarray, step: int, prompt: str) -> None:
        from PIL import Image

        os.makedirs(self.out_dir, exist_ok=True)
        f, h, w, _ = mosaic.shape
        cols = min(f, 8)
        rows = (f + cols - 1) // cols
        grid = np.zeros((rows * h, cols * w, 3), np.float32)
        for i in range(f):
            r, c = divmod(i, cols)
            grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = mosaic[i]
        name = "".join(ch for ch in prompt[:40] if ch.isalnum() or ch == " ").replace(" ", "_")
        Image.fromarray((grid * 255).astype(np.uint8)).save(
            os.path.join(self.out_dir, f"latents_{step:08d}_{name}.png"))
