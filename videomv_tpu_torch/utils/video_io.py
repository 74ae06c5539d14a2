"""Writing generated views (port of ``videomv_tpu/utils/video_io.py``).

``save_multiview_video`` writes an mp4 through ``imageio`` when it is
installed, else one PNG per view through Pillow, else the raw uint8 array
as ``.npy`` — whichever the machine has. It returns the path it wrote.
``save_video_grid`` puts several such videos side by side under one
caption line (reference video_op.py:46-105).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np

__all__ = ["save_multiview_video", "save_video_grid"]

logger = logging.getLogger(__name__)


def _caption_strip(caption: str, width: int, height: int = 60) -> np.ndarray:
    """White strip with the caption text (reference video_op.py:30-44)."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (width, height), (255, 255, 255))
    ImageDraw.Draw(img).text((8, height // 3), caption[:120], fill=(0, 0, 0))
    return np.asarray(img)


def save_multiview_video(path: str, frames: np.ndarray, caption: Optional[str] = None,
                         fps: int = 8) -> str:
    """frames uint8 [F, H, W, 3] -> ``path`` (mp4), ``<stem>/NNNN.png`` or
    ``<stem>.npy``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    stem = os.path.splitext(path)[0]
    try:
        from PIL import Image  # noqa: F401

        have_pil = True
    except ImportError:
        have_pil = False
    if caption and have_pil:
        strip = _caption_strip(caption, frames.shape[2])
        frames = np.concatenate([np.repeat(strip[None], frames.shape[0], axis=0), frames], axis=1)
    try:
        import imageio

        imageio.mimwrite(path, list(frames), fps=fps, quality=8)
        return path
    except ImportError:
        pass
    except Exception as e:  # noqa: BLE001 - a missing video codec degrades to frames
        logger.warning("mp4 save failed (%s); writing frames instead", e)
    if have_pil:
        from PIL import Image

        os.makedirs(stem, exist_ok=True)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(os.path.join(stem, f"{i:04d}.png"))
        return stem
    np.save(stem + ".npy", frames)
    return stem + ".npy"


def save_video_grid(path: str, videos: Sequence[np.ndarray],
                    captions: Optional[Sequence[str]] = None, fps: int = 8) -> str:
    """uint8 [F, H, W, 3] videos, cut to the shortest, side by side →
    ``save_multiview_video`` with the captions joined by `` | ``."""
    f = min(v.shape[0] for v in videos)
    grid = np.concatenate([v[:f] for v in videos], axis=2)
    return save_multiview_video(path, grid, caption=" | ".join(captions) if captions else None,
                                fps=fps)
