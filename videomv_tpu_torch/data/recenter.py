"""Image recentering for image→multiview inference (Pillow and numpy only).

A copy of ``videomv_tpu/data/recenter.py`` (reference CLI ``python -m
utils.recenter_i2v <dir>``, recenter_i2v.py:25-54): crop the RGBA object to
its alpha bounding box, rescale so that the longer side is ``crop_size``,
paste it centred on a square canvas and composite onto white.

Usage:
    python -m videomv_tpu_torch.data.recenter <input_dir> [output_dir]

writes ``00000.png``, ``00001.png``, ... (the inputs in sorted order) into
``output_dir`` (default ./data/images); an input that cannot be read is
skipped with a message.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np

__all__ = ["add_margin", "main", "recenter_image"]


def add_margin(pil_img, size: int, color=(0, 0, 0, 0)):
    """``pil_img`` pasted centred on a ``size`` × ``size`` canvas of ``color``."""
    from PIL import Image

    width, height = pil_img.size
    result = Image.new(pil_img.mode, (size, size), color)
    result.paste(pil_img, ((size - width) // 2, (size - height) // 2))
    return result


def recenter_image(image_path: str, crop_size: int = 200, image_size: int = 256) -> np.ndarray:
    """RGBA file → recentred float RGB [H, W, 3] in [0, 1] on white. Without
    an alpha channel (or with ``crop_size`` -1) the image is padded square
    and resized instead."""
    from PIL import Image

    img = Image.open(image_path)
    if crop_size != -1 and img.mode == "RGBA":
        alpha = np.asarray(img)[:, :, 3]
        coords = np.stack(np.nonzero(alpha), 1)[:, (1, 0)]
        if coords.size:
            min_x, min_y = coords.min(0)
            max_x, max_y = coords.max(0)
            img = img.crop((min_x, min_y, max_x, max_y))
        h, w = img.height, img.width
        scale = crop_size / max(h, w)
        img = img.resize((int(scale * w), int(scale * h)), resample=Image.BICUBIC)
        img = add_margin(img, size=image_size)
    else:
        img = add_margin(img, size=max(img.height, img.width))
        img = img.resize((image_size, image_size), resample=Image.BICUBIC)

    arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.shape[-1] == 4:
        mask = arr[:, :, 3:]
        arr = arr[:, :, :3] * mask + (1.0 - mask)
    return arr[..., :3]


def main(argv: Optional[list] = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        raise SystemExit("usage: python -m videomv_tpu_torch.data.recenter <input_dir> "
                         "[output_dir]")
    root = argv[0]
    out_dir = argv[1] if len(argv) > 1 else "./data/images"
    os.makedirs(out_dir, exist_ok=True)
    from PIL import Image

    items = sorted(os.path.join(root, p) for p in os.listdir(root))
    for idx, item in enumerate(items):
        try:
            res = recenter_image(item, crop_size=200)
        except (OSError, ValueError) as e:  # not an image Pillow can read
            print(f"skip {item}: {e}")
            continue
        Image.fromarray((res * 255).astype(np.uint8)).save(
            os.path.join(out_dir, f"{idx:05d}.png"))
        print(f"recentered {item} -> {idx:05d}.png")


if __name__ == "__main__":
    main()
