"""LAION tar-shard image reader for joint image/video training (stdlib
``tarfile`` and Pillow).

A copy of ``videomv_tpu/data/laion.py`` (reference LAIONImageDataset,
laion_dataset.py:33-242): shards of (jpg, txt, json) samples filtered by
watermark, safety, aesthetic score, size and aspect (``filter_fake``,
laion_dataset.py:74-103), rescaled and randomly cropped to the training
resolution, shuffled through a bounded buffer, and zero-padded into the
video layout.
"""

from __future__ import annotations

import glob as globlib
import io
import json
import logging
import os
import random
import re
import tarfile
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["LaionFilterConfig", "LaionImageDataset", "expand_shard_spec",
           "interleave_image_video", "iter_tar_samples"]

logger = logging.getLogger(__name__)

_BRACE_RANGE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_shard_spec(spec: str) -> List[str]:
    """A webdataset-style shard spec → the existing files it names: numeric
    brace ranges (``{00000..01000}``, zero padding kept, several groups
    allowed), glob patterns and literal paths."""
    m = _BRACE_RANGE.search(spec)
    if m:
        lo, hi = m.group(1), m.group(2)
        width = len(lo)
        out: List[str] = []
        for i in range(int(lo), int(hi) + 1):
            out.extend(expand_shard_spec(spec[: m.start()] + f"{i:0{width}d}" + spec[m.end():]))
        return out
    if globlib.has_magic(spec):
        return sorted(globlib.glob(spec))
    return [spec] if os.path.exists(spec) else []


@dataclass
class LaionFilterConfig:
    """Metadata filters (reference laion_dataset.py:74-103 thresholds)."""

    max_pwatermark: float = 0.5
    max_punsafe: float = 0.5
    min_aesthetic: float = 4.5
    min_size: int = 128
    max_aspect: float = 2.5

    def accept(self, meta: dict, w: int, h: int) -> bool:
        if meta.get("pwatermark") is not None and meta["pwatermark"] > self.max_pwatermark:
            return False
        if meta.get("punsafe") is not None and meta["punsafe"] > self.max_punsafe:
            return False
        aes = meta.get("aesthetic") or meta.get("AESTHETIC_SCORE")
        if aes is not None and aes < self.min_aesthetic:
            return False
        if min(w, h) < self.min_size:
            return False
        return max(w, h) / max(min(w, h), 1) <= self.max_aspect


def iter_tar_samples(shard_path: str) -> Iterator[Dict[str, bytes]]:
    """Group a tar's members by key prefix into ``{ext: bytes}`` samples."""
    with tarfile.open(shard_path, "r|*") as tf:
        current_key: Optional[str] = None
        sample: Dict[str, bytes] = {}
        for member in tf:
            if not member.isfile() or "." not in member.name:
                continue
            key, ext = member.name.split(".", 1)
            if current_key is not None and key != current_key and sample:
                yield sample
                sample = {}
            current_key = key
            f = tf.extractfile(member)
            if f is not None:
                sample[ext.lower()] = f.read()
        if sample:
            yield sample


@dataclass
class LaionImageDataset:
    """Tar-shard image dataset with filtering, rescale and random crop.
    Yields ``{"video": [F, 3, H, W]`` (the image in frame 0, zeros after),
    ``"caption": str}``."""

    shards: Sequence[str]
    resolution: Tuple[int, int] = (256, 256)
    max_frames: int = 1
    filters: LaionFilterConfig = field(default_factory=LaionFilterConfig)
    shuffle_buffer: int = 256
    seed: int = 0

    def _decode(self, sample: Dict[str, bytes]) -> Optional[Dict]:
        from PIL import Image, UnidentifiedImageError

        img_bytes = sample.get("jpg") or sample.get("jpeg") or sample.get("png")
        if img_bytes is None:
            return None
        try:
            img = Image.open(io.BytesIO(img_bytes)).convert("RGB")
        except (OSError, UnidentifiedImageError):
            return None
        meta = {}
        if "json" in sample:
            try:
                meta = json.loads(sample["json"])
            except ValueError:
                meta = {}
        if not self.filters.accept(meta, img.width, img.height):
            return None
        caption = sample.get("txt", b"").decode("utf-8", "replace").strip()
        # rescale to cover the target, then a random crop
        # (laion_dataset.py:106-182)
        tw, th = self.resolution
        scale = max(tw / img.width, th / img.height)
        img = img.resize((max(tw, int(img.width * scale + 0.5)),
                          max(th, int(img.height * scale + 0.5))))
        x0 = self._rng.randint(0, img.width - tw) if img.width > tw else 0
        y0 = self._rng.randint(0, img.height - th) if img.height > th else 0
        img = img.crop((x0, y0, x0 + tw, y0 + th))
        arr = np.asarray(img, np.float32) / 255.0
        video = np.zeros((self.max_frames, 3, th, tw), np.float32)
        video[0] = (arr * 2 - 1).transpose(2, 0, 1)
        return {"video": video, "caption": caption}

    def __iter__(self):
        self._rng = random.Random(self.seed)
        buf: List[Dict] = []
        for shard in self.shards:
            try:
                samples = iter_tar_samples(shard)
            except (OSError, tarfile.TarError) as e:
                logger.warning("bad shard %s: %s", shard, e)
                continue
            for sample in samples:
                item = self._decode(sample)
                if item is None:
                    continue
                buf.append(item)
                if len(buf) >= self.shuffle_buffer:
                    idx = self._rng.randrange(len(buf))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
        self._rng.shuffle(buf)
        yield from buf


def interleave_image_video(image_iter, video_iter, image_every: int = 4
                           ) -> Iterator[Tuple[str, Dict]]:
    """Whole image steps (f = 1) between video steps, one every
    ``image_every``: yields ``("image", batch)`` at every ``image_every``-th
    step, else ``("video", batch)`` (the homogeneous-step form of the
    reference's per-rank frame_lens, train_t2v_enterance.py:99-103)."""
    step = 0
    while True:
        if image_every and step % image_every == image_every - 1:
            yield "image", next(image_iter)
        else:
            yield "video", next(video_iter)
        step += 1
