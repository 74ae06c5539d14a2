"""Host-side data for training: the procedural multiview dataset, batching
and the background prefetcher (numpy only).

A copy of what the LGM-refine finetune needs from
``videomv_tpu/data/datasets.py``; tests pin the two together. The
G-Objaverse and LAION datasets and the native loader come with the UNet
finetune.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .cameras import get_camera

__all__ = ["SyntheticMVDataset", "batch_iterator", "cycle_epochs", "prefetch_host"]


@dataclass
class SyntheticMVDataset:
    """Procedural multiview samples (a coloured disc orbiting on grey) for
    smoke tests and benchmarks: no disk assets needed."""

    resolution: Tuple[int, int] = (256, 256)
    max_frames: int = 24
    seed: int = 0
    camera_distance: float = 2.0
    elevation: float = 15.0

    def sample(self, idx: int) -> Dict[str, np.ndarray]:
        rs = np.random.RandomState(self.seed + idx)
        H = W = self.resolution[0]
        f = self.max_frames
        cam = get_camera(f, elevation=self.elevation, camera_distance=self.camera_distance)
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32) / H - 0.5
        color = rs.rand(3).astype(np.float32)
        frames = []
        for v in range(f):
            phase = 2 * np.pi * v / f
            cx, cy = 0.2 * np.cos(phase), 0.2 * np.sin(phase)
            r2 = (xx - cx) ** 2 + (yy - cy) ** 2
            m = (r2 < 0.08).astype(np.float32)[..., None]
            frames.append(m * color + (1 - m) * 0.5)
        video = np.stack(frames).transpose(0, 3, 1, 2) * 2 - 1
        return {
            "video": video.astype(np.float32),
            "camera_data": cam.astype(np.float32),
            "caption": "a synthetic sphere, 3d asset",
        }

    def __iter__(self):
        i = 0
        while True:
            yield self.sample(i)
            i += 1


def cycle_epochs(dataset) -> Iterator[Dict]:
    """Iterate a re-iterable dataset forever, restarting at each epoch end
    and bumping its ``seed`` (when it has one) for a fresh shuffle order. A
    dataset that yields nothing in an epoch raises."""
    epoch = 0
    while True:
        n = 0
        for item in dataset:
            n += 1
            yield item
        if n == 0:
            raise RuntimeError(
                f"dataset {type(dataset).__name__} yielded no items in epoch {epoch}: "
                "nothing passed decode/filters")
        epoch += 1
        if hasattr(dataset, "seed"):
            try:
                dataset.seed = int(dataset.seed) + 1
            except (TypeError, ValueError):
                pass


def batch_iterator(dataset, batch_size: int, keys: Optional[Sequence[str]] = None):
    """Collate dataset items into stacked numpy batches."""
    buf: List[Dict] = []
    for item in dataset:
        buf.append(item)
        if len(buf) == batch_size:
            batch = {}
            for k in buf[0]:
                if keys and k not in keys:
                    continue
                vals = [b[k] for b in buf]
                if isinstance(vals[0], np.ndarray):
                    batch[k] = np.stack(vals)
                elif isinstance(vals[0], dict):
                    batch[k] = {kk: np.stack([v[kk] for v in vals]) for kk in vals[0]}
                else:
                    batch[k] = vals
            yield batch
            buf = []


def prefetch_host(batches: Iterator[Dict], depth: int = 2) -> Iterator[Dict]:
    """Run a batch iterator in a background thread, keeping ``depth`` host
    batches queued ahead. Exceptions propagate to the consumer. On
    exhaustion, on the generator's ``close()`` or on garbage collection the
    worker is stopped, the queue drained and the thread joined, so no thread
    outlives its loop."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a plain q.put() would block forever once the consumer has left
        # with the queue full
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(b):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 - handed to the training loop
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=5.0)
