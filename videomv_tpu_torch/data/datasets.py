"""Host-side data for training (numpy and Pillow only): the G-Objaverse
multiview render datasets (T2V and I2V), the image-list dataset, the
procedural multiview dataset, batching and the background prefetcher.

A copy of ``videomv_tpu/data/datasets.py``; tests pin the two together.
``GObjaverseVideoDataset`` (reference tools/datasets/video_dataset.py): 24
fixed orbit renders per object, RGBA composited onto grey 128, full-size
frames and masks for the Gaussian supervision, per-view 4×4 camera-to-world
matrices from JSON (flattened to 16, y and z negated), Plücker rays and
colmap cameras from ``prepare_gs``, captions from a cap3d JSON with ", 3d
asset" appended, a failed item skipped. ``GObjaverseI2VDataset`` (reference
video_i2v_dataset.py): the same on white 255, empty captions, the view
sequence rolled by a random azimuth. ``ImageListDataset`` (reference
image_dataset.py): ``path|||caption`` lists, one image padded to the video
shape.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .cameras import GSCameraSettings, get_camera, prepare_gs_training
from .native_loader import load_views

__all__ = ["GObjaverseI2VDataset", "GObjaverseVideoDataset", "ImageListDataset",
           "SyntheticMVDataset", "batch_iterator", "cycle_epochs", "prefetch_host",
           "read_camera_matrix_single"]

logger = logging.getLogger(__name__)


def _load_rgba_on_bg(path: str, bg: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PNG → (rgb float [0, 1] [H, W, 3] composited on ``bg``, mask [H, W, 1])."""
    from PIL import Image

    img = Image.open(path).convert("RGBA")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img).astype(np.float32) / 255.0
    rgb, a = arr[..., :3], arr[..., 3:4]
    return rgb * a + bg / 255.0 * (1.0 - a), a


def read_camera_matrix_single(json_file: str) -> np.ndarray:
    """Per-view camera JSON → 4×4 camera-to-world with the y and z columns
    negated (reference video_dataset.py:16-33)."""
    with open(json_file, "r", encoding="utf8") as f:
        j = json.load(f)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = np.asarray(j["x"], np.float32)
    m[:3, 1] = -np.asarray(j["y"], np.float32)
    m[:3, 2] = -np.asarray(j["z"], np.float32)
    m[:3, 3] = np.asarray(j["origin"], np.float32)
    return m


@dataclass
class GObjaverseVideoDataset:
    """24-view orbit render dataset (reference VideoDataset). Per object:
    ``<root>/<uid>/{00000..00023}/{00000..00023}.png + .json``."""

    data_list: Sequence[str]
    data_dir_list: Sequence[str]
    caption_dir: Optional[str] = None
    resolution: Tuple[int, int] = (256, 256)
    max_frames: int = 24
    background: int = 128
    prepare_lgm: bool = True
    # full-resolution frames and masks for the Gaussian supervision (the
    # reference supervises LGM renders at 512²); 0 falls back to resolution
    gs_full_size: int = 512
    gs_settings: GSCameraSettings = field(default_factory=GSCameraSettings)
    # False when the trainer derives rays and colmap matrices on the device:
    # then only the ground-truth frames and masks are packaged
    prepare_gs_cameras: bool = True
    replica: int = 1000
    seed: int = 0

    def __post_init__(self):
        self.items: List[Tuple[str, str]] = []
        for lst, root in zip(self.data_list, self.data_dir_list):
            if not os.path.exists(lst):
                continue
            with open(lst) as f:
                uids = json.load(f) if lst.endswith(".json") else [line.strip() for line in f]
            for u in uids:
                self.items.append((root, u if isinstance(u, str) else str(u)))
        self.captions = {}
        if self.caption_dir and os.path.exists(self.caption_dir):
            with open(self.caption_dir) as f:
                self.captions = json.load(f)
        self._rng = random.Random(self.seed)

    def __len__(self):
        return len(self.items) * self.replica

    def _load_item(self, idx: int) -> Dict[str, np.ndarray]:
        root, uid = self.items[idx % len(self.items)]
        obj_dir = os.path.join(root, uid)
        pngs, cams = [], []
        for v in range(self.max_frames):
            pngs.append(os.path.join(obj_dir, f"{v:05d}", f"{v:05d}.png"))
            cams.append(read_camera_matrix_single(
                os.path.join(obj_dir, f"{v:05d}", f"{v:05d}.json")).flatten())
        full = self.gs_full_size if (self.prepare_lgm and self.gs_full_size) else 0
        rgb, a, frgb, fa = load_views(pngs, out_size=self.resolution[0],
                                      background=self.background, full_size=full)
        video = rgb.transpose(0, 3, 1, 2)  # [F, 3, H, W]
        mask = a.transpose(0, 3, 1, 2)
        camera = np.stack(cams)  # [F, 16]
        caption = self.captions.get(uid.split("/")[-1], "")
        if caption and "3d asset" not in caption:
            caption = caption + ", 3d asset"
        item = {
            "video": (video * 2.0 - 1.0).astype(np.float32),
            "mask": mask.astype(np.float32),
            "camera_data": camera.astype(np.float32),
            "caption": caption,
        }
        if self.prepare_lgm:
            sup_img = frgb.transpose(0, 3, 1, 2) if frgb is not None else video
            sup_mask = fa.transpose(0, 3, 1, 2) if fa is not None else mask
            item["gs_data"] = self.prepare_gs(camera, sup_img, sup_mask)
        return item

    def prepare_gs(self, camera: np.ndarray, images01: np.ndarray, masks: np.ndarray):
        """Pose canonicalisation, rays and colmap matrices (the training
        chain, reference video_dataset.py:103-144) beside the supervision
        targets ``images01`` [F, 3, R, R] in [0, 1] and ``masks`` [F, 1, R, R]."""
        out = {"images_output": images01.astype(np.float32),
               "masks_output": masks.astype(np.float32)}
        if not self.prepare_gs_cameras:
            return out
        gs = prepare_gs_training(camera[None], self.gs_settings,
                                 ray_size=self.gs_settings.input_size)
        out.update(input=gs["input_rays"][0], cam_view=gs["cam_view"][0],
                   cam_view_proj=gs["cam_view_proj"][0], cam_pos=gs["cam_pos"][0])
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        n = len(self)
        while True:
            try:
                yield self._load_item(i % max(len(self.items), 1))
            except Exception as e:  # noqa: BLE001 - skip-on-error (video_dataset.py:94-96)
                logger.warning("dataset item %d failed (%s); skipping", i, e)
            i += 1
            if i >= n:
                return


@dataclass
class GObjaverseI2VDataset(GObjaverseVideoDataset):
    """I2V variant (reference video_i2v_dataset.py): white-255 background,
    empty captions, the view sequence rolled by a random azimuth drawn from
    the dataset's own ``random.Random`` (video_i2v_dataset.py:196-198), the
    supervision re-canonicalised against the new first view, and that view
    as ``ref_frame``."""

    background: int = 255
    random_roll: bool = True

    def _load_item(self, idx: int) -> Dict[str, np.ndarray]:
        item = super()._load_item(idx)
        item["caption"] = ""
        if self.random_roll:
            shift = self._rng.randrange(self.max_frames)
            for k in ("video", "mask", "camera_data"):
                item[k] = np.roll(item[k], -shift, axis=0)
            if "gs_data" in item:
                # the full-size targets roll with the views; the poses are
                # canonicalised against the new first view
                sup_i = np.roll(item["gs_data"]["images_output"], -shift, axis=0)
                sup_m = np.roll(item["gs_data"]["masks_output"], -shift, axis=0)
                item["gs_data"] = self.prepare_gs(item["camera_data"], sup_i, sup_m)
        item["ref_frame"] = item["video"][0]
        return item


@dataclass
class ImageListDataset:
    """``path|||caption`` list files; each image bilinear-resized to
    ``resolution`` (retried, zero-filled when it never opens) in frame 0 of
    a zero video of ``max_frames`` frames (reference image_dataset.py:14-85)."""

    data_list: Sequence[str]
    data_dir_list: Sequence[str]
    resolution: Tuple[int, int] = (256, 256)
    max_frames: int = 1
    retries: int = 5

    def __post_init__(self):
        self.items: List[Tuple[str, str]] = []
        for lst, root in zip(self.data_list, self.data_dir_list):
            if not os.path.exists(lst):
                continue
            with open(lst) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    parts = line.split("|||")
                    self.items.append((os.path.join(root, parts[0]), parts[-1]))

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        from PIL import Image

        w, h = self.resolution
        for path, caption in self.items:
            arr = None
            for _ in range(self.retries):
                try:
                    img = Image.open(path).convert("RGB").resize(self.resolution, Image.BILINEAR)
                    arr = np.asarray(img).astype(np.float32) / 255.0
                    break
                except (OSError, ValueError):  # unreadable or truncated: retry, then zeros
                    continue
            if arr is None:
                arr = np.zeros((h, w, 3), np.float32)
            video = np.zeros((self.max_frames, 3, h, w), np.float32)
            video[0] = (arr * 2 - 1).transpose(2, 0, 1)
            yield {"video": video, "caption": caption}


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
