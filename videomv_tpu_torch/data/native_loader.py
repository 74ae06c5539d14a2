"""Multiview PNG decode on the host: ctypes over the repository's C++
loader, with a Pillow path.

A copy of ``videomv_tpu/data/native_loader.py``. ``native/dataio.cpp``
(built as ``native/libmvdataio.so``) decodes the RGBA PNGs of an object's
views, composites them on the background and box-resizes them in C++
worker threads. When the library is absent or does not load, the same
decode runs through Pillow. This is host decode only: nothing here touches
the device.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["LIB_PATH", "load_views", "native_available"]

logger = logging.getLogger(__name__)

LIB_PATH = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native",
                                        "libmvdataio.so"))
_lib = None
_lib_checked = False


def _load_lib():
    """The loaded library, or None (checked once per process)."""
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    if not os.path.exists(LIB_PATH):
        logger.info("native loader not found at %s; using the Pillow path", LIB_PATH)
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
        lib.mv_load_views.restype = ctypes.c_int
        lib.mv_load_views.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.mv_version.restype = ctypes.c_int
        lib.mv_version.argtypes = []
        if lib.mv_version() != 1:
            raise OSError(f"unexpected mv_version {lib.mv_version()}")
    except (OSError, AttributeError) as e:
        logger.warning("failed to load the native loader (%s); using the Pillow path", e)
        return None
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def _float_ptr(a: Optional[np.ndarray]):
    if a is None:
        return ctypes.POINTER(ctypes.c_float)()
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_views(paths: List[str], out_size: int = 256, background: int = 128,
               full_size: int = 0, n_threads: int = 0
               ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """Decode, composite on ``background`` and resize a list of RGBA PNGs:
    (rgb [N, S, S, 3] in [0, 1], mask [N, S, S, 1], and with ``full_size``
    the same at F: full_rgb [N, F, F, 3], full_mask [N, F, F, 1], else None),
    through the library when it loads, else through Pillow. Raises on a
    decode failure (the dataset skips the item)."""
    n = len(paths)
    lib = _load_lib()
    rgb = np.empty((n, out_size, out_size, 3), np.float32)
    mask = np.empty((n, out_size, out_size, 1), np.float32)
    full = np.empty((n, full_size, full_size, 3), np.float32) if full_size else None
    fmask = np.empty((n, full_size, full_size, 1), np.float32) if full_size else None
    if lib is not None:
        names = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        errors = lib.mv_load_views(names, n, out_size, background, _float_ptr(rgb),
                                   _float_ptr(mask), _float_ptr(full), _float_ptr(fmask),
                                   full_size, n_threads)
        if errors:
            raise IOError(f"native loader failed on {errors}/{n} views")
        return rgb, mask, full, fmask

    from PIL import Image

    def one(path, size):
        img = Image.open(path).convert("RGBA")
        if img.size != (size, size):
            img = img.resize((size, size), Image.BILINEAR)
        a = np.asarray(img, np.float32) / 255.0
        return a[..., :3] * a[..., 3:] + (background / 255.0) * (1 - a[..., 3:]), a[..., 3:]

    for i, p in enumerate(paths):
        rgb[i], mask[i] = one(p, out_size)
        if full_size:
            full[i], fmask[i] = one(p, full_size)
    return rgb, mask, full, fmask
