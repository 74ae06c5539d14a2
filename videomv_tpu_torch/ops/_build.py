"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Every source is compiled by its own ``nvcc`` call, all started together,
and the objects are linked into one shared library with a plain C
interface, which is loaded with ``ctypes`` (no PyTorch headers, so the
build takes seconds). The library is keyed by a hash of the sources and the
flags, built on first use into ``build/kernels/`` at the repository root, and
reused while the sources are unchanged. ``-Xptxas -v`` is passed so the build log records each
kernel's registers, shared memory and spills (``build_info()["log"]``).

There is no fallback: without ``nvcc``, or when the compiler fails, this
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Optional

__all__ = ["CSRC_DIR", "NVCC_FLAGS", "build_info", "load_library"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_c_longlong = ctypes.c_longlong
# C entry points and their argument types; every pointer and the stream are
# void*, so ctypes never truncates them to 32-bit ints
_SIGNATURES = {
    # q, k, v, o, lse (or null), then B, S, H, D, the scale, variant
    "vmv_flash_attn_fwd": [_c_void_p] * 5 + [_c_int] * 4 + [_c_float, _c_int, _c_void_p],
    # q, k, v, o, lse, dout, delta (scratch), dq, dk, dv, then B, S, H, D, the scale
    "vmv_flash_attn_bwd": [_c_void_p] * 10 + [_c_int] * 4 + [_c_float, _c_void_p],
    # x, w1, b1, w2, b2, out, then T, C, I
    "vmv_geglu_ffn_fwd": [_c_void_p] * 6 + [_c_int] * 3 + [_c_void_p],
    # payload, tile_start, tile_count, order (or null), scratch, out, then R,
    # rows, capacity, n_tiles_side, variant
    "vmv_splat_composite_fwd": [_c_void_p] * 6 + [_c_int] * 5 + [_c_void_p],
    # payload, tile_start, tile_count, saved, grad, order (or null), scratch,
    # dpayload, then R, capacity, n_tiles_side, variant
    "vmv_splat_composite_bwd": [_c_void_p] * 8 + [_c_int] * 4 + [_c_void_p],
    # the culled backward kernel's dynamic shared memory, in bytes
    "vmv_splat_composite_bwd_smem": [],
    # a host array of the device pointers, then R, S, C, L, Cc, heads, inner
    "vmv_fused_spatial_fwd": [_c_void_p] + [_c_int] * 7 + [_c_void_p],
    # x, weight, bias, out, the sample and run strides, then N, C, G, R, P,
    # eps, silu, and the plan: cluster, slice_vecs, res_vecs, threads
    "vmv_group_norm_fwd": [_c_void_p] * 4 + [_c_longlong] * 2 + [_c_int] * 5 + [_c_float]
    + [_c_int] * 5 + [_c_void_p],
    # cluster, res_vecs, threads
    "vmv_group_norm_max_clusters": [_c_int] * 3,
}

BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
_DEFAULT_CUDA_HOME = "/usr/local/cuda"
_lib: Optional[ctypes.CDLL] = None
_info: Dict[str, object] = {}


def _find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), _DEFAULT_CUDA_HOME):
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.path.isfile(cand) and os.access(cand, os.X_OK):
                return cand
    return None


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, hdrs


def _source_hash(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds) -> str:
    """Run the commands concurrently; raise with the output of the first
    that fails. Returns their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def _compile(nvcc: str, srcs, out_path: str) -> str:
    """One ``nvcc -c`` per source, all started together, then one link into
    a temporary file that is moved into place atomically, so concurrent
    builders never load a half-written library."""
    out_dir = os.path.dirname(out_path)
    os.makedirs(out_dir, exist_ok=True)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        log = _run_all([[nvcc, *compile_flags, "-I", CSRC_DIR, "-c", "-o", o, s]
                        for s, o in zip(srcs, objs)])
        lib = os.path.join(tmp, "lib.so")
        log += _run_all([[nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", lib, *objs]])
        os.replace(lib, out_path)
    return log


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use. Raises when it cannot
    be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    srcs, hdrs = _sources()
    key = _source_hash(srcs + hdrs)
    out_path = os.path.join(BUILD_DIR, f"libvideomv_kernels_{key}.so")
    log_path = out_path + ".log"
    t0 = time.time()
    cached = os.path.exists(out_path)
    if not cached:
        nvcc = _find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
                "kernels of videomv_tpu_torch cannot be built")
        log = _compile(nvcc, srcs, out_path)
        with open(log_path, "w") as f:
            f.write(log)
    else:
        log = open(log_path).read() if os.path.exists(log_path) else ""
    lib = ctypes.CDLL(out_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _info.update(path=out_path, cached=cached, seconds=time.time() - t0, log=log)
    _lib = lib
    return lib


def build_info() -> Dict[str, object]:
    """Path, build time (s), whether it was cached, and the nvcc/ptxas log of
    the loaded library (empty before the first ``load_library()``)."""
    return dict(_info)


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
