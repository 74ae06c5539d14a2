"""3D-asset export/import: Gaussian-splat PLY save/load (numpy only).

A copy of ``videomv_tpu/ops/ply_io.py``; a test pins the two together. It
mirrors the reference ``GaussianRenderer.save_ply/load_ply``
(core/gs.py:97-185): opacity-pruned (≥0.005), activations
inverted for ``compatible=True`` (logit opacity, log scales, rgb → SH DC
coefficient), binary little-endian PLY with the original 3DGS property
layout (x,y,z, f_dc_0..2, opacity, scale_0..2, rot_0..3). No plyfile
dependency — the format is simple enough for stdlib struct/numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["save_ply", "load_ply"]

_SH_C0 = 0.28209479177387814


def _inverse_sigmoid(x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 1e-7, 1.0 - 1e-7)
    return np.log(x / (1.0 - x))


def save_ply(gaussians, path: str, compatible: bool = True,
             opacity_threshold: float = 0.005) -> int:
    """gaussians [N, 14] or [1, N, 14] → binary PLY. Returns #points kept."""
    g = np.asarray(gaussians, dtype=np.float32)
    if g.ndim == 3:
        if g.shape[0] != 1:
            raise ValueError("only batch size 1 (reference core/gs.py:102)")
        g = g[0]

    mask = g[:, 3] >= opacity_threshold
    g = g[mask]
    xyz = g[:, 0:3]
    opacity = g[:, 3:4]
    scales = g[:, 4:7]
    rots = g[:, 7:11]
    shs = g[:, 11:14]

    if compatible:  # invert activations → original 3DGS ply convention
        opacity = _inverse_sigmoid(opacity)
        scales = np.log(scales + 1e-8)
        shs = (shs - 0.5) / _SH_C0

    names = (
        ["x", "y", "z"]
        + [f"f_dc_{i}" for i in range(3)]
        + ["opacity"]
        + [f"scale_{i}" for i in range(3)]
        + [f"rot_{i}" for i in range(4)]
    )
    data = np.concatenate([xyz, shs, opacity, scales, rots], axis=1).astype("<f4")

    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {data.shape[0]}"]
        + [f"property float {n}" for n in names]
        + ["end_header", ""]
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(data).tobytes())
    return int(data.shape[0])


def load_ply(path: str, compatible: bool = True) -> np.ndarray:
    """Binary 3DGS PLY → gaussians [1, N, 14] in the activated layout."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"end_header\n") + len(b"end_header\n")
    header = raw[:end].decode("ascii").splitlines()
    n = 0
    props = []
    fmt_ok = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt_ok = parts[1] == "binary_little_endian"
        elif parts[0] == "element" and parts[1] == "vertex":
            n = int(parts[2])
        elif parts[0] == "property":
            if parts[1] not in ("float", "float32"):
                raise ValueError(f"unsupported property type {parts[1]}")
            props.append(parts[2])
    if not fmt_ok:
        raise ValueError("only binary_little_endian PLY supported")

    arr = np.frombuffer(raw[end:], dtype="<f4", count=n * len(props)).reshape(
        n, len(props)
    )
    col = {name: arr[:, i] for i, name in enumerate(props)}

    xyz = np.stack([col["x"], col["y"], col["z"]], axis=1)
    opacity = col["opacity"][:, None]
    scale_names = sorted(
        (p for p in props if p.startswith("scale_")), key=lambda s: int(s[6:])
    )
    scales = np.stack([col[p] for p in scale_names], axis=1)
    rot_names = sorted(
        (p for p in props if p.startswith("rot_")), key=lambda s: int(s[4:])
    )
    rots = np.stack([col[p] for p in rot_names], axis=1)
    shs = np.stack([col[f"f_dc_{i}"] for i in range(3)], axis=1)

    g = np.concatenate([xyz, opacity, scales, rots, shs], axis=1).astype(np.float32)
    if compatible:
        g[:, 3:4] = 1.0 / (1.0 + np.exp(-g[:, 3:4]))
        g[:, 4:7] = np.exp(g[:, 4:7])
        g[:, 11:14] = _SH_C0 * g[:, 11:14] + 0.5
    return g[None]
