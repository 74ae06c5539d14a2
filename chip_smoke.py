"""Smoke test of the PyTorch/CUDA port (videomv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, ~7 minutes

Phases (each prints its lines; a failed phase exits non-zero):
  1. environment: torch/CUDA versions, device, power limit, optional deps;
  2. build: compile csrc/*.cu with nvcc (one process per source, all at
     once), print the ptxas resource lines;
  3. kernels: each CUDA kernel against its plain PyTorch twin at the shapes
     the served and trained paths give it — flash attention and the GEGLU
     FFN in bf16 (error vs an fp32 computation), the splat composite on one
     24-view 256² render call of a 65,536-Gaussian scene, both payloads, and
     on one 2-view 512² chunk of the train step (error vs its twin), the
     composite's backward kernel on the same two calls (error vs its twin,
     relative to the largest gradient), the binned render of one view
     against the dense oracle, and the backward of the attention and FFN
     wrappers against autograd of their twins; CUDA-event times in turns
     plain/kernel/kernel/plain beside each kernel's bound (the larger of its
     bytes over 3.35 TB/s and its operations over the peak rate of their
     type) and, for attention, the time of one
     scaled_dot_product_attention call as a yardstick; launch counters;
  4. unet: one full-width (dim 320) CFG forward at 8 views with seeded
     weights, bf16 with the kernels on the card vs fp32 plain on the host;
  5. refine: one Gaussian-splat refine step (refine_fn) at full width,
     bf16 with the kernels vs fp32 with the plain paths, both on the card,
     end to end and stage by stage on the same inputs;
  6. slice: configs/t2v_infer.yaml as shipped (refine on, shared uncond)
     served at full width, 24 views, 256², 50 DDIM steps, CFG 9.0, bf16 —
     two plain requests, two refined requests (the first of each is
     warm-up), one refined request with full uncond, a PLY export read
     back, then the CLI's main() once;
  7. profile: where a request's time goes — CUDA-event times of a CFG
     forward, the VAE decode, the text encode, the parts of one refine
     step and the LGM's plain head_dim-32 attention, and the device
     kernels of two CFG forwards under torch.profiler by class and name
     (trace written to workspace/profile/);
  8. train: configs/t2v_train.yaml with UNet.use_lgm_refine True at full
     width (frozen UNet, VAE and text tower, LGM big trained, 8 supervision
     views at 512², LPIPS, AdamW) — T2VTrainer takes 3 steps at batch 1 on
     the synthetic dataset with asserted launch counts, finite losses, the
     LGM changed and the frozen towers bit-identical; three more steps by
     parts under CUDA events; the gradient through kernels 3 + 4 against
     their twins, and one step's LGM gradient bf16 with the kernels against
     fp32 plain; a save / restore round trip; the training CLI once.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. There is no CPU fallback: with
no CUDA device the script fails before printing any result.

``--phases env,build,kernels`` runs a subset (for bring-up of one part).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# kernel sources for the JSON record, and the TPU kernels they replace
KERNELS = {
    "flash_attention": dict(
        route="cuda", source="videomv_tpu_torch/csrc/flash_attention.cu",
        replaces="videomv_tpu/ops/flash_attention.py:36"),
    "geglu_ffn": dict(
        route="cuda", source="videomv_tpu_torch/csrc/fused_ffn.cu",
        replaces="videomv_tpu/ops/fused_ffn.py:70"),
    "splat_composite": dict(
        route="cuda", source="videomv_tpu_torch/csrc/splat_composite.cu",
        replaces="videomv_tpu/ops/splat_pallas.py:370"),
    "splat_composite_bwd": dict(
        route="cuda", source="videomv_tpu_torch/csrc/splat_composite_bwd.cu",
        replaces="videomv_tpu/ops/splat_pallas.py:446"),
}
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the peak rate of their type.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
# fp32 operations of the two splat kernels, counted from what this run's data
# needs. At every (pixel, pair) point of a tile's segment alpha is rebuilt to
# find whether the pair is alive there (power <= 0 and alpha >= 1/255): dx, dy
# (2), the quadratic form (5), power (4), exp (1), opacity x exp (1), the 0.99
# clamp (1), the two cuts (2). Only at an alive point does the composite blend
# (alpha x T, four accumulating products, T x (1 - alpha): 11), and only there
# does the backward form its gradient terms (gC.c 7, the running prefix 2,
# max(1 - alpha, 0.01) 2, d alpha 4, the clamp mask 1, d power and d opacity
# 2, the five geometry terms 17, gC x w 4, T x (1 - alpha) 2, and the w of the
# forward 1: 42) and add each of its 10 values into the sum over pixels (10).
SPLAT_POINT_OPS = 16
SPLAT_FWD_ALIVE_OPS = 11
SPLAT_BWD_ALIVE_OPS = 52
# The served paths' kernel shapes with their calls per refined request
# (shared uncond, 50 steps, refine at 20/30/40): 47 CFG forwards at 48 rows
# (attention: 5 spatial blocks per level at 32² and 16²; FFN: spatial +
# temporal blocks per level, plus the init block's 512-wide temporal
# transformer), 3 refine forwards at 24 rows, and 3 LGM forwards (MVAttention
# at head_dim 64: 5 calls at 16², 6 at 8²; its 5 calls at 32² have
# head_dim 32 and stay plain). A plain request is 50 CFG forwards: 500
# attention + 1050 FFN launches.
ATTN_SHAPES = {(48, 1024, 5, 64): 235, (48, 256, 10, 64): 235,
               (24, 1024, 5, 64): 15, (24, 256, 10, 64): 15,
               (1, 1024, 16, 64): 15, (1, 256, 16, 64): 18}
FFN_SHAPES = {(49152, 320, 1280): 470, (12288, 640, 2560): 470, (49152, 512, 2048): 47,
              (24576, 320, 1280): 30, (6144, 640, 2560): 30, (24576, 512, 2048): 3}
# a plain request's launches by shape: the 48-row shapes only
PLAIN_BY_SHAPE = {"flash_attention": {(48, 1024, 5, 64): 250, (48, 256, 10, 64): 250},
                  "geglu_ffn": {(49152, 320, 1280): 500, (12288, 640, 2560): 500,
                                (49152, 512, 2048): 50}}
PLAIN_LAUNCHES = {"flash_attention": 500, "geglu_ffn": 1050, "splat_composite": 0,
                  "splat_composite_bwd": 0}
REFINED_LAUNCHES = {"flash_attention": 533, "geglu_ffn": 1050, "splat_composite": 3,
                    "splat_composite_bwd": 0}
# One LGM-refine train step at batch 1 (configs/t2v_train.yaml with
# UNet.use_lgm_refine True): the frozen UNet's forward at 24 rows without
# grad (5 + 5 attention launches; in training mode its FFN gate is closed),
# the LGM's 11 head_dim-64 attentions once in the checkpointed forward and
# once more in each block's recomputation, and the 8 supervision views at
# 512² in 4 chunks of 2: one composite launch per chunk in the forward, one
# in its recomputation, one backward launch.
TRAIN_ATTN_SHAPES = {(24, 1024, 5, 64): 5, (24, 256, 10, 64): 5,
                     (1, 1024, 16, 64): 10, (1, 256, 16, 64): 12}
TRAIN_LAUNCHES = {"flash_attention": 32, "geglu_ffn": 0, "splat_composite": 8,
                  "splat_composite_bwd": 4}
TRAIN_VIEW_CHUNK, TRAIN_RENDER_SIZE = 2, 512
TRAIN_STEPS = 3
# d loss / d Gaussians through kernels 3 and 4 vs through their twins, on the
# same Gaussians: max |diff| relative to the largest entry (fp32 both)
TRAIN_DGAUSS_TOL = 2e-4
# LGM parameter gradient of one step from the same LGM input, bf16 autocast
# with the kernels vs fp32 with the plain paths: the bf16 LGM moves the seeded
# Gaussians and the render of 65,536 random splats changes at their edges (as
# the refine phase found), so the gradients are held to a direction and a
# size: cosine of the two flattened gradients, and the ratio of their norms
TRAIN_GRAD_MIN_COS = 0.9
TRAIN_GRAD_NORM_RATIO = (0.8, 1.25)
TRAIN_OPTS = ["UNet.use_lgm_refine", "True", "save_ckp_interval", "0",
              "log_dir", "workspace/chip_smoke_train"]
# one refine render: 24 views at 256² of the LGM's 65,536 Gaussians
SPLAT_VIEWS, SPLAT_SIZE, SPLAT_GAUSSIANS = 24, 256, 65536
# kernel error vs fp32 must stay within 2x the plain twin's error + this
KERNEL_EPS = 2e-3
# kernel vs plain twin, max |diff| (both bf16; the twin also rounds its
# logits / first product to bf16)
KERNEL_VS_TWIN_TOL = 5e-2
# splat composite vs its twin, and the binned render vs the dense oracle:
# max |diff| over RGB, alpha and depth (all fp32; a running product against
# exp of a cumulative log sum, up to ~2300 pairs per tile)
SPLAT_TOL = 2e-4
# splat composite backward vs its twin: max |diff| of dpayload relative to the
# largest gradient entry (fp32 both; 256-pixel sums in another order)
SPLAT_BWD_TOL = 2e-4
# attention / FFN backward (autograd.Function) vs autograd through the plain
# twin: the same operations on the same inputs, so the difference is rounding
# of the bf16 upstream gradient at most; relative to the largest entry
TWIN_BWD_TOL = 1e-3
# The dense oracle evaluates a·dx² where the kernel evaluates (a·dx)·dx (as
# the JAX package's two paths do), so at a few (pixel, pair) points alpha
# falls on the other side of the 1/255 cut: a jump of up to 1/255 of the
# value. Against it: max |diff| (depth divided by its maximum) within two
# such jumps, and at most this share of values beyond SPLAT_TOL.
DENSE_JUMP_TOL = 2 / 255 + SPLAT_TOL
DENSE_JUMP_FRAC = 1e-3
# full-width UNet: bf16 card forward vs fp32 host forward, relative max error
UNET_REL_TOL = 5e-2
# One refine step, bf16 with the kernels vs fp32 plain. Each stage on the
# same inputs (teacher forcing): relative max error of its output. The
# seeded LGM (60 layers of random weights) amplifies bf16 rounding more than
# the UNet; the render is held to SPLAT_TOL (kernel vs twin, same Gaussians).
REFINE_STAGE_TOL = {"unet": 5e-2, "vae.decode": 5e-2, "lgm": 2.5e-1,
                    "vae.encode_first_stage": 5e-2}
# End to end the stages' errors chain: the bf16 LGM's Gaussians move by up to
# a few pixels, which changes a render of 65,536 random splats by O(1) at
# their edges, so the largest latent error is O(1) (0.56 with the seeded
# weights on an H100); the refined latents are held to a relative L2 error
# |d|/|ref| instead.
REFINE_L2_TOL = 0.5
PHASES = ("env", "build", "kernels", "unet", "refine", "slice", "profile", "train")


def fail(phase: str, msg: str) -> None:
    print(f"[{phase}] FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def phase_env(torch):
    if not torch.cuda.is_available():
        fail("env", "torch.cuda.is_available() is False: this smoke test needs a CUDA device")
    mods = {}
    for m in ("yaml", "PIL", "imageio"):
        try:
            __import__(m)
            mods[m] = "yes"
        except ImportError:
            mods[m] = "no"
    if mods["yaml"] == "no":
        fail("env", "PyYAML is missing: the config loader needs it")
    # the references below are fp32 and must not silently run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    say("env", f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
        f"deps {mods} tf32 off")
    print(smi, flush=True)
    return smi


def phase_build():
    from videomv_tpu_torch.ops import _build

    try:
        _build.load_library()
    except Exception as e:  # noqa: BLE001 - report the compiler output
        fail("build", f"{type(e).__name__}: {e}")
    info = _build.build_info()
    ptxas = [ln.strip() for ln in str(info["log"]).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        print(f"  {ln}", flush=True)
    say("build", f"{info['path']} in {info['seconds']:.1f}s (cached={info['cached']})")


def _time_turns(torch, plain, kernel, iters=20):
    """CUDA-event ms per call, in turns plain, kernel, kernel, plain."""
    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    for fn in (plain, kernel):
        fn()
        fn()
    torch.cuda.synchronize()
    p1, k1, k2, p2 = run(plain), run(kernel), run(kernel), run(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _bound(n_bytes, ops, peak_ops):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move ``n_bytes`` and do ``ops`` operations of the type whose
    peak rate is ``peak_ops``."""
    by_bytes, by_ops = 1e3 * n_bytes / PEAK_BYTES_S, 1e3 * ops / peak_ops
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def _attn_bound(shape):
    b, s, h, d = shape  # q, k, v read and out written in bf16; QK^T and PV
    return _bound(4 * b * s * h * d * 2, 4 * b * h * s * s * d, PEAK_BF16_FLOPS)


def _ffn_bound(t, c, inner):
    n_bytes = 2 * (2 * t * c + 3 * c * inner) + 4 * (2 * inner + c)
    return _bound(n_bytes, 6 * t * c * inner, PEAK_BF16_FLOPS)


def _splat_alive_points(torch, payload, tile_start, tile_count, nts, block=1 << 18):
    """How many (pixel, pair) points of this binned render call are alive
    (power <= 0 and alpha >= 1/255, the twin's ``~dead``), counted from the
    payload and the segments in one pass: each in-segment pair against the
    256 pixels of its tile. The in-segment points are 256 x tile_count.sum()."""
    from videomv_tpu_torch.ops import splat

    R, rows, _ = payload.shape
    dev = payload.device
    pix = torch.arange(splat.TILE * splat.TILE, device=dev)
    ox, oy = (pix % splat.TILE).float(), (pix // splat.TILE).float()
    alive = 0
    for r in range(R):
        # segments lie back to back from pair 0 in tile order
        ends = (tile_start[r] + tile_count[r]).long()
        n = int(ends[-1])
        for a in range(0, n, block):
            idx = torch.arange(a, min(a + block, n), device=dev)
            tile = torch.searchsorted(ends, idx, right=True)
            d = payload[r, :, a:a + idx.numel()]
            op = splat._unpack2(d[6])[1] if rows == 8 else d[8]
            dx = (tile % nts * splat.TILE).float()[:, None] + ox - d[0][:, None]
            dy = (tile // nts * splat.TILE).float()[:, None] + oy - d[1][:, None]
            power = (-0.5 * (d[2][:, None] * dx * dx + d[4][:, None] * dy * dy)
                     - d[3][:, None] * dx * dy)
            alpha = torch.clamp_max(op[:, None] * torch.exp(power), 0.99)
            alive += int(((power <= 0.0) & (alpha >= 1.0 / 255.0)).sum())
    return alive


def _splat_bound(views, rows, capacity, tiles, live_pairs, alive_points, backward=False):
    """The composite reads each live pair's payload rows once, the tile
    lists, and writes [views, tiles, 5, 256]; the backward reads the 10 live
    rows and two such tile tensors and writes all of dpayload
    [views, 16, capacity]. Operations follow this run's data: every point of
    a segment rebuilds alpha, only the alive points blend or form gradients."""
    out_bytes = views * tiles * 5 * 256 * 4
    lists = 2 * views * tiles * 4
    points = live_pairs * 256
    if backward:
        n_bytes = live_pairs * 10 * 4 + lists + 2 * out_bytes + views * 16 * capacity * 4
        return _bound(n_bytes, points * SPLAT_POINT_OPS + alive_points * SPLAT_BWD_ALIVE_OPS,
                      PEAK_FP32_FLOPS)
    return _bound(live_pairs * rows * 4 + lists + out_bytes,
                  points * SPLAT_POINT_OPS + alive_points * SPLAT_FWD_ALIVE_OPS,
                  PEAK_FP32_FLOPS)


def _time_one(torch, fn, iters=20):
    """CUDA-event ms per call of ``fn`` after two warm-up calls."""
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _synthetic_scene(torch, dev, size=SPLAT_SIZE, views=SPLAT_VIEWS):
    """A seeded scene of SPLAT_GAUSSIANS Gaussians (inside the unit cube,
    scales 0.003-0.012, so about 190k live pairs per view at 256², under the
    294,912 capacity) and ``views`` orbit splat cameras at ``size``² (the
    pipeline's 24 at 256² by default)."""
    import numpy as np

    from videomv_tpu_torch.data.cameras import (
        GSCameraSettings, orbit_c2w_opengl, prepare_gs_training)

    n = SPLAT_GAUSSIANS
    rs = np.random.default_rng(0)
    quat = rs.normal(size=(n, 4))
    g = np.concatenate([rs.uniform(-0.5, 0.5, (n, 3)), rs.uniform(0.05, 1.0, (n, 1)),
                        rs.uniform(0.003, 0.012, (n, 3)),
                        quat / np.linalg.norm(quat, axis=1, keepdims=True),
                        rs.uniform(0, 1, (n, 3))], axis=1).astype(np.float32)
    st = GSCameraSettings(input_size=size, output_size=size)
    cams = prepare_gs_training(orbit_c2w_opengl(views, 15.0, 2.0), st, ray_size=8)
    return (torch.from_numpy(g).to(dev)[None], torch.from_numpy(cams["cam_view"]).to(dev),
            torch.from_numpy(cams["cam_view_proj"]).to(dev), st.tan_half_fov)


def _splat_kernel_checks(torch, dev):
    """Kernel 3 against its twin on one 24-view render call (both payloads)
    and on one view chunk of the train step, the binned render of one view
    against the dense oracle, and kernel 4 against its twin on the same two
    calls. Returns the forward's and the backward's runs."""
    from videomv_tpu_torch import ops
    from videomv_tpu_torch.ops import gaussian_splat as tgs
    from videomv_tpu_torch.ops import splat

    g, cv, cvp, tan = _synthetic_scene(torch, dev)
    cap = tgs.pair_capacity(SPLAT_GAUSSIANS, SPLAT_SIZE)
    nts = SPLAT_SIZE // splat.TILE
    prep = {k: v[:, None] for k, v in tgs.prepare_gaussians(g).items()}
    proj = [p[0] for p in tgs.project_prepared(prep, cv, cvp, SPLAT_SIZE, tan)]
    runs = []
    for packed in (True, False):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        payload, ts, tc, pairs = splat.bin_pairs(*proj, img_size=SPLAT_SIZE, max_pairs=cap,
                                                 packed=packed)
        torch.cuda.synchronize()
        bin_s = time.perf_counter() - t0
        bin_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        pairs = pairs.tolist()
        if max(pairs) > cap:
            fail("kernels", f"synthetic scene overflows the capacity {cap}: {pairs}")
        ops.reset_launch_counts()
        kern = splat.composite(payload, ts, tc, nts)
        torch.cuda.synchronize()
        if ops.launch_counts()["splat_composite"] != 1:
            fail("kernels", "splat composite: launch counter did not move")
        twin = splat.composite_reference(payload, ts, tc, nts)
        err = (kern - twin).abs().max().item()
        ms, plain_ms = _time_turns(torch, lambda: splat.composite_reference(payload, ts, tc, nts),
                                   lambda: splat.composite(payload, ts, tc, nts), iters=3)
        ok = err <= SPLAT_TOL
        rows = payload.shape[1]
        alive = _splat_alive_points(torch, payload, ts, tc, nts)
        bound_ms, bound_by = _splat_bound(SPLAT_VIEWS, rows, cap, nts * nts, sum(pairs), alive)
        runs.append(dict(shape=[SPLAT_VIEWS, rows, cap], calls_per_request=3 if packed else 0,
                         calls_per_train_step=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                         live_pairs=[min(pairs), sum(pairs) // len(pairs), max(pairs)],
                         alive_points=alive, alive_share=alive / (256 * sum(pairs)),
                         capacity=cap, max_tile_pairs=int(tc.max())))
        say("kernels", f"splat_composite {rows}-row payload, {SPLAT_VIEWS} views x {nts ** 2} "
            f"tiles, {SPLAT_GAUSSIANS} Gaussians: live pairs per view min/mean/max "
            f"{min(pairs)}/{sum(pairs) // len(pairs)}/{max(pairs)} of capacity {cap}, "
            f"max pairs per tile {int(tc.max())}, alive (pixel, pair) points {alive} = "
            f"{100 * alive / (256 * sum(pairs)):.2f}% of the segments' points; binning "
            f"{bin_s * 1e3:.1f} ms, peak "
            f"{bin_gib:.3f} GiB; |k-twin| {err:.3e} (bound {SPLAT_TOL:.0e}) kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("kernels", f"splat composite ({rows} rows) outside its error bound")
        if not packed:
            bwd_runs = [_splat_bwd_check(torch, payload, ts, tc, kern, nts, sum(pairs), alive,
                                         f"{SPLAT_VIEWS} views at {SPLAT_SIZE}²", 0)]
        del payload, ts, tc, kern, twin
    # the binned render (kernel, fp32 payload) against the dense oracle, view 0
    bg = torch.tensor([0.3, 0.5, 0.7], device=dev)
    binned = splat.rasterize_binned_batch(g, cv[:, :1], cvp[:, :1], SPLAT_SIZE, tan, bg,
                                          max_pairs=cap)
    dense = tgs.rasterize_dense(g[0], cv[0, 0], cvp[0, 0], SPLAT_SIZE, tan, bg, chunk=512,
                                tile=SPLAT_SIZE)
    depth_scale = dense[2].abs().max()
    diff = torch.cat([(binned["image"][0, 0] - dense[0]).flatten(),
                      (binned["alpha"][0, 0] - dense[1]).flatten(),
                      ((binned["depth"][0, 0] - dense[2]) / depth_scale).flatten()]).abs()
    err, frac = diff.max().item(), (diff > SPLAT_TOL).float().mean().item()
    ok = err <= DENSE_JUMP_TOL and frac <= DENSE_JUMP_FRAC
    say("kernels", f"splat binned render vs dense oracle, view 0 at {SPLAT_SIZE}²: max|d| "
        f"{err:.3e} over image/alpha/depth÷{depth_scale.item():.3f} (bound "
        f"{DENSE_JUMP_TOL:.2e}), share above {SPLAT_TOL:.0e} {frac:.2e} (bound "
        f"{DENSE_JUMP_FRAC:.0e}), alpha max {dense[1].max().item():.3f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("kernels", "binned render outside its bound of the dense oracle")
    runs[0].update(dense_max_abs_err=err, dense_share_above_tol=frac)
    del g, cv, cvp, proj, prep, binned, dense

    # one view chunk of the train step: TRAIN_VIEW_CHUNK views at 512², the
    # 16-row payload, forward and backward (pairs beyond the capacity, the
    # deepest, are dropped as on the main path)
    size, views = TRAIN_RENDER_SIZE, TRAIN_VIEW_CHUNK
    g, cv, cvp, tan = _synthetic_scene(torch, dev, size=size, views=views)
    cap = tgs.pair_capacity(SPLAT_GAUSSIANS, size)
    nts = size // splat.TILE
    prep = {k: v[:, None] for k, v in tgs.prepare_gaussians(g).items()}
    proj = [p[0] for p in tgs.project_prepared(prep, cv, cvp, size, tan)]
    payload, ts, tc, pairs = splat.bin_pairs(*proj, img_size=size, max_pairs=cap)
    live = int(tc.sum())
    kern = splat.composite(payload, ts, tc, nts)
    twin = splat.composite_reference(payload, ts, tc, nts)
    err = (kern - twin).abs().max().item()
    ms, plain_ms = _time_turns(torch, lambda: splat.composite_reference(payload, ts, tc, nts),
                               lambda: splat.composite(payload, ts, tc, nts), iters=3)
    alive = _splat_alive_points(torch, payload, ts, tc, nts)
    bound_ms, bound_by = _splat_bound(views, 16, cap, nts * nts, live, alive)
    ok = err <= SPLAT_TOL
    runs.append(dict(shape=[views, 16, cap], calls_per_request=0,
                     calls_per_train_step=TRAIN_LAUNCHES["splat_composite"], max_abs_err=err,
                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=None, live_pairs=[live // views], alive_points=alive,
                     alive_share=alive / (256 * live), capacity=cap,
                     max_tile_pairs=int(tc.max())))
    say("kernels", f"splat_composite 16-row payload, {views} views at {size}² x {nts ** 2} "
        f"tiles: demanded pairs per view {pairs.tolist()}, live {live} of capacity "
        f"{views} x {cap}, max pairs per tile {int(tc.max())}, alive (pixel, pair) points "
        f"{alive} = {100 * alive / (256 * live):.2f}% of the segments' points; |k-twin| "
        f"{err:.3e} (bound "
        f"{SPLAT_TOL:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
        f"({bound_by}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("kernels", "splat composite (512²) outside its error bound")
    bwd_runs.append(_splat_bwd_check(torch, payload, ts, tc, kern, nts, live, alive,
                                     f"{views} views at {size}²",
                                     TRAIN_LAUNCHES["splat_composite_bwd"]))
    return runs, bwd_runs


def _splat_bwd_check(torch, payload, ts, tc, saved, nts, live_pairs, alive_points, what,
                     calls_per_step):
    """Kernel 4 against its twin on a binned render call: dpayload from the
    same payload, segments, forward output and a seeded gradient."""
    from videomv_tpu_torch import ops
    from videomv_tpu_torch.ops import splat

    gen = torch.Generator(device=payload.device).manual_seed(4)
    grad = torch.randn(saved.shape, generator=gen, device=payload.device)
    ops.reset_launch_counts()
    kern = splat.composite_backward(payload, ts, tc, saved, grad, nts)
    torch.cuda.synchronize()
    if ops.launch_counts()["splat_composite_bwd"] != 1:
        fail("kernels", "splat composite backward: launch counter did not move")
    twin = splat.composite_backward_reference(payload, ts, tc, saved, grad, nts)
    scale = twin.abs().max().item()
    err = (kern - twin).abs().max().item()
    by_row = [((kern[:, r] - twin[:, r]).abs().max() / twin[:, r].abs().max().clamp_min(1e-30))
              .item() for r in range(10)]
    dead = kern[:, 10:].abs().max().item()
    # through autograd (the Function the render path uses) the same gradient
    p = payload.clone().requires_grad_()
    (auto,) = torch.autograd.grad(splat.composite(p, ts, tc, nts), p, grad)
    same = torch.equal(auto, kern)
    del twin, p, auto
    ms, plain_ms = _time_turns(
        torch, lambda: splat.composite_backward_reference(payload, ts, tc, saved, grad, nts),
        lambda: splat.composite_backward(payload, ts, tc, saved, grad, nts), iters=2)
    R, rows, cap = payload.shape
    bound_ms, bound_by = _splat_bound(R, rows, cap, nts * nts, live_pairs, alive_points,
                                      backward=True)
    ok = err <= SPLAT_BWD_TOL * scale and dead == 0.0 and same
    say("kernels", f"splat_composite_bwd {what}, {live_pairs} live pairs, {alive_points} alive "
        f"(pixel, pair) points: max|k-twin| "
        f"{err:.3e} of max|grad| {scale:.3e} = {err / scale:.3e} (bound {SPLAT_BWD_TOL:.0e}); "
        f"by row, relative to the row's largest: {['%.1e' % e for e in by_row]}; rows "
        f"10-15 max {dead:.1e}; autograd path bit-identical {same}; kernel {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("kernels", f"splat composite backward ({what}) outside its error bound")
    return dict(shape=[R, rows, cap], calls_per_request=0, calls_per_train_step=calls_per_step,
                max_abs_err=err, rel_err=err / scale, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, live_pairs=live_pairs,
                alive_points=alive_points, alive_share=alive_points / (256 * live_pairs))


def phase_kernels(torch):
    from videomv_tpu_torch import ops
    from videomv_tpu_torch.ops.flash_attention import attention_reference, flash_attention
    from videomv_tpu_torch.ops.fused_ffn import geglu_ffn, geglu_ffn_reference

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    results = {"flash_attention": [], "geglu_ffn": []}

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def errs(kern, twin, ref32):
        k_err = (kern.float() - ref32).abs().max().item()
        t_err = (twin.float() - ref32).abs().max().item()
        kt = (kern.float() - twin.float()).abs().max().item()
        return k_err, t_err, kt

    def rel_max(got, want):
        return max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
                   for g, w in zip(got, want))

    import torch.nn.functional as F

    for shape in ATTN_SHAPES:
        q, k, v = (randn(*shape) for _ in range(3))
        ops.reset_launch_counts()
        kern = flash_attention(q, k, v)
        torch.cuda.synchronize()
        if ops.launch_counts()["flash_attention"] != 1:
            fail("kernels", f"attention {shape}: launch counter did not move")
        twin = attention_reference(q, k, v)
        ref32 = attention_reference(q.float(), k.float(), v.float())
        k_err, t_err, kt = errs(kern, twin, ref32)
        ms, plain_ms = _time_turns(torch, lambda: attention_reference(q, k, v),
                                   lambda: flash_attention(q, k, v))
        ok = k_err <= 2 * t_err + KERNEL_EPS and kt <= KERNEL_VS_TWIN_TOL
        # the yardstick: one library call for the same function (the port
        # never calls it); it takes [B, H, S, D]
        qt, kt_, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib_err = (F.scaled_dot_product_attention(qt, kt_, vt).transpose(1, 2).float()
                   - ref32).abs().max().item()
        library_ms = _time_one(torch, lambda: F.scaled_dot_product_attention(qt, kt_, vt))
        bound_ms, bound_by = _attn_bound(shape)
        results["flash_attention"].append(dict(
            shape=list(shape), calls_per_request=ATTN_SHAPES[shape],
            calls_per_train_step=TRAIN_ATTN_SHAPES.get(shape, 0), err_vs_fp32=k_err,
            twin_err_vs_fp32=t_err, max_abs_err=kt, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms))
        say("kernels", f"flash_attention {list(shape)}: |k-fp32| {k_err:.3e} "
            f"|twin-fp32| {t_err:.3e} |k-twin| {kt:.3e} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) library call "
            f"(scaled_dot_product_attention) {library_ms:.4f} ms, its |fp32| error "
            f"{lib_err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("kernels", f"flash_attention {shape} outside its error bound")
        del q, k, v, kern, twin, ref32, qt, kt_, vt

    # backward through the autograd.Function (kernel forward, twin recompute)
    # against autograd through the twin alone, at the LGM's trained shapes
    for shape in ((1, 1024, 16, 64), (1, 256, 16, 64)):
        q, k, v = (randn(*shape).requires_grad_() for _ in range(3))
        go = randn(*shape)
        ops.reset_launch_counts()
        got = torch.autograd.grad(flash_attention(q, k, v), (q, k, v), go)
        if ops.launch_counts()["flash_attention"] != 1:
            fail("kernels", f"attention backward {shape}: the forward did not launch")
        want = torch.autograd.grad(attention_reference(q, k, v), (q, k, v), go)
        err = rel_max(got, want)
        say("kernels", f"flash_attention backward {list(shape)}: dq, dk, dv vs autograd of "
            f"the twin, relative max {err:.3e} (bound {TWIN_BWD_TOL:.0e}) "
            f"{'ok' if err <= TWIN_BWD_TOL else 'FAIL'}")
        if not err <= TWIN_BWD_TOL:
            fail("kernels", f"flash_attention backward {shape} differs from its twin's")
        del q, k, v, go, got, want

    for t, c, inner in FFN_SHAPES:
        x = randn(t, c)
        w1 = randn(2 * inner, c, scale=c ** -0.5)
        w2 = randn(c, inner, scale=inner ** -0.5)
        b1 = randn(2 * inner, scale=0.1, dtype=torch.float32)
        b2 = randn(c, scale=0.1, dtype=torch.float32)
        ops.reset_launch_counts()
        kern = geglu_ffn(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        if ops.launch_counts()["geglu_ffn"] != 1:
            fail("kernels", f"ffn {(t, c, inner)}: launch counter did not move")
        twin = geglu_ffn_reference(x, w1, b1, w2, b2)
        ref32 = geglu_ffn_reference(x.float(), w1.float(), b1, w2.float(), b2)
        k_err, t_err, kt = errs(kern, twin, ref32)
        ms, plain_ms = _time_turns(torch, lambda: geglu_ffn_reference(x, w1, b1, w2, b2),
                                   lambda: geglu_ffn(x, w1, b1, w2, b2))
        ok = k_err <= 2 * t_err + KERNEL_EPS and kt <= KERNEL_VS_TWIN_TOL
        bound_ms, bound_by = _ffn_bound(t, c, inner)
        results["geglu_ffn"].append(dict(
            shape=[t, c, inner], calls_per_request=FFN_SHAPES[(t, c, inner)],
            calls_per_train_step=0, err_vs_fp32=k_err, twin_err_vs_fp32=t_err,
            max_abs_err=kt, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None))
        say("kernels", f"geglu_ffn [T={t}, C={c}, I={inner}]: |k-fp32| {k_err:.3e} "
            f"|twin-fp32| {t_err:.3e} |k-twin| {kt:.3e} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("kernels", f"geglu_ffn {(t, c, inner)} outside its error bound")
        if (t, c, inner) == (24576, 320, 1280):  # the backward, once
            args = [a.clone().requires_grad_() for a in (x, w1, b1, w2, b2)]
            go = randn(t, c)
            ops.reset_launch_counts()
            got = torch.autograd.grad(geglu_ffn(*args), args, go)
            if ops.launch_counts()["geglu_ffn"] != 1:
                fail("kernels", "ffn backward: the forward did not launch")
            want = torch.autograd.grad(geglu_ffn_reference(*args), args, go)
            err = rel_max(got, want)
            say("kernels", f"geglu_ffn backward [T={t}, C={c}, I={inner}]: dx, dw1, db1, dw2, "
                f"db2 vs autograd of the twin, relative max {err:.3e} (bound "
                f"{TWIN_BWD_TOL:.0e}) {'ok' if err <= TWIN_BWD_TOL else 'FAIL'}")
            if not err <= TWIN_BWD_TOL:
                fail("kernels", "geglu_ffn backward differs from its twin's")
            del args, go, got, want
        del x, w1, w2, b1, b2, kern, twin, ref32
    results["splat_composite"], results["splat_composite_bwd"] = _splat_kernel_checks(torch, dev)
    torch.cuda.empty_cache()
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ",".join(PHASES))
    args = p.parse_args(argv)
    phases = [s for s in args.phases.split(",") if s]
    unknown = set(phases) - set(PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")

    sys.path.insert(0, ROOT)
    import torch

    smi = phase_env(torch)
    if "build" in phases or "kernels" in phases:
        phase_build()
    kernel_results = phase_kernels(torch) if "kernels" in phases else {}
    # kernel -> launches of one plain request, one refined request, one train
    # step: each counted with the counters reset just before that path ran
    train_run = f"train run of {TRAIN_STEPS} steps"
    by_path = {"plain request": {}, "refined request": {}, train_run: {}}
    if "unet" in phases:
        phase_unet(torch)
    if "refine" in phases:
        phase_refine(torch)
    if "slice" in phases:
        by_path["plain request"], by_path["refined request"] = phase_slice(torch)
    if "profile" in phases:
        phase_profile(torch)
    if "train" in phases:
        by_path[train_run] = phase_train(torch)

    # One entry per kernel. ms, plain_ms, bound_ms and library_ms are totals
    # over one run of the path named in "path": each shape's time per call
    # (kernels phase) times its calls on that path. The attention kernel and
    # the two splat kernels are totalled over the train run, the FFN kernel
    # (which a train step does not launch) over a refined request. launches
    # is the count read after that path ran (null unless its phase ran).
    record = []
    for name, runs in kernel_results.items():
        if name == "geglu_ffn":
            path, calls, times = "refined request", "calls_per_request", 1
        else:
            path, calls, times = train_run, "calls_per_train_step", TRAIN_STEPS
        used = [r for r in runs if r[calls]]

        def total(field):
            if any(r[field] is None for r in used):
                return None
            return times * sum(r[field] * r[calls] for r in used)

        if by_path[path] and not by_path[path].get(name):
            fail("kernels", f"{name} was launched no time on its path ({path})")
        top = max(used, key=lambda r: r["bound_ms"] * r[calls])
        record.append(dict(
            name=name, **KERNELS[name], launches=by_path[path].get(name), path=path,
            launches_by_path={k: v.get(name) for k, v in by_path.items()},
            max_abs_err=max(r["max_abs_err"] for r in runs), ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"), bound_by=top["bound_by"],
            library_ms=total("library_ms"), shapes=runs))
    print(smi, flush=True)
    print(json.dumps({"kernels": record}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def _host_unet(torch):
    """The shipped UNet (configs/t2v_infer.yaml widths) with seeded weights,
    fp32 on the host; built once and shared by the later phases."""
    global _HOST_UNET
    if _HOST_UNET is None:
        from videomv_tpu_torch.config import load_inference_config
        from videomv_tpu_torch.inference.pipeline import unet_kwargs_from_cfg
        from videomv_tpu_torch.models import UNetSD_T2VBase
        from videomv_tpu_torch.training.checkpoints import init_weights

        cfg = load_inference_config(os.path.join(ROOT, "configs", "t2v_infer.yaml"))
        with torch.device("meta"):
            unet = UNetSD_T2VBase(**unet_kwargs_from_cfg(cfg.UNet))
        _HOST_UNET = init_weights(unet, seed=0, zero_init=False, device="cpu").eval()
        _HOST_UNET.requires_grad_(False)
    return _HOST_UNET


_HOST_UNET = None
# seeds of the other models' numpy init
_SEEDS = {"vae": 1, "clip": 2, "lgm": 3}


def _pipeline(torch):
    """The pipeline of configs/t2v_infer.yaml as shipped (no override), on the
    card in bf16 with seeded weights; built once and shared by the refine,
    slice and profile phases."""
    global _PIPE
    if _PIPE is None:
        from videomv_tpu_torch.config import load_inference_config
        from videomv_tpu_torch.inference import T2VPipeline
        from videomv_tpu_torch.training.checkpoints import init_weights

        os.chdir(ROOT)  # the configs' relative paths (prompts, log_dir)
        pipe = T2VPipeline(load_inference_config("configs/t2v_infer.yaml"), device="cuda")
        if pipe.lgm is None:
            fail("slice", "configs/t2v_infer.yaml no longer sets UNet.use_lgm_refine")
        for name, seed in _SEEDS.items():
            init_weights(pipe.models[name], seed=seed, zero_init=False, device=pipe.device)
        pipe.load_state_dicts(unet=_host_unet(torch).state_dict())  # casts all to bf16
        _PIPE = pipe
    return _PIPE


_PIPE = None


def phase_unet(torch):
    """One CFG forward of the full-width UNet at 8 views: bf16 on the card
    (through the kernels) against fp32 on the host (plain path)."""
    import copy

    import numpy as np

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.data.cameras import orbit_camera_for_t2v

    t0 = time.time()
    host = _host_unet(torch)
    card = copy.deepcopy(host).to(device="cuda", dtype=torch.bfloat16)
    rs = np.random.default_rng(0)
    f = 8
    x = rs.standard_normal((1, 4, f, 32, 32)).astype(np.float32)
    y = rs.standard_normal((1, 77, 1024)).astype(np.float32)
    zero_y = rs.standard_normal((1, 77, 1024)).astype(np.float32)
    cam = orbit_camera_for_t2v(f)
    args = [torch.from_numpy(np.concatenate(p)) for p in ((x, x), (y, zero_y), (cam, cam))]
    t = torch.tensor([981, 981])
    with torch.no_grad():
        ops.reset_launch_counts()
        out_card = card(args[0].cuda(), t.cuda(), y=args[1].cuda(), camera_data=args[2].cuda())
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        torch.set_num_threads(os.cpu_count() or 1)
        out_host = host(args[0], t, y=args[1], camera_data=args[2])
    out_card = out_card.cpu()
    if not torch.isfinite(out_card).all():
        fail("unet", "non-finite output on the card")
    rel = ((out_card - out_host).abs().max() / out_host.abs().max()).item()
    say("unet", f"dim 320 x (1,2,4,4), 8 views, CFG rows 2: bf16 card vs fp32 host "
        f"max|d|/max|ref| {rel:.3e} (bound {UNET_REL_TOL:.0e}), max|ref| "
        f"{out_host.abs().max().item():.3e}, launches {counts}, {time.time() - t0:.1f}s")
    if counts != {"flash_attention": 10, "geglu_ffn": 21, "splat_composite": 0,
                  "splat_composite_bwd": 0}:
        fail("unet", f"expected 10 attention + 21 FFN launches, got {counts}")
    if not rel <= UNET_REL_TOL:
        fail("unet", f"relative error {rel:.3e} above {UNET_REL_TOL}")
    del card
    torch.cuda.empty_cache()


class _Recorder:
    """Stands in for a model and keeps the arguments and the result of its
    calls (and of the named methods' calls), by name."""

    def __init__(self, module, log, name, methods=()):
        self._m, self._log, self._name, self._methods = module, log, name, methods

    def __call__(self, *a, **k):
        out = self._m(*a, **k)
        self._log[self._name] = (a, out)
        return out

    def __getattr__(self, attr):
        fn = getattr(self._m, attr)
        if attr not in self._methods:
            return fn

        def call(*a, **k):
            out = fn(*a, **k)
            self._log[f"{self._name}.{attr}"] = (a, out)
            return out
        return call


class _PairLog:
    """Within ``with``, keeps the demanded pair counts per view of every
    binned render (``bin_pairs``' fourth output) in ``renders``."""

    def __init__(self):
        self.renders = []

    def __enter__(self):
        from videomv_tpu_torch.ops import splat

        self._splat, self._bin_pairs = splat, splat.bin_pairs

        def logged(*a, **k):
            out = self._bin_pairs(*a, **k)
            self.renders.append(out[3])
            return out
        splat.bin_pairs = logged
        return self

    def __exit__(self, *exc):
        self._splat.bin_pairs = self._bin_pairs


class _TwinComposite:
    """Within ``with``, the binned render composites through the plain twin
    (``composite_reference``) even for CUDA tensors: the refine step's fp32
    reference on the card."""

    def __enter__(self):
        from videomv_tpu_torch.ops import splat

        self._splat, self._kernel = splat, splat.composite
        splat.composite = lambda p, ts, tc, nts: splat.composite_reference(p, ts, tc, nts)

    def __exit__(self, *exc):
        self._splat.composite = self._kernel


def phase_refine(torch):
    """One refine step (``refine_fn``, shared uncond, DDIM t = 581 — the
    step-20 timestep of 50) at full width, bf16 through the kernels against
    fp32 on the plain paths (plain attention/FFN, the composite's twin), both
    on the card with TF32 off, from the same inputs and seeded weights; then
    each stage again on the fp32 run's own inputs (teacher forcing), so that
    one stage's error does not reach the next."""
    import copy

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.inference.refine import make_refine_fn
    from videomv_tpu_torch.models import AutoencoderKL
    from videomv_tpu_torch.models.lgm import LGM
    from videomv_tpu_torch.ops.gaussian_splat import pair_capacity, render_gaussians
    from videomv_tpu_torch.training.checkpoints import init_weights

    t0 = time.time()
    pipe = _pipeline(torch)
    dev = pipe.device
    with torch.device("meta"):
        vae32, lgm32 = AutoencoderKL(), LGM(pipe.lgm.opt)
    ref = dict(unet=copy.deepcopy(_host_unet(torch)).to(dev),
               vae=init_weights(vae32, _SEEDS["vae"], zero_init=False, device=dev),
               lgm=init_weights(lgm32, _SEEDS["lgm"], zero_init=False, device=dev))
    for m in ref.values():
        m.eval().requires_grad_(False)
    cam, rays, cv, cvp = pipe._get_cameras(15.0, 2.0)
    with torch.no_grad():
        y = pipe.encode_text(["a wooden chair, 3d asset"])
        zero_y = pipe._negative()
    gen = torch.Generator(device=dev).manual_seed(5)
    xt = torch.randn((1, 4, 24, 32, 32), generator=gen, device=dev)
    t = torch.full((1,), 581, device=dev)
    pair_log = _PairLog()

    def run(models, dtype):
        log = {}
        fn = make_refine_fn(
            unet=_Recorder(models["unet"], log, "unet"),
            vae=_Recorder(models["vae"], log, "vae", ("decode", "encode_first_stage")),
            lgm=_Recorder(models["lgm"], log, "lgm"), diffusion=pipe.diffusion,
            scale_factor=pipe.scale_factor, batch=1, gs_settings=pipe.gs_settings,
            y=y.to(dtype), zero_y=zero_y.to(dtype), cam=cam, gs_rays=rays, cam_view=cv,
            cam_view_proj=cvp, uncond_mode="shared")
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        with pair_log:
            cond, uncond = fn(xt, t)
        torch.cuda.synchronize()
        return cond, uncond, log, ops.launch_counts(), time.perf_counter() - t1

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).abs().max() / b.abs().max()).item()

    cond16, uncond16, log16, counts16, s16 = run(pipe.models, torch.bfloat16)
    with _TwinComposite():
        cond32, _, log32, counts32, s32 = run(ref, torch.float32)
    err = rel(cond16, cond32)
    rms = ((cond16 - cond32).norm() / cond32.norm()).item()
    chained = {k: rel(log16[k][1], log32[k][1]) for k in log32}
    cap = pair_capacity(SPLAT_GAUSSIANS, pipe.gs_settings.output_size)
    pairs = [p.tolist() for p in pair_log.renders]
    say("refine", f"refine_fn shared at t=581, 24 views 256², LGM big: bf16 kernels "
        f"{s16:.3f} s (launches {counts16}) vs fp32 plain {s32:.3f} s (launches "
        f"{counts32}); live pairs per view (bf16, fp32) min/max "
        f"{[(min(p), max(p)) for p in pairs]} of capacity {cap}; relative max error of "
        f"each stage's output, chained: {chained}; refined latents max|d|/max|ref| "
        f"{err:.3e}, |d|/|ref| {rms:.3e} (bound {REFINE_L2_TOL})")

    # each stage on the fp32 run's inputs: bf16 (kernels) vs fp32 (plain)
    with torch.no_grad():
        gauss32 = log32["lgm"][1]
        rkw = dict(bg_color=torch.full((3,), 0.5, device=dev),
                   img_size=pipe.gs_settings.output_size, fovy_deg=pipe.gs_settings.fovy,
                   packed=True)
        render16 = render_gaussians(gauss32, cv, cvp, **rkw)["image"]
        with _TwinComposite():
            render32 = render_gaussians(gauss32, cv, cvp, **rkw)["image"]
        enc_in = log32["vae.encode_first_stage"][0]
        forced = {
            "unet": rel(log16["unet"][1], log32["unet"][1]),  # same inputs already
            "vae.decode": rel(pipe.vae.decode(*log32["vae.decode"][0]),
                              log32["vae.decode"][1]),
            "lgm": rel(pipe.lgm(*log32["lgm"][0]), gauss32),
            "render": (render16 - render32).abs().max().item(),
            "vae.encode_first_stage": rel(pipe.vae.encode_first_stage(*enc_in),
                                          log32["vae.encode_first_stage"][1]),
        }
    del ref, log16, log32, gauss32, render16, render32, enc_in
    torch.cuda.empty_cache()
    bounds = dict(REFINE_STAGE_TOL, render=SPLAT_TOL)
    bad = {k: v for k, v in forced.items() if not v <= bounds[k]}
    say("refine", f"teacher-forced stages, bf16 kernels vs fp32 plain (relative max error; "
        f"render: max|d| kernel vs twin): {forced}, bounds {bounds}; {time.time() - t0:.1f}s")
    if not torch.isfinite(cond16).all() or tuple(cond16.shape) != (1, 4, 24, 32, 32):
        fail("refine", f"refined latents {tuple(cond16.shape)} not finite or misshapen")
    if not torch.equal(cond16, uncond16):
        fail("refine", "shared uncond must return the cond row twice")
    if counts16 != {"flash_attention": 21, "geglu_ffn": 21, "splat_composite": 1,
                    "splat_composite_bwd": 0}:
        fail("refine", f"expected 21 attention + 21 FFN + 1 splat launches, got {counts16}")
    if any(counts32.values()):
        fail("refine", f"the fp32 reference launched kernels: {counts32}")
    if bad:
        fail("refine", f"stages outside their bounds: {bad}")
    if not rms <= REFINE_L2_TOL:
        fail("refine", f"relative L2 error {rms:.3e} above {REFINE_L2_TOL}")


def _serve(torch, pipe, prompts, refine, tag, pair_log, by_shape=None):
    """One generate() per prompt (the first is warm-up), each with the
    launch counters reset just before it and read just after; ``by_shape``
    is what the attention and FFN counters must read split by shape."""
    import numpy as np

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.ops.gaussian_splat import pair_capacity

    cap = pair_capacity(SPLAT_GAUSSIANS, SPLAT_SIZE)
    want = REFINED_LAUNCHES if refine else PLAIN_LAUNCHES
    outs, counts = [], {}
    for i, prompt in enumerate(prompts):
        pair_log.renders.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = pipe.generate(prompt, steps=50, guide_scale=9.0, use_gs_refine=refine,
                            seed=11 + i)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts, shapes = ops.launch_counts(), ops.launch_counts_by_shape()
        peak = torch.cuda.max_memory_allocated() / 2**30
        fr = out["frames"]
        pairs = ""
        if refine:
            per = [p.tolist() for p in pair_log.renders]
            over = sum(x > cap for p in per for x in p)
            pairs = (f", live pairs per render min/max {[(min(p), max(p)) for p in per]} of "
                     f"capacity {cap} ({over} views over)")
        say("slice", f"{tag} request {i} ({'warm-up' if i == 0 else 'timed'}) {prompt!r}: "
            f"{dt:.3f} s, peak {peak:.2f} GiB, frames {fr.dtype} {list(fr.shape)}, "
            f"launches {counts}{pairs}")
        if counts != want:
            fail("slice", f"{tag}: expected launches {want}, got {counts}")
        if by_shape is not None and shapes != by_shape:
            fail("slice", f"{tag}: expected launches by shape {by_shape}, got {shapes}")
        if fr.dtype != np.uint8 or fr.shape != (24, 256, 256, 3):
            fail("slice", f"frames {fr.dtype} {fr.shape}, expected uint8 (24, 256, 256, 3)")
        if not np.isfinite(out["latents"]).all():
            fail("slice", "non-finite latents")
        outs.append(out)
    if len(outs) > 1 and np.array_equal(outs[0]["frames"], outs[1]["frames"]):
        fail("slice", f"{tag}: two different prompts gave identical views")
    return outs, counts


def phase_slice(torch):
    """configs/t2v_infer.yaml as shipped, served on the card: plain and
    refined requests, one full-uncond refined request, a PLY export, then
    the CLI's main() once. Returns the launch counts of one plain and one
    refined request."""
    import numpy as np

    from videomv_tpu_torch.inference.__main__ import main as cli_main
    from videomv_tpu_torch.ops.ply_io import load_ply

    pipe = _pipeline(torch)
    cfg = pipe.cfg
    with open(cfg.test_list_path) as fh:
        prompts = [ln.strip() for ln in fh if ln.strip()][:2]
    if len(prompts) < 2:
        fail("slice", f"need 2 prompts in {cfg.test_list_path}")
    if cfg.get("gs_refine_uncond") != "shared":
        fail("slice", "configs/t2v_infer.yaml no longer ships gs_refine_uncond: shared")

    with _PairLog() as pair_log:
        plain, counts_plain = _serve(torch, pipe, prompts, False, "plain", pair_log,
                                     PLAIN_BY_SHAPE)
        refined, counts = _serve(torch, pipe, prompts, True, "refined", pair_log,
                                 {"flash_attention": ATTN_SHAPES, "geglu_ffn": FFN_SHAPES})
        for i in range(len(prompts)):
            if np.array_equal(plain[i]["frames"], refined[i]["frames"]):
                fail("slice", f"prompt {i}: the refine left the sample unchanged")
        cfg.gs_refine_uncond = "full"
        try:
            _serve(torch, pipe, prompts[1:2], True, "refined (full uncond)", pair_log)
        finally:
            cfg.gs_refine_uncond = "shared"

    t0 = time.time()
    ply = os.path.join(ROOT, "workspace", "chip_smoke.ply")
    os.makedirs(os.path.dirname(ply), exist_ok=True)
    g = pipe.export_ply(refined[-1]["frames"], ply)
    back = load_ply(ply)
    kept = int((g[:, 3] >= 0.005).sum())
    say("slice", f"export_ply: {g.shape[0]} Gaussians, {kept} kept, {os.path.getsize(ply)} "
        f"bytes, read back {list(back.shape)} in {time.time() - t0:.1f}s")
    if g.shape != (SPLAT_GAUSSIANS, 14) or back.shape != (1, kept, 14):
        fail("slice", f"PLY shapes {g.shape} -> {back.shape}")
    if not np.allclose(back[0][:, :3], g[g[:, 3] >= 0.005][:, :3]):
        fail("slice", "PLY positions did not read back")

    torch.cuda.empty_cache()
    t0 = time.time()
    written = cli_main(["--cfg", "configs/t2v_infer.yaml", "--debug", "--device", "cuda"])
    if (len(written) != 2 or not all(os.path.exists(p) for p in written)
            or "_gs" not in os.path.basename(written[1])):
        fail("slice", f"the CLI wrote {written}, expected the plain and the _gs output")
    say("slice", f"CLI main() --debug (no override) wrote {written} in "
        f"{time.time() - t0:.1f}s")
    return counts_plain, counts


_KERNEL_CLASSES = (  # (class, name substrings), first match wins
    ("flash_attention (ours)", ("flash_attn_fwd_kernel",)),
    ("geglu_ffn (ours)", ("geglu_ffn_kernel",)),
    ("convolution", ("conv", "fprop", "dgrad", "implicit")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas", "matmul")),
    ("normalisation", ("norm", "moments")),
    ("softmax", ("softmax",)),
    ("copy / layout", ("copy", "cat", "transpose", "index")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce")),
)


def phase_profile(torch):
    """Where a served request's time goes: CUDA-event times of its parts at
    the served shapes (a CFG forward, the decode, the text encode, and the
    parts of one refine step), then the device kernels of two CFG forwards
    under torch.profiler, by class and by name."""
    from torch.profiler import ProfilerActivity, profile

    from videomv_tpu_torch.ops import gaussian_splat as tgs
    from videomv_tpu_torch.ops import splat
    from videomv_tpu_torch.ops.flash_attention import attention_reference

    pipe = _pipeline(torch)
    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((2, 4, 24, 32, 32), generator=gen, device=dev)
    z = torch.randn((1, 4, 24, 32, 32), generator=gen, device=dev)
    t = torch.full((2,), 981, device=dev)

    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    with torch.no_grad():
        y = pipe.encode_text(["a wooden chair, 3d asset", pipe.cfg.negative_prompt])
        cam, rays, cv, cvp = pipe._get_cameras(15.0, 2.0)
        cam2 = cam.expand(2, -1, -1)

        def forward():
            return pipe.unet(x, t, y=y, camera_data=cam2)

        fwd_ms = timed(forward, 5)
        dec_ms = timed(lambda: pipe._decode_latents(z), 3)
        enc_ms = timed(lambda: pipe.encode_text(["a wooden chair, 3d asset"]), 5)
        say("profile", f"CUDA events: CFG forward (48 rows) {fwd_ms:.2f} ms -> x50 "
            f"{50 * fwd_ms / 1e3:.3f} s; VAE decode of 24 views {dec_ms:.2f} ms; text "
            f"encode {enc_ms:.2f} ms")

        # the parts of one refine step (shared uncond), in the order it runs them
        st = pipe.gs_settings
        lgm_in = torch.cat([torch.randn((1, 4, 3, 256, 256), generator=gen, device=dev),
                            rays[:, :4]], dim=2)
        gauss = pipe.lgm(lgm_in)
        cap = tgs.pair_capacity(gauss.shape[1], st.output_size)
        nts = st.output_size // splat.TILE

        def project_and_bin():
            prep = {k: v[:, None] for k, v in tgs.prepare_gaussians(gauss).items()}
            proj = [p[0] for p in tgs.project_prepared(prep, cv, cvp, st.output_size,
                                                       st.tan_half_fov)]
            return splat.bin_pairs(*proj, img_size=st.output_size, max_pairs=cap, packed=True)

        payload, ts, tc, pairs = project_and_bin()
        renders = torch.rand((24, 3, 256, 256), generator=gen, device=dev) * 2 - 1
        parts = {
            "UNet forward, 24 rows": timed(lambda: pipe.unet(x[:1], t[:1], y=y[:1],
                                                             camera_data=cam), 5),
            "VAE decode, 4 views": timed(lambda: pipe.vae.decode(z[0, :, :4].transpose(0, 1)), 5),
            "LGM big, 4 x 256²": timed(lambda: pipe.lgm(lgm_in), 5),
            "projection + binning, 24 views": timed(project_and_bin, 5),
            "splat composite kernel, 24 views": timed(
                lambda: splat.composite(payload, ts, tc, nts), 5),
            "VAE encode, 24 views": timed(
                lambda: pipe.vae.encode_first_stage(renders, pipe.scale_factor), 3),
        }
        total = sum(parts.values())
        say("profile", f"CUDA events, one refine step (LGM of seeded weights: live pairs per "
            f"view {int(pairs.min())}-{int(pairs.max())}, capacity {cap}): " + "; ".join(
                f"{k} {v:.2f} ms" for k, v in parts.items())
            + f"; sum {total:.2f} ms vs the CFG forward it replaces {fwd_ms:.2f} ms")
        del payload, ts, tc, renders, gauss

        # the LGM's 32² MVAttention (head_dim 32) is outside the kernel's gate
        # and takes the plain path, with fp32 logits [1, 16, 4096, 4096]
        q, k, v = (torch.randn((1, 4096, 16, 32), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        attn_ms = timed(lambda: attention_reference(q, k, v), 5)
        attn_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        say("profile", f"LGM plain attention at head_dim 32 ([1, 4096, 16, 32], 5 calls per "
            f"LGM forward): {attn_ms:.2f} ms per call, {5 * attn_ms:.2f} ms of the LGM's "
            f"{parts['LGM big, 4 x 256²']:.2f} ms, peak {attn_gib:.2f} GiB above the resident")
        del q, k, v

        n_fwd = 2
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_fwd):
                forward()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    if busy == 0:
        say("profile", "torch.profiler recorded no device time: breakdown not measured")
        return
    classes = {}
    for name, ms in kernels.items():
        low = name.lower()
        cls = next((c for c, keys in _KERNEL_CLASSES if any(k in low for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    say("profile", f"torch.profiler, {n_fwd} CFG forwards: wall {wall_ms / n_fwd:.2f} ms, "
        f"kernels {busy / n_fwd:.2f} ms per forward, device busy {100 * busy / wall_ms:.1f}%")
    for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:24s} {ms / n_fwd:9.3f} ms/forward {100 * ms / busy:5.1f}%", flush=True)
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms / n_fwd:9.3f} ms/forward  {name[:110]}", flush=True)
    out_dir = os.path.join(ROOT, "workspace", "profile")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "profile_cfg_forward.json"))



class _TwinSplat:
    """Within ``with``, the composite and its backward run their plain twins
    even for CUDA tensors: the fp32 reference of the train phase."""

    def __enter__(self):
        from videomv_tpu_torch.ops import splat

        self._splat = splat
        self._saved = (splat._composite_forward, splat.composite_backward)
        splat._composite_forward = splat.composite_reference
        splat.composite_backward = splat.composite_backward_reference

    def __exit__(self, *exc):
        self._splat._composite_forward, self._splat.composite_backward = self._saved


class _EventTimers:
    """CUDA-event time of each named part of a step: ``with timers(name)``
    around the part; ``ms()`` after a synchronise."""

    def __init__(self, torch):
        self._torch, self.spans = torch, []

    def __call__(self, name):
        timers, torch = self, self._torch

        class _Span:
            def __enter__(self):
                self.start = torch.cuda.Event(enable_timing=True)
                self.end = torch.cuda.Event(enable_timing=True)
                self.start.record()

            def __exit__(self, *exc):
                self.end.record()
                timers.spans.append((name, self.start, self.end))
        return _Span()

    def ms(self):
        self._torch.cuda.synchronize()
        out = {}
        for name, start, end in self.spans:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


class _Timed:
    """Stands in for a model: its call (or, with ``method``, that method's
    call) runs inside ``timers(name)``."""

    def __init__(self, module, timers, name, method=None):
        self._m, self._timers, self._name, self._method = module, timers, name, method

    def __call__(self, *a, **k):
        if self._method is not None:
            return self._m(*a, **k)
        with self._timers(self._name):
            return self._m(*a, **k)

    def __getattr__(self, attr):
        fn = getattr(self._m, attr)
        if attr != self._method:
            return fn

        def call(*a, **k):
            with self._timers(self._name):
                return fn(*a, **k)
        return call


def phase_train(torch):
    """configs/t2v_train.yaml with UNet.use_lgm_refine True at full width on
    the card: T2VTrainer takes TRAIN_STEPS steps at batch 1 on the synthetic
    dataset (launch counters reset just before, read just after), then
    three more steps by parts under CUDA events, the gradient checks, a save /
    restore round trip, and the CLI once. Returns the launch counts of the
    TRAIN_STEPS-step run."""
    import threading

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.config import load_config
    from videomv_tpu_torch.ops import gaussian_splat as tgs
    from videomv_tpu_torch.ops import splat
    from videomv_tpu_torch.training.__main__ import main as train_cli
    from videomv_tpu_torch.training.engine import T2VTrainer
    from videomv_tpu_torch.training.lgm_refine import build_lgm_refine_step, draw_refine_randoms

    import gc

    global _PIPE, _HOST_UNET
    _PIPE = _HOST_UNET = None  # the serving models are done; the trainer builds its own
    gc.collect()
    torch.cuda.empty_cache()
    os.chdir(ROOT)
    t0 = time.time()
    cfg = load_config("configs/t2v_train.yaml", opts=TRAIN_OPTS)
    trainer = T2VTrainer(cfg, device="cuda").init(zero_init=False)
    dev = trainer.device
    opt = trainer.lgm.opt
    n_lgm = sum(p.numel() for p in trainer.lgm.parameters())
    say("train", f"T2VTrainer of configs/t2v_train.yaml + use_lgm_refine: UNet dim "
        f"{trainer.unet.dim} x {tuple(trainer.unet.dim_mult)}, {trainer.max_frames} views, LGM "
        f"{n_lgm / 1e6:.1f} M parameters ({opt.num_input_views} inputs at {opt.input_size}², "
        f"{opt.num_views} supervision views at {opt.output_size}²), lgm_use_checkpoint "
        f"{trainer.lgm.unet.use_checkpoint}, view chunk {trainer._step_kwargs['view_chunk']}, "
        f"dtype {trainer.dtype}; init {time.time() - t0:.1f}s")
    if (opt.output_size, trainer._step_kwargs["view_chunk"]) != (TRAIN_RENDER_SIZE,
                                                                TRAIN_VIEW_CHUNK):
        fail("train", "the shipped config no longer renders 512² in chunks of 2 views")
    def checksum(module):
        """Exact integer sums of every parameter's bits: equal before and
        after means bit-identical (up to a collision of sums)."""
        return [p.detach().view(torch.int16 if p.element_size() == 2 else torch.int32)
                .long().sum().item() for p in module.parameters()]

    towers = (("unet", trainer.unet), ("vae", trainer.vae), ("clip", trainer.clip),
              ("lpips", trainer.lpips))
    frozen = {n: checksum(m) for n, m in towers}
    before = [p.detach().cpu() for p in trainer.lgm.parameters()]  # kept on the host

    # ---- the main path: TRAIN_STEPS steps through T2VTrainer.train
    losses = []
    step_fn = trainer.refine_step

    def logged_step(*a, **k):
        loss, aux = step_fn(*a, **k)
        losses.append((loss, aux["psnr"], aux["loss_lpips"]))
        return loss, aux
    trainer.refine_step = logged_step
    n_threads = threading.active_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    with _PairLog() as pair_log:
        last = trainer.train(num_steps=TRAIN_STEPS, batch_size=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    counts, shapes = ops.launch_counts(), ops.launch_counts_by_shape()
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer.refine_step = step_fn
    vals = [[float(x) for x in row] for row in losses]
    cap = tgs.pair_capacity(opt.splat_size ** 2 * opt.num_input_views, opt.output_size)
    demanded = [x for p in pair_log.renders for x in p.tolist()]
    say("train", f"{TRAIN_STEPS} steps at batch 1 in {run_s:.3f} s (the first includes warm-up), "
        f"peak {peak:.2f} GiB, (loss, psnr, lpips) per step {vals}, launches {counts}, attention "
        f"launches by shape {shapes['flash_attention']}; demanded "
        f"pairs per rendered view min/max {min(demanded)}/{max(demanded)} of capacity {cap}")
    want = {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}
    if counts != want:
        fail("train", f"expected launches {want} over {TRAIN_STEPS} steps, got {counts}")
    want = {"flash_attention": {k: v * TRAIN_STEPS for k, v in TRAIN_ATTN_SHAPES.items()},
            "geglu_ffn": {}}
    if shapes != want:
        fail("train", f"expected launches by shape {want}, got {shapes}")
    if len(vals) != TRAIN_STEPS or not all(x == x and abs(x) < 1e30 for row in vals for x in row):
        fail("train", f"non-finite loss in {vals}")
    if last != vals[-1][0] or trainer.lgm_state.step != TRAIN_STEPS:
        fail("train", "train() did not return the last step's loss after TRAIN_STEPS steps")
    if threading.active_count() != n_threads:
        fail("train", "the prefetch worker outlived train()")
    moved = max((a - b.detach().cpu()).abs().max().item()
                for a, b in zip(before, trainer.lgm.parameters()))
    if not moved > 0:
        fail("train", "the LGM parameters did not change")
    for name, module in towers:
        if frozen[name] != checksum(module):
            fail("train", f"the frozen {name} changed")
    say("train", f"LGM parameters moved by up to {moved:.3e}; UNet, VAE, CLIP and LPIPS "
        f"bit-identical; optimizer count {trainer.lgm_state.optimizer.count}")
    del frozen, before

    # ---- three more steps by parts (CUDA events)
    from videomv_tpu_torch.data.datasets import SyntheticMVDataset, batch_iterator

    host = next(batch_iterator(SyntheticMVDataset(resolution=tuple(trainer.resolution),
                                                  max_frames=trainer.max_frames), 1))
    gen = torch.Generator(device=dev).manual_seed(3)
    runs, walls = [], []
    state = trainer.lgm_state
    n_extra = opt.num_views - opt.num_input_views
    for _ in range(3):  # the median of three steps: one step's parts move with the host
        # the step's own seams (prepare, loss_from) and its models, each
        # inside a pair of events; then backward and the optimizer as the
        # step runs them
        timers = _EventTimers(torch)
        timed_step = build_lgm_refine_step(
            _Timed(trainer.unet, timers, "unet forward"),
            _Timed(trainer.vae, timers, "vae decode", "decode"),
            _Timed(trainer.lgm, timers, "lgm forward"), trainer.diffusion,
            **trainer._step_kwargs)
        with timers("encode (VAE 24 views + text)"):
            feats = trainer.encode_batch(host)
        with timers("supervision wire"):
            feats.update(trainer._gs_features(host))
        t1 = time.perf_counter()
        draws = draw_refine_randoms(gen, feats["latents"], trainer.diffusion,
                                    opt.num_input_views, n_extra)
        state.optimizer.zero_grad()
        with timers("prepare"):
            prep = timed_step.prepare(feats, draws)
        with timers("loss_from"):
            loss, _ = timed_step.loss_from(prep)
        with timers("backward"):
            loss.backward()
        with timers("optimizer"):
            state.optimizer.step()
        state.step += 1
        ms = timers.ms()
        walls.append((time.perf_counter() - t1) * 1e3)
        # the seams hold their models' calls: take those out
        ms["prepare: q_sample, cameras, ground truth"] = (
            ms.pop("prepare") - ms["unet forward"] - ms["vae decode"])
        ms["render + losses"] = ms.pop("loss_from") - ms["lgm forward"]
        runs.append(ms)
        del prep, loss
    parts = {k: sorted(r[k] for r in runs)[1] for k in runs[0]}
    say("train", "CUDA events, one step by part (median of 3 steps): " + "; ".join(
        f"{k} {v:.2f} ms" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.2f} ms; sums of the 3 steps "
        f"{[round(sum(r.values()), 2) for r in runs]}; host wall of the step alone, median "
        f"{sorted(walls)[1]:.2f} ms")

    # ---- pieces of the render + losses and of the backward, alone, at the
    # step's shapes (one chunk of TRAIN_VIEW_CHUNK views at 512²)
    draws = draw_refine_randoms(gen, feats["latents"], trainer.diffusion, opt.num_input_views,
                                n_extra)
    prep = trainer.refine_step.prepare(feats, draws)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        gauss = trainer.lgm(prep["lgm_in"]).float()
    cv, cvp = prep["cam_view"][:, :TRAIN_VIEW_CHUNK], prep["cam_view_proj"][:, :TRAIN_VIEW_CHUNK]
    nts = opt.output_size // splat.TILE
    tan = float(math.tan(0.5 * math.radians(opt.fovy)))

    def bin_chunk(g):
        pr = {k: v[:, None] for k, v in tgs.prepare_gaussians(g).items()}
        proj = [p[0] for p in tgs.project_prepared(pr, cv, cvp, opt.output_size, tan)]
        return splat.bin_pairs(*proj, img_size=opt.output_size, max_pairs=cap)

    g_req = gauss.clone().requires_grad_()
    payload, ts, tc, _ = bin_chunk(g_req)
    dpay = torch.randn_like(payload)
    out_tiles = splat.composite(payload.detach(), ts, tc, nts)
    gtiles = torch.randn_like(out_tiles)
    imgs = torch.rand((2 * TRAIN_VIEW_CHUNK, 3, 256, 256), device=dev)

    def lpips_fwd_bwd():
        x = imgs[:TRAIN_VIEW_CHUNK].clone().requires_grad_()
        trainer.lpips(imgs[TRAIN_VIEW_CHUNK:] * 2 - 1, x * 2 - 1).mean().backward()

    def lgm_fwd_bwd():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            g = trainer.lgm(prep["lgm_in"])
        g.backward(torch.ones_like(g))

    with torch.no_grad():
        pieces = {
            "projection + binning forward, 1 chunk": _time_one(
                torch, lambda: bin_chunk(gauss), 5),
            "composite forward kernel, 1 chunk": _time_one(
                torch, lambda: splat.composite(payload.detach(), ts, tc, nts), 5),
            "composite backward kernel, 1 chunk": _time_one(
                torch, lambda: splat.composite_backward(payload.detach(), ts, tc, out_tiles,
                                                        gtiles, nts), 5),
        }
        with torch.autocast("cuda", dtype=torch.bfloat16):
            pieces["LGM forward (autocast, no grad)"] = _time_one(
                torch, lambda: trainer.lgm(prep["lgm_in"]), 3)
    pieces["projection + binning backward, 1 chunk"] = _time_one(
        torch, lambda: torch.autograd.grad(payload, g_req, dpay, retain_graph=True), 5)
    pieces["LPIPS forward + backward, 1 chunk"] = _time_one(torch, lpips_fwd_bwd, 3)
    pieces["LGM forward + recompute + backward"] = _time_one(torch, lgm_fwd_bwd, 2)
    trainer.lgm_state.optimizer.zero_grad()
    say("train", "CUDA events, pieces alone at the step's shapes (a step runs 4 chunks, each "
        "forward twice): " + "; ".join(f"{k} {v:.2f} ms" for k, v in pieces.items())
        + f"; live pairs of the chunk {int(tc.sum())}, max per tile {int(tc.max())}")
    del payload, ts, tc, dpay, out_tiles, gtiles, imgs, g_req

    # ---- gradients: kernels 3 + 4 vs their twins on the same Gaussians
    def dgauss():
        g = gauss.clone().requires_grad_()
        loss, _ = trainer.refine_step.loss_from(prep, gaussians=g)
        return loss.item(), torch.autograd.grad(loss, g)[0]

    loss_k, dg_k = dgauss()
    with _TwinSplat():
        ops.reset_launch_counts()
        loss_t, dg_t = dgauss()
        if any(ops.launch_counts().values()):
            fail("train", f"the twin render launched kernels: {ops.launch_counts()}")
    dg_err = ((dg_k - dg_t).abs().max() / dg_t.abs().max()).item()
    say("train", f"d loss / d Gaussians (8 views at 512², MSE + alpha + LPIPS) through kernels "
        f"3 + 4 vs through their twins, same Gaussians: loss {loss_k:.6f} vs {loss_t:.6f}, "
        f"max|d|/max|ref| {dg_err:.3e} (bound {TRAIN_DGAUSS_TOL:.0e}), max|ref| "
        f"{dg_t.abs().max().item():.3e}")
    if not dg_err <= TRAIN_DGAUSS_TOL or not abs(loss_k - loss_t) <= 1e-4 * abs(loss_t):
        fail("train", "the kernels' gradient differs from the twins'")
    del dg_k, dg_t

    # ---- gradients: one step's LGM gradient, bf16 autocast + kernels vs
    # fp32 + plain paths, from the same LGM input
    def lgm_grads(step):
        trainer.lgm_state.optimizer.zero_grad()
        loss, _ = step.loss_from(prep)
        loss.backward()
        flat = torch.cat([p.grad.flatten() for p in trainer.lgm.parameters()])
        trainer.lgm_state.optimizer.zero_grad()
        return loss.item(), flat

    loss16, g16 = lgm_grads(trainer.refine_step)
    kw = dict(trainer._step_kwargs, autocast_dtype=None)
    plain = build_lgm_refine_step(trainer.unet, trainer.vae, trainer.lgm, trainer.diffusion, **kw)
    with _TwinSplat():
        ops.reset_launch_counts()
        loss32, g32 = lgm_grads(plain)
        if any(ops.launch_counts().values()):
            fail("train", f"the fp32 reference launched kernels: {ops.launch_counts()}")
    cos = (torch.dot(g16, g32) / (g16.norm() * g32.norm())).item()
    ratio = (g16.norm() / g32.norm()).item()
    rel_l2 = ((g16 - g32).norm() / g32.norm()).item()
    say("train", f"LGM gradient of one step ({g16.numel() / 1e6:.1f} M values) from the same LGM "
        f"input, bf16 autocast + kernels vs fp32 + plain paths: loss {loss16:.6f} vs "
        f"{loss32:.6f}, cosine {cos:.4f} (bound >= {TRAIN_GRAD_MIN_COS}), |g16|/|g32| "
        f"{ratio:.4f} (bound {TRAIN_GRAD_NORM_RATIO}), |d|/|ref| {rel_l2:.3e}")
    if (not cos >= TRAIN_GRAD_MIN_COS
            or not TRAIN_GRAD_NORM_RATIO[0] <= ratio <= TRAIN_GRAD_NORM_RATIO[1]):
        fail("train", "the bf16 gradient disagrees with the fp32 one")
    del g16, g32, prep, gauss, feats

    # ---- save / restore round trip
    path = trainer.save(os.path.join(ROOT, "workspace", "chip_smoke_train", "checkpoints"))
    ref = [p.detach().clone() for p in trainer.lgm.parameters()]
    with torch.no_grad():
        for p in trainer.lgm.parameters():
            p.zero_()
    trainer.lgm_state.step = 0
    trainer.restore(path)
    same = all(torch.equal(a, b) for a, b in zip(ref, trainer.lgm.parameters()))
    say("train", f"save / restore: {os.path.getsize(path) / 2**30:.2f} GiB, step "
        f"{trainer.lgm_state.step}, parameters identical {same}")
    if not same or trainer.lgm_state.step != TRAIN_STEPS + 3:
        fail("train", "the checkpoint did not restore the LGM state")
    os.remove(path)
    del trainer, ref, timed_step, plain, step_fn, towers
    torch.cuda.empty_cache()

    # ---- the CLI once, on the card by default
    t1 = time.time()
    loss = train_cli(["--cfg", "configs/t2v_train.yaml", "--steps", "2", "--batch-size", "1",
                      *TRAIN_OPTS])
    say("train", f"CLI main() --steps 2 --batch-size 1 UNet.use_lgm_refine True: final loss "
        f"{loss:.6f} in {time.time() - t1:.1f}s")
    if not loss == loss:
        fail("train", "the CLI's loss is not finite")
    torch.cuda.empty_cache()
    return counts

if __name__ == "__main__":
    main()
