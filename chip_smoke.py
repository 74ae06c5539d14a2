"""Smoke test of the PyTorch/CUDA port (videomv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card, ~10 minutes

Phases (each prints its lines; a failed phase exits non-zero):
  1. environment: torch/CUDA versions, device, power limit, optional deps;
  2. build: compile csrc/*.cu with nvcc (one process per source, all at
     once), print the ptxas resource lines and the tiling of the wgmma
     kernels (attention, FFN, the fused spatial block's three phases), which
     must show no spills and no serialised wgmma;
  3. kernels: each CUDA kernel against its plain PyTorch twin at the shapes
     the served and trained paths give it — flash attention and the GEGLU
     FFN in bf16 (error vs an fp32 computation), the splat composite on one
     24-view 256² render call of a 65,536-Gaussian scene, both payloads, and
     on one 2-view 512² chunk of the train step (error vs its twin), the
     composite's backward kernel on the same two calls (error vs its twin,
     relative to the largest gradient; the per-tile kernel of the first port
     and the item order in turns), the binned render of one view
     against the dense oracle, the attention backward kernel at every
     trained shape against its twin and autograd of the fp32 plain
     attention (chunked by rows; its lse input against its twin; two runs
     bit-equal; kernel, twin and the library's backward timed), the FFN
     wrapper's backward against autograd of its twin, and the fused spatial block
     at the UNet's 32² / C = 320 stage over the I2V and T2V contexts (error
     vs its fp32 twin, held to twice the bf16 module path's, for both
     hand-written kernels; the module path's time beside it; its backward);
     CUDA-event times in turns
     plain/kernel/kernel/plain beside each kernel's bound (the larger of its
     bytes over 3.35 TB/s and its operations over the peak rate of their
     type), its share of that bound, which hand-written kernel served the
     shape and, for attention, the time of one scaled_dot_product_attention
     call as a yardstick; launch counters; two launches bit-equal;
  4. unet: one full-width (dim 320) CFG forward at 8 views with seeded
     weights, bf16 with the kernels on the card vs fp32 plain on the host;
  5. refine: one Gaussian-splat refine step (refine_fn) at full width,
     bf16 with the kernels vs fp32 with the plain paths, both on the card,
     end to end and stage by stage on the same inputs (the VAE stages, which
     run no kernel, against the fp32 arithmetic of the served weights);
  6. slice: configs/t2v_infer.yaml as shipped (refine on, shared uncond)
     served at full width, 24 views, 256², 50 DDIM steps, CFG 9.0, bf16 —
     two plain requests, two refined requests (the first of each is
     warm-up), a plain and a refined request served from the UNet's CUDA
     graphs against the same requests eager (latents bit-equal, launches by
     shape equal, every forward replayed), two plain requests with the
     fused spatial block switched on, one refined request with full uncond,
     a PLY export read back, then the CLI's main() once;
  7. profile: where a request's time goes — CUDA-event times of a CFG
     forward, the VAE decode, the text encode, the parts of one refine
     step and the LGM's plain head_dim-32 attention, and the device
     kernels of two CFG forwards under torch.profiler by class and name
     (trace written to workspace/profile/);
  8. tracing: the program's own spans (utils.profiling) over the shipped
     T2V config's plain and refined requests: the host cost of one span off
     and on; TRACE_TURNS requests with tracing off and on in turns (the
     seconds of each, the on-cost), each traced request's spans (every
     span's device ms > 0, the refine's five stages within TRACE_TOL of the
     refine, the top-level spans at least TRACE_COVER of the request's device
     time, the launch counters of the record, the sampler.forward spans
     within TRACE_TOL of CUDA events from the UNet's forward hooks), then one
     request under torch.profiler (host and device) and its idle device time
     by span;
  9. i2v: configs/i2vgen_xl_infer.yaml as shipped (refine on, shared uncond,
     guidance 6.0) at full width — one UNetSD_I2VGen CFG forward at 8 views
     with the fused spatial block switched on, bf16 on the card vs fp32 on
     the host, and against the switch off; requests from
     data/images/test_obj.png: plain with the switch off, plain with it on,
     refined with it on (the first of each pair is warm-up), with asserted
     launch counts, and the refined request from the CUDA graphs against
     the eager loop as in the slice phase; one CFG forward by kernel class,
     on and off; the CLI's
     main() once with the switch on. The script sets and restores
     VIDEOMV_ENABLE_FUSED_SPATIAL around each part; the other phases run
     with it unset;
 10. train: configs/t2v_train.yaml with UNet.use_lgm_refine True at full
     width (frozen UNet, VAE and text tower, LGM big trained, 8 supervision
     views at 512², LPIPS, AdamW) — T2VTrainer takes 3 steps at batch 1 on
     the synthetic dataset with asserted launch counts, finite losses, the
     LGM changed and the frozen towers bit-identical; three more steps by
     parts under CUDA events; the gradient through kernels 3 + 4 against
     their twins, and one step's LGM gradient bf16 with the kernels against
     fp32 plain; a save / restore round trip; the training CLI once;
 11. unet_train: configs/t2v_train.yaml as shipped (the plain UNet finetune:
     UNetSD_T2VBase of 1.41 B parameters trained in fp32 under bf16 autocast
     with block checkpointing, frozen VAE and text tower, AdamW with the SD
     keys' gradients at 0.5) with seeded weights — T2VTrainer takes 3 steps
     at batch 2 on the synthetic dataset with asserted launch counts by
     shape, a finite loss, every UNet parameter moved and the frozen towers
     bit-identical; a step by parts under CUDA events (encode, forward,
     backward, optimizer, an EMA lerp), the host wall, the device busy share
     of a step under torch.profiler and the peak memory; the attention's
     forward + backward alone, kernel 1 (its backward kernel) against the
     plain twin, time and peak; one step's UNet gradient bf16 with kernel 1 vs fp32
     plain; the visualisation hook once; a save / restore round trip of the
     full state; the training CLI
     at the shipped batch of 8; then configs/t2v_train_laion.yaml on a shard
     written into workspace/, 4 steps with an image step (f = 1) every 2nd
     at the shipped batches (image 196, video 24 = 576 rows) with each
     step's seconds, then one video step by parts and its peak;
 12. i2v_train: configs/i2vgen_xl_train.yaml as shipped (UNetSD_I2VGen of
     1.42 B parameters trained in fp32 under bf16 autocast, the joint text +
     visual tower and the VAE frozen, cosine / zero terminal SNR /
     v-prediction with offset noise 0.1, EMA on) with seeded weights —
     T2VTrainer takes 3 steps at batch 2 with asserted launch counts by
     shape, every UNet and EMA tensor moved and the towers bit-identical; a
     step by parts, the busy share, one step's UNet gradient bf16 with kernel
     1 vs fp32 plain; i2v_viz once over the EMA weights (a 50-step CFG DDIM
     from the batch's own conditioning; fails on a logged "i2v viz failed");
     the training CLI at the shipped batch of 8 with its peak memory; then
     the LGM-refine finetune behind the frozen I2V UNet (UNet.use_lgm_refine
     True, batch 1): 3 steps with asserted launch counts by shape (kernels 1,
     3 and 4) and the LGM gradient bf16 with the kernels vs fp32 plain;
 13. dist_train: configs/t2v_train.yaml's UNet finetune at full width, batch
     2, one step on a fixed batch and fixed draws: plain (no process group),
     then under torch.distributed at world size 1 on NCCL, replicated (the
     data-parallel step; loss bit-equal) and FSDP-sharded, each held to the
     plain step's loss and gradient with kernel 1's twenty launches by shape
     and its peak memory, then one AdamW step of the sharded state and one
     Adafactor step of it, held to the plain Adafactor on the same gradient;
 14. batched_serving: generate_batch(force_batched=True) of two prompts at
     the shipped T2V geometry, plain and refined, each row against a
     single-prompt request fed its noise row (first CFG forward, final
     latents), kernels 1, 2 and 3 by shape, the batch's wall against the two
     requests' (not a claim);
 15. multirank: two ranks on the one card. NCCL refuses two ranks on one
     device (its message is printed); over gloo with CUDA tensors a
     frame-parallel plain T2V request (sp = 2, MULTIRANK_STEPS DDIM steps)
     against one rank, and one data-parallel finetune step at global batch 2
     against dist_train's loss; the ranks take their weights from files the
     phase writes (it needs dist_train in the same run);
 16. variants: slice F at full width. The T2V finetune step of
     configs/t2v_train.yaml at batch 2 under remat_policy full, dots_no_batch
     and dots (the step by parts, its peak memory, the loss bit-equal to
     full's, the gradient's cosine to full's); over the served T2V UNet at 24
     views PLMS (20 steps, CFG 9.0), DDIM inversion of a plain request's
     latents and DDIM back (20 steps each, the cond rows), DDPM over linear_sd
     cut to 50 steps (CFG 9.0), each with its first prediction bf16 vs fp32;
     the UNet with temporal_block rotary (temporal_attn_times 2, use_sim_mask)
     and attemask, seeded from the T2V draw where they share tensors: a
     48-row forward bf16 vs fp32 plain on the card (rotary also with a
     video_mask and a focus_present_mask), then one 50-step request each
     through T2VPipeline. Every path's launches by shape are derived from the
     block plan and must be shapes the kernels phase checks.
Every model is seeded through one cache of draws (``_SeededWeights``): each
(module layout, seed) is drawn once on the host by the program's
``init_weights``, and the later phases' trainers and CLIs copy it.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. There is no CPU fallback: with
no CUDA device the script fails before printing any result.

``--phases env,build,kernels`` runs a subset (for bring-up of one part);
``--kernels geglu_ffn,flash_attention`` cuts the kernels phase to the named
kernels; ``--phases env,ffn_ablation`` (``spatial_ablation``,
``splat_bwd_ablation``) times kernel 2 (5, 4) with parts compiled out;
``--phases env,unet_train_memory`` takes one joint-LAION step at each batch of
UNET_TRAIN_MEMORY_BATCHES and prints its peak memory or its out-of-memory error;
``--phases env,vae_logits`` runs the refine phase with the VAE's attention logits
formed as a bf16 product and as fp32, on the same inputs;
``--phases env,init_cost`` times the seeded init of the I2V trainer's models as
a sequential loop (draw, scaling and copy apart) against ``init_models``;
``--phases env,build,train_spread`` repeats the train phase's two gradient
checks on TRAIN_SPREAD_DRAWS draws of the step's randoms and prints each
reading's spread against its bound.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# kernel sources for the JSON record, and the TPU kernels they replace
KERNELS = {
    "flash_attention": dict(
        route="cuda", source="videomv_tpu_torch/csrc/flash_attention.cu",
        replaces="videomv_tpu/ops/flash_attention.py:36"),
    # kernel 1's gradient: the JAX package's custom VJP (_bwd) of that kernel
    "flash_attention_bwd": dict(
        route="cuda", source="videomv_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="videomv_tpu/ops/flash_attention.py:121"),
    "geglu_ffn": dict(
        route="cuda", source="videomv_tpu_torch/csrc/fused_ffn.cu",
        replaces="videomv_tpu/ops/fused_ffn.py:70"),
    "splat_composite": dict(
        route="cuda", source="videomv_tpu_torch/csrc/splat_composite.cu",
        replaces="videomv_tpu/ops/splat_pallas.py:370"),
    "splat_composite_bwd": dict(
        route="cuda", source="videomv_tpu_torch/csrc/splat_composite_bwd.cu",
        replaces="videomv_tpu/ops/splat_pallas.py:446"),
    "fused_spatial": dict(
        route="cuda", source="videomv_tpu_torch/csrc/fused_spatial.cu",
        replaces="videomv_tpu/ops/fused_spatial.py:98"),
    # replaces no Pallas kernel (XLA fuses the JAX package's GroupNorms):
    # added because the served requests' traces put normalisation first
    "group_norm": dict(
        route="cuda", source="videomv_tpu_torch/csrc/group_norm.cu", replaces=None),
}
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): the bound of a
# kernel is the larger of its bytes over the memory rate and its operations
# over the peak rate of their type.
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
# fp32 operations of the two splat kernels, counted as the least work any
# implementation must do on this run's data. Only at an alive (pixel, pair)
# point (power <= 0 and alpha >= 1/255) does a pair change the output, and
# there alpha is rebuilt (dx, dy 2, the quadratic form 5, power 4, exp 1,
# opacity x exp 1, the 0.99 clamp 1, the two cuts 2: SPLAT_POINT_OPS) and
# blended (alpha x T, four accumulating products, T x (1 - alpha): 11) or, in
# the backward, its gradient terms formed (gC.c 7, the running prefix 2,
# max(1 - alpha, 0.01) 2, d alpha 4, the clamp mask 1, d power and d opacity
# 2, the five geometry terms 17, gC x w 4, T x (1 - alpha) 2, and the w of
# the forward 1: 42) and its 10 values added into the sums over pixels (10).
# A point that is not alive needs no operation: a kernel can cull it without
# evaluating it, as the culled forward does for most of them. What the twin
# does (alpha rebuilt at every point of a segment, SPLAT_POINT_OPS each) is
# printed beside the bound as the segment-walk count.
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
# SV3D (sv3d_p, videomv_tpu_torch/configs/sv3d_p_infer.yaml): the kernels'
# shapes in its CFG forward of 42 rows (21 frames) at 72², 36² and 18²
# latents, timed and checked here; no phase serves an SV3D request, so its
# launches are counted by the benchmark's run of the cell, not here. The
# spatial self-attention of each level (the 9² middle block's 81 tokens stay
# plain), S % 128 != 0 at every one (the wgmma kernel's masked last tile),
# and the GEGLU FFNs at 72² and 36² (the 18² level is C = 1280).
SV3D_ATTN_SHAPES = ((42, 5184, 5, 64), (42, 1296, 10, 64), (42, 324, 20, 64))
SV3D_FFN_SHAPES = ((217728, 320, 1280), (54432, 640, 2560))
# rows of a plain-twin chunk at SV3D's shapes ([6, 5, 5184, 5184] fp32 logits: 3.2 GB)
SV3D_TWIN_ROWS = 6
# kernel 6's shape classes (N, C, F, side, permuted, silu): T2V's temporal
# norms at 48 and 24 rows (the permuted view read in place; the temporal
# convolutions' norm with its SiLU, the temporal transformers' without),
# its spatial ones, SV3D's temporal and spatial at 72² and its 9² temporal,
# the VAE decoder's largest groups at 256² and 576² (held in part at 576²)
GN_SHAPES = ((2, 320, 24, 32, True, True), (2, 320, 24, 32, True, False),
             (1, 320, 24, 32, True, True), (48, 320, 1, 32, False, True),
             (2, 320, 21, 72, True, True), (42, 320, 1, 72, False, True),
             (2, 1280, 21, 9, True, True), (24, 256, 1, 256, False, True),
             (24, 128, 1, 256, False, True), (14, 128, 1, 576, False, True),
             (14, 256, 1, 576, False, True))
# a plain request's launches by shape: the 48-row shapes only
PLAIN_BY_SHAPE = {"flash_attention": {(48, 1024, 5, 64): 250, (48, 256, 10, 64): 250},
                  "geglu_ffn": {(49152, 320, 1280): 500, (12288, 640, 2560): 500,
                                (49152, 512, 2048): 50}}
PLAIN_LAUNCHES = {"flash_attention": 500, "flash_attention_bwd": 0, "geglu_ffn": 1050,
                  "splat_composite": 0, "splat_composite_bwd": 0, "fused_spatial": 0}
REFINED_LAUNCHES = {"flash_attention": 533, "flash_attention_bwd": 0, "geglu_ffn": 1050,
                    "splat_composite": 3, "splat_composite_bwd": 0, "fused_spatial": 0}
# The I2V requests of configs/i2vgen_xl_infer.yaml (50 steps, CFG rows
# batched, refine `shared` at 20/30/40). With the fused spatial block switched
# on, each forward's five 32² SpatialTransformers are one fused launch each and
# leave kernels 1 and 2: 5 fused + 5 attention (16²) + 16 FFN per forward
# instead of 10 + 21; the refined request adds the LGM's 11 attentions and one
# composite per refine step.
I2V_PLAIN_OFF = dict(PLAIN_LAUNCHES)
I2V_PLAIN_ON = {"flash_attention": 250, "flash_attention_bwd": 0, "geglu_ffn": 800,
                "splat_composite": 0, "splat_composite_bwd": 0, "fused_spatial": 250}
I2V_REFINED_ON = {"flash_attention": 283, "flash_attention_bwd": 0, "geglu_ffn": 800,
                  "splat_composite": 3, "splat_composite_bwd": 0, "fused_spatial": 250}
I2V_FUSED_BY_SHAPE = {"plain": {(48, 1024, 320, 145): 250},
                      "refined": {(48, 1024, 320, 145): 235, (24, 1024, 320, 145): 15}}
I2V_CFG = "configs/i2vgen_xl_infer.yaml"
# a plain T2V request with the switch on: its 32² blocks over the 77-token
# text context, as in the I2V request
T2V_PLAIN_ON = dict(I2V_PLAIN_ON)
T2V_FUSED_BY_SHAPE = {(48, 1024, 320, 77): 250}
# One LGM-refine train step at batch 1 (configs/t2v_train.yaml with
# UNet.use_lgm_refine True): the frozen UNet's forward at 24 rows without
# grad (5 + 5 attention launches; in training mode its FFN gate is closed),
# the LGM's 11 head_dim-64 attentions once in the checkpointed forward and
# once more in each block's recomputation, then once each in the backward
# kernel, and the 8 supervision views at 512² in 4 chunks of 2: one
# composite launch per chunk in the forward, one in its recomputation, one
# backward launch.
TRAIN_ATTN_SHAPES = {(24, 1024, 5, 64): 5, (24, 256, 10, 64): 5,
                     (1, 1024, 16, 64): 10, (1, 256, 16, 64): 12}
TRAIN_ATTN_BWD_SHAPES = {(1, 1024, 16, 64): 5, (1, 256, 16, 64): 6}
TRAIN_LAUNCHES = {"flash_attention": 32, "flash_attention_bwd": 11, "geglu_ffn": 0,
                  "splat_composite": 8, "splat_composite_bwd": 4, "fused_spatial": 0}
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
# draws of the step's randoms that `train_spread` holds both checks on (the
# LGM gradient check on every third)
TRAIN_SPREAD_DRAWS = 45
TRAIN_OPTS = ["UNet.use_lgm_refine", "True", "save_ckp_interval", "0",
              "log_dir", "workspace/chip_smoke_train"]
# The plain UNet finetune of configs/t2v_train.yaml as shipped (dim 320,
# 24 views, block checkpointing on) at batch 2: kernel 1 serves the self-
# attention of the five 32² and the five 16² SpatialTransformers once in the
# forward and once more in each checkpointed block's recomputation, and the
# backward kernel once for each. Kernels 2 and 5 stay closed in training
# mode and nothing renders: 20 forward launches a step, (48, 1024, 5, 64) and
# (48, 256, 10, 64) ten each, and 10 backward launches, five each. An image
# step of the joint LAION finetune (f = 1) launches the same thirty at its own
# row count.
UNET_TRAIN_STEPS, UNET_TRAIN_BATCH, UNET_TRAIN_VIEWS = 3, 2, 24


# slice E. dist_train: one step of configs/t2v_train.yaml at batch 2 (48 rows)
# plain, then replicated and FSDP-sharded at world size 1 on NCCL: the loss of
# FSDP within DIST_LOSS_RTOL of the plain step's (bf16 autocast; the
# replicated one bit-equal), the gradients within the cosine and norm ratio
# above. batched_serving: generate_batch(force_batched=True) of two prompts at
# the shipped geometry, each row against its single request (UNET_TOL on the
# first CFG forward, SERVE_LATENT_RL2 on the final latents; PERF.md §2).
# multirank: two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
# device): a frame-parallel plain request of MULTIRANK_STEPS DDIM steps at sp =
# 2 against one rank, and one data-parallel step at global batch 2 against
# dist_train's loss; the ranks read their weights from files written here.
DIST_TRAIN_BATCH = 2
DIST_LOSS_RTOL = 1e-2
# multirank holds each rank's all-reduced gradient to the plain step's by
# its norm and by the cosine of every GRAD_SAMPLE_STRIDE-th entry (1.4 M of
# the UNet's 1.4 B; a prime stride, so no tensor's layout aligns with it)
GRAD_SAMPLE_STRIDE = 997
UNET_TOL, SERVE_LATENT_RL2 = 5e-2, 0.5
MULTIRANK_STEPS = 10
MULTIRANK_DEADLINE_S = 420
MULTIRANK_DIR = os.path.join(ROOT, "workspace", "chip_smoke_multirank")
MULTIRANK_TRAIN = os.path.join(MULTIRANK_DIR, "train.pt")
MULTIRANK_SERVE = os.path.join(MULTIRANK_DIR, "serve.pt")
MULTIRANK_NCCL_RDV = os.path.join(MULTIRANK_DIR, "rendezvous_nccl")
MULTIRANK_GLOO_RDV = os.path.join(MULTIRANK_DIR, "rendezvous_gloo")


def unet_train_attn_shapes(rows):
    return {(rows, 1024, 5, 64): 10, (rows, 256, 10, 64): 10}


def unet_train_bwd_shapes(rows):
    return {(rows, 1024, 5, 64): 5, (rows, 256, 10, 64): 5}


def unet_train_by_shape(rows, steps=1):
    """Kernel 1's forward and backward launches by shape in ``steps`` UNet
    finetune steps at ``rows`` rows (no other kernel runs)."""
    return {"flash_attention": {k: v * steps for k, v in unet_train_attn_shapes(rows).items()},
            "flash_attention_bwd": {k: v * steps for k, v in unet_train_bwd_shapes(rows).items()},
            "geglu_ffn": {}, "fused_spatial": {}}


def _doubled(shapes):
    """Launches by shape of the same path at twice the rows."""
    return {(2 * s[0],) + tuple(s[1:]): c for s, c in shapes.items()}


# slice E's launches by shape, which the kernels phase also checks and times:
# the batched program of BATCH_PROMPTS prompts launches what one request
# does, each launch over twice the rows (kernel 3 over twice the views);
# rank 0 of the frame-parallel request runs its 12 frames of both CFG rows;
# the DDP and FSDP steps at batch 2 take the unet_train shapes at 48 rows
BATCH_PROMPTS = 2
BATCHED_PLAIN_BY_SHAPE = {k: _doubled(v) for k, v in PLAIN_BY_SHAPE.items()}
BATCHED_REFINED_BY_SHAPE = {"flash_attention": _doubled(ATTN_SHAPES),
                            "geglu_ffn": _doubled(FFN_SHAPES)}
MULTIRANK_BY_SHAPE = {
    "flash_attention": {(24, 1024, 5, 64): 5 * MULTIRANK_STEPS,
                        (24, 256, 10, 64): 5 * MULTIRANK_STEPS},
    "geglu_ffn": {(24576, 320, 1280): 10 * MULTIRANK_STEPS,
                  (6144, 640, 2560): 10 * MULTIRANK_STEPS,
                  (24576, 512, 2048): MULTIRANK_STEPS}}
DIST_TRAIN_BY_SHAPE = {"flash_attention": unet_train_attn_shapes(DIST_TRAIN_BATCH * UNET_TRAIN_VIEWS),
                       "flash_attention_bwd": unet_train_bwd_shapes(
                           DIST_TRAIN_BATCH * UNET_TRAIN_VIEWS)}


def _slice_e_calls(name, shape):
    """Kernel ``name``'s launches at ``shape`` on each slice-E path."""
    shape = tuple(shape)
    return dict(calls_per_batched_plain_request=BATCHED_PLAIN_BY_SHAPE.get(name, {}).get(shape, 0),
                calls_per_batched_refined_request=BATCHED_REFINED_BY_SHAPE.get(name, {}).get(
                    shape, 0),
                calls_per_rank_request=MULTIRANK_BY_SHAPE.get(name, {}).get(shape, 0),
                calls_per_dist_train_step=DIST_TRAIN_BY_SHAPE.get(name, {}).get(shape, 0))


UNET_TRAIN_LAUNCHES = {"flash_attention": 20, "flash_attention_bwd": 10, "geglu_ffn": 0,
                       "splat_composite": 0, "splat_composite_bwd": 0, "fused_spatial": 0}
UNET_TRAIN_OPTS = ["save_ckp_interval", "0", "viz_interval", "0",
                   "log_dir", "workspace/chip_smoke_unet_train"]
# the joint LAION run of configs/t2v_train_laion.yaml: 4 steps with an image
# step every 2nd (shipped: every 4th), the image steps at the shipped
# batch_sizes["1"] and the video steps at the shipped batch_sizes["24"]
# (576 rows: it fits the card since the attention backward is a kernel; the
# plain backward's fp32 logits did not)
UNET_TRAIN_IMAGE_EVERY, UNET_TRAIN_IMAGE_BATCH, UNET_TRAIN_LAION_STEPS = 2, 196, 4
UNET_TRAIN_LAION_BATCH = 24
# the CLI run's batch: the shipped batch_sizes["24"] of configs/t2v_train.yaml
UNET_TRAIN_CLI_BATCH = 8
# kernel 1's row counts in the unet_train phase that no served path gives it:
# the CLI's, the LAION run's image steps' and its video steps'
UNET_TRAIN_CHECK_ROWS = (UNET_TRAIN_CLI_BATCH * UNET_TRAIN_VIEWS, UNET_TRAIN_IMAGE_BATCH,
                         UNET_TRAIN_LAION_BATCH * UNET_TRAIN_VIEWS)
# kernel 1's backward, held against its twins in the kernels phase at every
# shape a trained path gives it: the UNet finetunes' rows (a data-parallel
# rank's 24, batch 2, 4, the CLIs' 8, the LAION image batch 196, the video
# batches 16 and 24 of the memory phase) at both token counts, and the LGM's
BWD_CHECK_ROWS = (24, 48, 96, 192, 196, 384, 576)
ATTN_BWD_SHAPES = [*(s for rows in BWD_CHECK_ROWS for s in unet_train_bwd_shapes(rows)),
                   *TRAIN_ATTN_BWD_SHAPES]
# the backward's log-sum-exp input against its twin's (fp32 both; the same
# sums in another order, |lse| ~ 7 at S = 1024)
LSE_TOL = 1e-4
# the twin's and the fp32 reference's gradients are taken this many rows at
# a time (attention rows are independent; the fp32 reference holds [rows, H,
# S, S] logits)
BWD_CHECK_CHUNK = 48
# `--phases env,unet_train_memory` takes one step of configs/t2v_train_laion.yaml
# (EMA on) at each (frames, batch) and prints its peak memory and time, or the
# out-of-memory error where the card cannot hold it
UNET_TRAIN_MEMORY_BATCHES = ((1, 196), (24, 8), (24, 16), (24, 24))
# The I2V finetune of configs/i2vgen_xl_train.yaml as shipped (UNetSD_I2VGen,
# 24 views, block checkpointing, EMA on) at batch 2: kernel 1 serves the same
# twenty self-attentions a step as in the T2V finetune (UNET_TRAIN_LAUNCHES,
# unet_train_attn_shapes); the cross-attention over the 145-token I2V context
# stays on the plain path, as in I2V serving. Its LGM-refine finetune (the
# same config with UNet.use_lgm_refine True, batch 1) runs the frozen I2V
# UNet at 24 rows, so its launches a step are the T2V refine step's
# (TRAIN_LAUNCHES, TRAIN_ATTN_SHAPES).
I2V_TRAIN_CFG = "configs/i2vgen_xl_train.yaml"
I2V_TRAIN_STEPS, I2V_TRAIN_BATCH = 3, 2
I2V_TRAIN_LOG_DIR = "workspace/chip_smoke_i2v_train"
I2V_TRAIN_OPTS = ["save_ckp_interval", "0", "viz_interval", "0", "log_dir", I2V_TRAIN_LOG_DIR]
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
# FFN / fused-block backward (autograd.Function) vs autograd through the plain
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
# The two VAE stages run no kernel: they are held against the fp32 arithmetic
# of the served VAE's own (bf16) weights, so that what they measure is the
# bf16 path, not the rounding of the weights (their error against the fp32
# draw, and that rounding's alone, are printed beside them;
# `--phases env,vae_logits` runs the phase with the VAE's attention logits
# formed in bf16 as well, on the same inputs).
REFINE_STAGE_TOL = {"unet": 5e-2, "vae.decode": 5e-2, "lgm": 2.5e-1,
                    "vae.encode_first_stage": 5e-2}
# End to end the stages' errors chain: the bf16 LGM's Gaussians move by up to
# a few pixels, which changes a render of 65,536 random splats by O(1) at
# their edges, so the largest latent error is O(1) (0.56 with the seeded
# weights on an H100); the refined latents are held to a relative L2 error
# |d|/|ref| instead.
REFINE_L2_TOL = 0.5
# The fused spatial block (kernel 5) at the UNet's 32² / C = 320 stage, as
# (rows, context tokens) with its calls per I2V request with the flag on: 50
# CFG forwards at 48 rows over the 145-token I2V context (5 blocks each), the
# `shared` refine's 3 forwards at 24 rows; the 77-token T2V context (250
# calls per plain T2V request with the flag on, which the slice phase serves).
SPATIAL_SHAPES = {(48, 145): 235, (24, 145): 15, (48, 77): 0}
SPATIAL_S, SPATIAL_C, SPATIAL_HEADS, SPATIAL_CC = 1024, 320, 5, 1024
SPATIAL_FLAG = "VIDEOMV_ENABLE_FUSED_SPATIAL"
# the three __global__s of kernel 5's wgmma variant (phases A, B, C)
SPATIAL_WGMMA_KERNELS = ("spatial_ctx_kv_wgmma_kernel", "spatial_front_kv_wgmma_kernel",
                         "spatial_block_wgmma_kernel")
# kernel 3's two variants, each for both payloads: the build phase reports
# their registers, shared memory and spills, and fails on a spill
SPLAT_FWD_KERNELS = tuple(f"{k}<{p}>" for k in ("splat_composite_culled_kernel",
                                                "splat_composite_kernel")
                          for p in ("packed", "fp32"))
# kernel 4's two variants: the same report
SPLAT_BWD_KERNELS = ("splat_composite_bwd_culled_kernel", "splat_composite_bwd_kernel")
# slice F (the variants phase): the two temporal variants as their YAML keys
# select them, the samplers' steps (DDPM's linear_sd cut from 1000 steps for
# the clock), the remat policies held to full's gradient, and each new path's
# launches by shape (filled by the phase, printed in the JSON line)
VARIANT_OPTS = {"rotary": ["UNet.temporal_block", "rotary", "UNet.use_sim_mask", "True",
                           "UNet.temporal_attn_times", "2"],
                "attemask": ["UNet.temporal_block", "attemask"]}
VARIANT_SEED = 21
SAMPLER_STEPS, DDPM_STEPS = 20, 50
REMAT_POLICIES = ("full", "dots_no_batch", "dots")
REMAT_MIN_COS = 0.99999
ADAFACTOR_PARAM_TOL = 1e-6
VARIANT_CALLS = {}
PHASES = ("env", "build", "kernels", "unet", "refine", "slice", "profile", "tracing", "i2v",
          "train", "unet_train", "i2v_train", "dist_train", "batched_serving", "multirank",
          "variants")
# the tracing phase: requests a cell with tracing off and on, in turns; the
# share of the request's device time its top-level spans must cover; how far
# the refine's five stages may sum from the refine, and the sampler.forward
# spans from the UNet's forward hooks
TRACE_TURNS, TRACE_COVER, TRACE_TOL = 3, 0.95, 0.05
TRACE_COST_SPANS = 2000  # spans timed for the host cost of one
# Not part of a plain run: `--phases env,ffn_ablation` times the FFN's wgmma
# kernel at the served 48-row shapes with parts of it compiled out (the
# VMV_NO* switches of csrc/fused_ffn.cu; the results are wrong, the times say
# what each part costs), one child process per build (`ffn_times`).
EXTRA_PHASES = ("ffn_ablation", "ffn_times", "spatial_ablation", "spatial_times",
                "splat_bwd_ablation", "splat_bwd_times", "unet_train_memory", "init_cost",
                "vae_logits", "train_spread")
# `--phases env,spatial_ablation` does the same for kernel 5's wgmma kernels at
# the served I2V shape (the VMV_SP_* switches of csrc/fused_spatial.cu), with
# each __global__'s share from torch.profiler (`spatial_times`).
SPATIAL_ABLATIONS = ("", "VMV_SP_NOLOAD", "VMV_SP_NOKV", "VMV_SP_NOGEMM", "VMV_SP_NOATTN",
                     "VMV_SP_NOEXP", "VMV_SP_NOLOAD,VMV_SP_NOKV",
                     "VMV_SP_NOGEMM,VMV_SP_NOATTN,VMV_SP_NOEXP",
                     "VMV_SP_NOLOAD,VMV_SP_NOKV,VMV_SP_NOGEMM,VMV_SP_NOATTN,VMV_SP_NOEXP")
# `--phases env,splat_bwd_ablation` times kernel 4's culled kernel on the
# kernels phase's two backward calls with parts compiled out or changed (the
# VMV_BWD_* switches of csrc/splat_composite_bwd.cu).
SPLAT_BWD_ABLATIONS = ("", "VMV_BWD_NOWALK", "VMV_BWD_NOREDUCE", "VMV_BWD_NOEXP",
                       "VMV_BWD_NOMEMSET", "VMV_BWD_NOWALK,VMV_BWD_NOMEMSET", "VMV_BWD_IEEEDIV")
FFN_ABLATIONS = ("", "VMV_NOGELU", "VMV_NOG1", "VMV_NOG2", "VMV_NOLOAD",
                 "VMV_NOGELU,VMV_NOG1,VMV_NOG2", "VMV_NOLOAD,VMV_NOGELU,VMV_NOG1,VMV_NOG2")


def fail(phase: str, msg: str) -> None:
    # on both streams: a caller that keeps only the end of stderr sees why
    print(f"[{phase}] FAIL: {msg}", flush=True)
    print(f"[{phase}] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


# the card's state beside a measurement: device times move with its clocks
CLOCKS_QUERY = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active"


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
        f"deps {mods} tf32 off; {CLOCKS_QUERY}: {nvidia_smi_line(CLOCKS_QUERY)}")
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
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln
             or "Performance Loss" in ln]
    for ln in ptxas:
        print(f"  {ln}", flush=True)
    # the wgmma kernels (attention, the FFN, the fused spatial block's three
    # phases) and the splat composite's forward and backward kernels:
    # registers and spills from ptxas, shared memory from ptxas (splat; the
    # culled backward's dynamic shared memory from its entry point) or the
    # wrappers' plans; a spill or a serialised wgmma pipeline in them fails
    # the build phase
    from videomv_tpu_torch.ops import flash_attention as fa
    from videomv_tpu_torch.ops import fused_ffn as ff
    from videomv_tpu_torch.ops import fused_spatial as fs

    entry, found = None, {}
    for ln in ptxas:
        if "Compiling entry" in ln:
            entry = _kernel_name(ln)
        elif "spill" in ln and entry:
            found[entry] = [ln]
        elif "Used" in ln and entry in found:
            found[entry].append(ln)
    bad = [ln for ln in ptxas if "Performance Loss" in ln and "wgmma_kernel" in ln]
    for name, (spill, *used) in found.items():
        say("build", f"{name}: {(used or ['?'])[0].split(':', 1)[-1].strip()}; {spill}")
        if "0 bytes spill stores, 0 bytes spill loads" not in spill:
            bad.append(f"{name} spills: {spill}")
    want = ({"flash_attn_wgmma_kernel", "flash_attn_wgmma_kernel<tail>"}
            | {f"geglu_ffn_wgmma_kernel<{c}>" for c in ff.WGMMA_WIDTHS}
            | set(SPATIAL_WGMMA_KERNELS) | set(SPLAT_FWD_KERNELS) | set(SPLAT_BWD_KERNELS))
    if set(found) != want:
        bad.append(f"expected the kernels {sorted(want)} in the log, found {sorted(found)}")
    if bad and not info["cached"]:
        fail("build", "; ".join(bad))
    say("build", f"flash_attn_wgmma_kernel: {fa.WGMMA_SMEM_BYTES} B dynamic shared, 384 threads "
        f"({fa.WGMMA_Q_ROWS} query rows, {fa.WGMMA_KEYS}-key tiles, {fa.WGMMA_STAGES} stages); "
        f"tensor map of [48,1024,5,64]: {fa.attention_tensor_map(48, 1024, 5, 64)}")
    for c in ff.WGMMA_WIDTHS:
        say("build", f"geglu_ffn_wgmma_kernel<{c}>: {ff.ffn_plan(c)}")
    plan = fs.spatial_plan()
    say("build", f"fused spatial wgmma kernels (C = 320): {SPATIAL_WGMMA_KERNELS[0]} "
        f"{plan['ctx_smem_bytes']} B, {SPATIAL_WGMMA_KERNELS[1]} {plan['front_smem_bytes']} B, "
        f"{SPATIAL_WGMMA_KERNELS[2]} {plan['block_smem_bytes']} B dynamic shared, "
        f"{plan['threads']} threads; plan {plan}")
    say("build", f"{SPLAT_BWD_KERNELS[0]}: "
        f"{_build.load_library().vmv_splat_composite_bwd_smem()} B dynamic shared, 256 threads")
    say("build", f"{info['path']} in {info['seconds']:.1f}s (cached={info['cached']})")


def _kernel_name(line):
    """The name of a wgmma kernel (with ``<N>`` for a template argument), of
    a splat composite forward kernel (``<packed>`` or ``<fp32>`` for its
    payload) or of a backward one from a ptxas "Compiling entry function
    '_ZN...'" line, else None. In the mangled name the identifier follows its
    length in digits, and these kernels' names hold no digit."""
    import re

    m = re.search(r"(splat_composite(?:_culled)?_kernel)ILb([01])E", line)
    if m:
        return m.group(1) + ("<packed>" if m.group(2) == "1" else "<fp32>")
    m = re.search(r"(splat_composite_bwd(?:_culled)?_kernel)", line)
    if m:
        return m.group(1)
    m = re.search(r"(flash_attn_wgmma_kernel)ILb([01])E", line)
    if m:  # the ragged-tail instance apart from the other
        return m.group(1) + ("<tail>" if m.group(2) == "1" else "")
    m = re.search(r"([a-z_]+_wgmma_kernel)(?:ILi(\d+)E)?", line)
    if not m:
        return None
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


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


def _attn_bwd_bound(shape):
    """q, k, v, o and dO read, dQ, dK and dV written in bf16, lse read in
    fp32; the five products (S = QKᵀ, dP = dO Vᵀ, dV, dQ, dK) of 2·S²·D each
    per (batch, head)."""
    b, s, h, d = shape
    return _bound(8 * b * s * h * d * 2 + 4 * b * h * s, 10 * b * h * s * s * d,
                  PEAK_BF16_FLOPS)


def _ffn_bound(t, c, inner):
    n_bytes = 2 * (2 * t * c + 3 * c * inner) + 4 * (2 * inner + c)
    return _bound(n_bytes, 6 * t * c * inner, PEAK_BF16_FLOPS)


def _splat_stats(torch, payload, tile_start, tile_count, nts, block=1 << 17):
    """What a binned render call's composite work depends on: the pairs per
    (view, tile) (mean, p50, p99, max); the (pixel, pair) points of the
    segments and how many are alive (power <= 0 and alpha >= 1/255, the
    twin's ``~dead``, rounded op by op as the kernels do); and the share of
    (warp block, pair) combinations that hold an alive point, for the
    per-tile kernel's warps (two rows of 16 pixels) and the culled kernel's
    (8 x 4 pixels), beside the share the culled kernel's masks keep
    (``splat.cull_masks``) and the alive points the masks miss (must be 0).
    Each in-segment pair is taken against the 256 pixels of its tile."""
    from videomv_tpu_torch.ops import splat

    R, rows, _ = payload.shape
    dev = payload.device
    counts = tile_count.reshape(-1).float()
    p50, p99 = torch.quantile(counts, torch.tensor([0.5, 0.99], device=dev)).tolist()
    masks = splat.cull_masks(payload, tile_start, tile_count, nts)
    bit = torch.arange(8, device=dev)
    pix = torch.arange(splat.TILE * splat.TILE, device=dev)
    ox, oy = (pix % splat.TILE).float(), (pix // splat.TILE).float()
    alive = rows2 = blocks = kept = missed = 0
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
            al = (power <= 0.0) & (alpha >= 1.0 / 255.0)             # [m, 256]
            alive += int(al.sum())
            rows2 += int(al.view(-1, 8, 32).any(-1).sum())
            # pixel (by·4 + ry)·16 + bx·8 + rx -> block by·2 + bx
            blk = al.view(-1, 4, 4, 2, 8).any(4).any(2).reshape(-1, 8)
            blocks += int(blk.sum())
            keep = ((masks[r, a:a + idx.numel()].long()[:, None] >> bit) & 1).bool()
            kept += int(keep.sum())
            missed += int((blk & ~keep).sum())
    live = int(tile_count.sum())
    return dict(tiles=counts.numel(), pairs_per_tile_mean=counts.mean().item(),
                pairs_per_tile_p50=p50, pairs_per_tile_p99=p99,
                pairs_per_tile_max=int(counts.max()), live_pairs=live, points=256 * live,
                alive_points=alive, alive_share=alive / max(256 * live, 1),
                rows2_block_share=rows2 / max(8 * live, 1),
                block8x4_share=blocks / max(8 * live, 1),
                mask_kept_share=kept / max(8 * live, 1), mask_missed_alive_blocks=missed)


def _say_splat_stats(phase, what, st):
    say(phase, f"splat_stats {what}: pairs per (view, tile) over {st['tiles']} items mean "
        f"{st['pairs_per_tile_mean']:.1f} p50 {st['pairs_per_tile_p50']:.0f} p99 "
        f"{st['pairs_per_tile_p99']:.0f} max {st['pairs_per_tile_max']}; live pairs "
        f"{st['live_pairs']}, alive (pixel, pair) points {st['alive_points']} of "
        f"{st['points']} = {100 * st['alive_share']:.2f}%; (warp block, pair) combinations "
        f"holding an alive point: 16x2 blocks {100 * st['rows2_block_share']:.2f}%, 8x4 "
        f"blocks {100 * st['block8x4_share']:.2f}%; kept by the culled kernel's masks "
        f"{100 * st['mask_kept_share']:.2f}%; alive blocks the masks miss "
        f"{st['mask_missed_alive_blocks']}")
    if st["mask_missed_alive_blocks"]:
        fail(phase, f"splat culling masks miss alive points ({what})")


def _splat_bound(views, rows, capacity, tiles, live_pairs, alive_points, backward=False):
    """(bound_ms, bound_by, walk_ms). The least work (see SPLAT_POINT_OPS):
    the composite reads the rows it needs of each live pair's payload once
    (the 8 packed rows, or 10 of the 16 fp32 rows: the other 6 are zero
    padding) and the tile lists and writes [views, tiles, 5, 256]; the
    backward reads the 10 live rows and
    two such tile tensors and writes all of dpayload [views, 16, capacity];
    operations only at the alive points. walk_ms is the operations' time
    under the segment-walk count (alpha rebuilt at every in-segment point),
    the work the twin and the per-tile kernels do."""
    out_bytes = views * tiles * 5 * 256 * 4
    lists = 2 * views * tiles * 4
    alive_ops = SPLAT_BWD_ALIVE_OPS if backward else SPLAT_FWD_ALIVE_OPS
    walk_ms = 1e3 * (live_pairs * 256 * SPLAT_POINT_OPS + alive_points * alive_ops) / PEAK_FP32_FLOPS
    if backward:
        n_bytes = live_pairs * 10 * 4 + lists + 2 * out_bytes + views * 16 * capacity * 4
    else:
        n_bytes = live_pairs * (8 if rows == 8 else 10) * 4 + lists + out_bytes
    return (*_bound(n_bytes, alive_points * (SPLAT_POINT_OPS + alive_ops), PEAK_FP32_FLOPS),
            walk_ms)


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


def _splat_variants(torch, payload, ts, tc, nts, kern, phase, what):
    """The served (culled) composite kernel against the per-tile kernel of
    the first port on one binned render call: their outputs must be
    bit-equal; CUDA-event times in turns (culled, per-tile, per-tile,
    culled), and the culled kernel alone, in turns, on the heaviest-first
    order made beforehand (``splat.heaviest_first``) and on index order: the
    first against the served call gives what forming the order inside the
    call costs, the second what the schedule gains."""
    from videomv_tpu_torch.ops import splat

    old = splat._composite_forward(payload, ts, tc, nts, variant=splat.VARIANT_PER_TILE)
    torch.cuda.synchronize()
    same = torch.equal(kern, old)
    diff = (kern - old).abs().max().item()
    other_ms, served_ms = _time_turns(
        torch, lambda: splat.composite(payload, ts, tc, nts),
        lambda: splat._composite_forward(payload, ts, tc, nts, variant=splat.VARIANT_PER_TILE),
        iters=10)
    # the schedule: the culled kernel alone on the heaviest-first order made
    # beforehand, and on the items in index order
    order = splat.heaviest_first(tc)
    index = torch.arange(tc.numel(), dtype=torch.int32, device=tc.device)
    same = same and all(torch.equal(splat._composite_forward(payload, ts, tc, nts, order=o), kern)
                        for o in (order, index))
    index_ms, sorted_ms = _time_turns(
        torch, lambda: splat._composite_forward(payload, ts, tc, nts, order=order),
        lambda: splat._composite_forward(payload, ts, tc, nts, order=index), iters=10)
    say(phase, f"splat_composite {what}, in turns: culled {served_ms:.4f} ms, per-tile "
        f"{other_ms:.4f} ms ({other_ms / served_ms:.2f}x); the culled kernel alone, in "
        f"turns, on the heaviest-first order made beforehand {sorted_ms:.4f} ms and on "
        f"index order {index_ms:.4f} ms; outputs "
        f"bit-equal {same} (max|d| {diff:.1e}) {'ok' if same else 'FAIL'}")
    if not same:
        fail(phase, f"splat composite: the culled and per-tile kernels differ ({what})")
    del old
    return dict(variant=splat.VARIANT_NAMES[splat.VARIANT_CULLED], other_variant_ms=other_ms,
                served_variant_ms_in_turns=served_ms,
                presorted_ms=sorted_ms, index_order_ms=index_ms,
                other_variant_bit_equal=same)


def _splat_kernel_checks(torch, dev):
    """Kernel 3 against its twin and against the per-tile kernel on one
    24-view render call (both payloads), on the batched refine's call over
    BATCH_PROMPTS x 24 views and on one view chunk of the train step, the
    binned render of one view against the dense oracle, and kernel 4 against
    its twin on the 24-view and the train step's calls. Returns the
    forward's and the backward's runs."""
    from videomv_tpu_torch import ops
    from videomv_tpu_torch.ops import gaussian_splat as tgs
    from videomv_tpu_torch.ops import splat

    cap = tgs.pair_capacity(SPLAT_GAUSSIANS, SPLAT_SIZE)
    nts = SPLAT_SIZE // splat.TILE
    runs = []
    for packed, views in ((True, SPLAT_VIEWS), (False, SPLAT_VIEWS),
                          (True, BATCH_PROMPTS * SPLAT_VIEWS)):
        g, cv, cvp, tan = _synthetic_scene(torch, dev, views=views)
        prep = {k: v[:, None] for k, v in tgs.prepare_gaussians(g).items()}
        proj = [p[0] for p in tgs.project_prepared(prep, cv, cvp, SPLAT_SIZE, tan)]
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
        rows = payload.shape[1]
        what = f"{rows}-row payload, {views} views at {SPLAT_SIZE}²"
        st = _splat_stats(torch, payload, ts, tc, nts)
        _say_splat_stats("kernels", what, st)
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
        alive = st["alive_points"]
        bound_ms, bound_by, walk_ms = _splat_bound(views, rows, cap, nts * nts, sum(pairs), alive)
        single = packed and views == SPLAT_VIEWS
        runs.append(dict(shape=[views, rows, cap], calls_per_request=3 if single else 0,
                         calls_per_train_step=0,
                         **dict(_slice_e_calls("splat_composite", ()),
                                calls_per_batched_refined_request=3 if views > SPLAT_VIEWS else 0),
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                         share_of_bound=bound_ms / ms, segment_walk_ms=walk_ms,
                         live_pairs=[min(pairs), sum(pairs) // len(pairs), max(pairs)],
                         alive_points=alive, alive_share=st["alive_share"],
                         capacity=cap, max_tile_pairs=int(tc.max()), splat_stats=st))
        say("kernels", f"splat_composite {what} x {nts ** 2} tiles, {SPLAT_GAUSSIANS} "
            f"Gaussians: live pairs per view min/mean/max "
            f"{min(pairs)}/{sum(pairs) // len(pairs)}/{max(pairs)} of capacity {cap}; binning "
            f"{bin_s * 1e3:.1f} ms, peak {bin_gib:.3f} GiB; |k-twin| {err:.3e} (bound "
            f"{SPLAT_TOL:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} "
            f"ms ({bound_by}; {100 * bound_ms / ms:.1f}%), segment-walk count {walk_ms:.4f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("kernels", f"splat composite ({rows} rows) outside its error bound")
        runs[-1].update(_splat_variants(torch, payload, ts, tc, nts, kern, "kernels", what))
        if not packed:
            bwd_runs = [_splat_bwd_check(torch, payload, ts, tc, kern, nts, sum(pairs), alive,
                                         f"{SPLAT_VIEWS} views at {SPLAT_SIZE}²", 0)]
        del payload, ts, tc, kern, twin, proj, prep
    # the binned render (kernel, fp32 payload) against the dense oracle, view 0
    g, cv, cvp, tan = _synthetic_scene(torch, dev)
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
    del g, cv, cvp, binned, dense

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
    what = f"16-row payload, {views} views at {size}²"
    st = _splat_stats(torch, payload, ts, tc, nts)
    _say_splat_stats("kernels", what, st)
    kern = splat.composite(payload, ts, tc, nts)
    twin = splat.composite_reference(payload, ts, tc, nts)
    err = (kern - twin).abs().max().item()
    ms, plain_ms = _time_turns(torch, lambda: splat.composite_reference(payload, ts, tc, nts),
                               lambda: splat.composite(payload, ts, tc, nts), iters=3)
    alive = st["alive_points"]
    bound_ms, bound_by, walk_ms = _splat_bound(views, 16, cap, nts * nts, live, alive)
    ok = err <= SPLAT_TOL
    runs.append(dict(shape=[views, 16, cap], calls_per_request=0,
                     calls_per_train_step=TRAIN_LAUNCHES["splat_composite"],
                     **_slice_e_calls("splat_composite", ()), max_abs_err=err,
                     ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=None, share_of_bound=bound_ms / ms, segment_walk_ms=walk_ms,
                     live_pairs=[live // views], alive_points=alive,
                     alive_share=st["alive_share"], capacity=cap,
                     max_tile_pairs=int(tc.max()), splat_stats=st))
    say("kernels", f"splat_composite {what} x {nts ** 2} tiles: demanded pairs per view "
        f"{pairs.tolist()}, live {live} of capacity {views} x {cap}; |k-twin| {err:.3e} (bound "
        f"{SPLAT_TOL:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms "
        f"({bound_by}; {100 * bound_ms / ms:.1f}%), segment-walk count {walk_ms:.4f} ms "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("kernels", "splat composite (512²) outside its error bound")
    runs[-1].update(_splat_variants(torch, payload, ts, tc, nts, kern, "kernels", what))
    bwd_runs.append(_splat_bwd_check(torch, payload, ts, tc, kern, nts, live, alive,
                                     f"{views} views at {size}²",
                                     TRAIN_LAUNCHES["splat_composite_bwd"]))
    return runs, bwd_runs


def _splat_bwd_check(torch, payload, ts, tc, saved, nts, live_pairs, alive_points, what,
                     calls_per_step):
    """Kernel 4 against its twin on a binned render call: dpayload from the
    same payload, segments, forward output and a seeded gradient, from the
    served (culled) kernel and from the per-tile kernel of the first port,
    each against the twin; then CUDA-event times in turns: the served kernel
    against the per-tile one, and the culled kernel alone on the
    heaviest-first order made beforehand against index order."""
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
    old = splat.composite_backward(payload, ts, tc, saved, grad, nts,
                                   variant=splat.BWD_VARIANT_PER_TILE)
    old_err = (old - twin).abs().max().item()
    dead = max(kern[:, 10:].abs().max().item(), old[:, 10:].abs().max().item())
    # outside every segment: the columns past each view's last one
    ends = (ts[:, -1] + tc[:, -1]).tolist()
    tail = max((kern[r, :, e:].abs().max().item() for r, e in enumerate(ends)
                if e < payload.shape[-1]), default=0.0)
    # one writer per pair, no atomics: two launches give the same bits
    again = torch.equal(splat.composite_backward(payload, ts, tc, saved, grad, nts), kern)
    # through autograd (the Function the render path uses) the same gradient
    p = payload.clone().requires_grad_()
    (auto,) = torch.autograd.grad(splat.composite(p, ts, tc, nts), p, grad)
    same = torch.equal(auto, kern)
    order = splat.heaviest_first(tc)
    index = torch.arange(tc.numel(), dtype=torch.int32, device=tc.device)
    fixed = all(torch.equal(splat.composite_backward(payload, ts, tc, saved, grad, nts, order=o),
                            kern) for o in (order, index))
    del twin, p, auto, old
    ms, plain_ms = _time_turns(
        torch, lambda: splat.composite_backward_reference(payload, ts, tc, saved, grad, nts),
        lambda: splat.composite_backward(payload, ts, tc, saved, grad, nts), iters=2)
    # _time_turns returns (the second callable's ms, the first's)
    served_ms, other_ms = _time_turns(
        torch, lambda: splat.composite_backward(payload, ts, tc, saved, grad, nts,
                                                variant=splat.BWD_VARIANT_PER_TILE),
        lambda: splat.composite_backward(payload, ts, tc, saved, grad, nts), iters=10)
    sorted_ms, index_ms = _time_turns(
        torch, lambda: splat.composite_backward(payload, ts, tc, saved, grad, nts, order=index),
        lambda: splat.composite_backward(payload, ts, tc, saved, grad, nts, order=order),
        iters=10)
    R, rows, cap = payload.shape
    bound_ms, bound_by, walk_ms = _splat_bound(R, rows, cap, nts * nts, live_pairs,
                                               alive_points, backward=True)
    ok = (err <= SPLAT_BWD_TOL * scale and old_err <= SPLAT_BWD_TOL * scale and dead == 0.0
          and tail == 0.0 and again and same and fixed)
    say("kernels", f"splat_composite_bwd {what}, {live_pairs} live pairs, {alive_points} alive "
        f"(pixel, pair) points: max|k-twin| culled {err:.3e}, per-tile {old_err:.3e}, of "
        f"max|grad| {scale:.3e} = {err / scale:.3e} / {old_err / scale:.3e} (bound "
        f"{SPLAT_BWD_TOL:.0e}); culled by row, relative to the row's largest: "
        f"{['%.1e' % e for e in by_row]}; rows 10-15 max {dead:.1e}, past the segments max "
        f"{tail:.1e}; two launches bit-equal {again}; autograd path bit-identical {same}; "
        f"the same bits on a given order {fixed}; kernel {ms:.4f} "
        f"ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}; "
        f"{100 * bound_ms / ms:.1f}%), segment-walk count {walk_ms:.4f} ms; in turns: culled "
        f"{served_ms:.4f} ms, per-tile {other_ms:.4f} ms ({other_ms / served_ms:.2f}x); the "
        f"culled kernel on the heaviest-first order made beforehand {sorted_ms:.4f} ms, on "
        f"index order {index_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("kernels", f"splat composite backward ({what}) outside its error bound")
    return dict(shape=[R, rows, cap], calls_per_request=0, calls_per_train_step=calls_per_step,
                **_slice_e_calls("splat_composite_bwd", ()),
                max_abs_err=err, rel_err=err / scale, per_tile_rel_err=old_err / scale, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                share_of_bound=bound_ms / ms, segment_walk_ms=walk_ms, live_pairs=live_pairs,
                alive_points=alive_points, alive_share=alive_points / (256 * live_pairs),
                variant=splat.BWD_VARIANT_NAMES[splat.BWD_VARIANT_CULLED],
                other_variant_ms=other_ms, served_variant_ms_in_turns=served_ms,
                presorted_ms=sorted_ms, index_order_ms=index_ms)


class _FusedSpatialFlag:
    """Within ``with``, the fused spatial block's environment switch is set
    (``on``) or unset, and restored after."""

    def __init__(self, on):
        self._on = on

    def __enter__(self):
        self._prev = os.environ.pop(SPATIAL_FLAG, None)
        if self._on:
            os.environ[SPATIAL_FLAG] = "1"

    def __exit__(self, *exc):
        os.environ.pop(SPATIAL_FLAG, None)
        if self._prev is not None:
            os.environ[SPATIAL_FLAG] = self._prev


def _spatial_bound(r, s, c, kv_len, cc, iff):
    """x read and the output written once in bf16, the context and the
    weights read once; the products of proj_in / proj_out, q/k/v/out of both
    attentions (k2/v2 over the context), both attentions' logits and PV, and
    the three feed-forward products."""
    weights = 2 * (8 * c * c + 2 * c * cc + 3 * c * iff) + 4 * (13 * c + 2 * iff)
    n_bytes = 2 * (2 * r * s * c + r * kv_len * cc) + weights
    flops = (2 * r * s * c * c * 8 + 2 * r * kv_len * cc * c * 2
             + 4 * r * s * (s + kv_len) * c + 6 * r * s * c * iff)
    return _bound(n_bytes, flops, PEAK_BF16_FLOPS)


def _spatial_kernel_checks(torch, dev):
    """Kernel 5 against its fp32 twin at the served shapes, beside the bf16
    module path (kernels 1 + 2 + PyTorch ops) for the same block: seeded
    weights with proj_out not zeroed (a zero proj_out returns x and checks
    nothing)."""
    from videomv_tpu_torch import ops
    from videomv_tpu_torch.models.blocks import SpatialTransformer
    from videomv_tpu_torch.ops import fused_spatial as fs
    from videomv_tpu_torch.ops.fused_spatial import (
        fused_spatial_transformer, spatial_block_reference, spatial_params)
    from videomv_tpu_torch.training.checkpoints import init_weights

    s, c, heads, cc = SPATIAL_S, SPATIAL_C, SPATIAL_HEADS, SPATIAL_CC
    side = int(math.isqrt(s))
    mod = init_weights(SpatialTransformer(c, heads, 64, depth=1, context_dim=cc), seed=5,
                       zero_init=False)
    mod = mod.to(device=dev, dtype=torch.bfloat16).eval().requires_grad_(False)
    params = spatial_params(mod, vector_dtype=torch.float32)
    iff = params["w2"].shape[1]
    gen = torch.Generator(device=dev).manual_seed(5)
    runs = []
    for (r, kv_len), calls in SPATIAL_SHAPES.items():
        x4 = torch.randn((r, c, side, side), generator=gen, device=dev).to(torch.bfloat16)
        ctx = torch.randn((r, kv_len, cc), generator=gen, device=dev).to(torch.bfloat16)
        x = x4.permute(0, 2, 3, 1).contiguous().view(r, s, c)

        def module_path():
            with _FusedSpatialFlag(False):
                return mod(x4, ctx)

        with torch.no_grad():
            ops.reset_launch_counts()
            kern = fused_spatial_transformer(x, ctx, params, heads)
            torch.cuda.synchronize()
            if ops.launch_counts() != dict(_ZERO_COUNTS, fused_spatial=1):
                fail("kernels", f"fused_spatial {(r, kv_len)}: counters {ops.launch_counts()}")
            if not torch.equal(fused_spatial_transformer(x, ctx, params, heads), kern):
                fail("kernels", f"fused_spatial {(r, kv_len)}: two launches differ")
            served = fs.spatial_variant(r, s, c, kv_len, cc, heads, iff)
            other = fs.VARIANT_MMA + fs.VARIANT_WGMMA - served
            old = fs._launch(x, ctx, params, heads, variant=other).float()
            twin = spatial_block_reference(x, ctx, params, heads).float()
            if any(ops.launch_counts()[k] for k in ("flash_attention", "geglu_ffn")):
                fail("kernels", "the fused block's twin launched a kernel")
            module = module_path().permute(0, 2, 3, 1).reshape(r, s, c)
            mod_counts = ops.launch_counts()
            k_err = (kern.float() - twin).abs().max().item()
            m_err = (module.float() - twin).abs().max().item()
            o_err = (old - twin).abs().max().item()
            # through the module's own dispatch, flag on: the same bits
            ops.reset_launch_counts()
            with _FusedSpatialFlag(True):
                via = mod(x4, ctx).permute(0, 2, 3, 1).reshape(r, s, c)
            same = torch.equal(via, kern) and ops.launch_counts()["fused_spatial"] == 1
            scale = twin.abs().max().item()
            del twin, module, via, old
            ms, plain_ms = _time_turns(
                torch, lambda: spatial_block_reference(x, ctx, params, heads),
                lambda: fused_spatial_transformer(x, ctx, params, heads), iters=5)
            module_ms = _time_one(torch, module_path, iters=5)
            # the other hand-written kernel on the same input, in turns with
            # the serving one (served, other, other, served)
            other_ms, served_ms = _time_turns(
                torch, lambda: fs._launch(x, ctx, params, heads, variant=served),
                lambda: fs._launch(x, ctx, params, heads, variant=other), iters=10)
        ok = k_err <= 2 * m_err + KERNEL_EPS and o_err <= 2 * m_err + KERNEL_EPS and same
        bound_ms, bound_by = _spatial_bound(r, s, c, kv_len, cc, iff)
        runs.append(dict(shape=[r, s, c, kv_len], calls_per_request=calls,
                         calls_per_train_step=0, **_slice_e_calls("fused_spatial", ()),
                         max_abs_err=k_err, module_err_vs_twin=m_err,
                         ms=ms, plain_ms=plain_ms, module_ms=module_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None, variant=fs.VARIANT_NAMES[served],
                         share_of_bound=bound_ms / ms, other_variant_ms=other_ms,
                         other_variant_err=o_err, served_variant_ms_in_turns=served_ms))
        say("kernels", f"fused_spatial x [{r}, {s}, {c}] ctx [{r}, {kv_len}, {cc}] "
            f"({fs.VARIANT_NAMES[served]} kernel, {100 * bound_ms / ms:.1f}% of its bound): "
            f"|k-twin(fp32)| {k_err:.3e}, the {fs.VARIANT_NAMES[other]} kernel's {o_err:.3e}, "
            f"bf16 module path |m-twin| {m_err:.3e} (bound 2x + {KERNEL_EPS:.0e}), "
            f"max|twin| {scale:.3e}, module dispatch bit-identical {same}; kernel {ms:.4f} ms "
            f"plain twin (fp32) {plain_ms:.4f} ms module path (kernels 1 + 2 + PyTorch ops, "
            f"launches {mod_counts['flash_attention']} + {mod_counts['geglu_ffn']}) "
            f"{module_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}); in turns with the other "
            f"hand-written kernel: serving {served_ms:.4f} ms, other ({fs.VARIANT_NAMES[other]}) "
            f"{other_ms:.4f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("kernels", f"fused_spatial {(r, kv_len)} outside its error bound")
        del x4, x, ctx, kern
    # backward through the autograd.Function (kernel forward, twin recompute)
    r, kv_len = 2, 145
    x = (torch.randn((r, s, c), generator=gen, device=dev)).to(torch.bfloat16).requires_grad_()
    ctx = torch.randn((r, kv_len, cc), generator=gen, device=dev).to(torch.bfloat16)
    go = torch.randn((r, s, c), generator=gen, device=dev).to(torch.bfloat16)
    pg = {k: v.clone().requires_grad_() for k, v in params.items()}
    ops.reset_launch_counts()
    got = torch.autograd.grad(fused_spatial_transformer(x, ctx, pg, heads),
                              [x, *pg.values()], go)
    if ops.launch_counts()["fused_spatial"] != 1:
        fail("kernels", "fused_spatial backward: the forward did not launch")
    want = torch.autograd.grad(spatial_block_reference(x, ctx, pg, heads), [x, *pg.values()], go)
    err = max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
              for g, w in zip(got, want))
    say("kernels", f"fused_spatial backward [{r}, {s}, {c}]: dx and the 26 parameter gradients vs "
        f"autograd of the twin, relative max {err:.3e} (bound {TWIN_BWD_TOL:.0e}) "
        f"{'ok' if err <= TWIN_BWD_TOL else 'FAIL'}")
    if not err <= TWIN_BWD_TOL:
        fail("kernels", "fused_spatial backward differs from its twin's")
    torch.cuda.empty_cache()
    return runs


_ZERO_COUNTS = {"flash_attention": 0, "flash_attention_bwd": 0, "geglu_ffn": 0,
                "splat_composite": 0, "splat_composite_bwd": 0, "fused_spatial": 0}


def phase_ffn_times(torch, defines):
    """CUDA-event ms of the FFN kernel at the served 48-row shapes, built
    with ``defines``."""
    from videomv_tpu_torch.ops.fused_ffn import geglu_ffn

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = []
    for t, c, inner in list(FFN_SHAPES)[:3]:
        x = torch.randn(t, c, generator=gen, device=dev).bfloat16()
        w1 = (torch.randn(2 * inner, c, generator=gen, device=dev) * c ** -0.5).bfloat16()
        w2 = (torch.randn(c, inner, generator=gen, device=dev) * inner ** -0.5).bfloat16()
        b1 = torch.randn(2 * inner, generator=gen, device=dev) * 0.1
        b2 = torch.randn(c, generator=gen, device=dev) * 0.1
        ms = _time_one(torch, lambda: geglu_ffn(x, w1, b1, w2, b2))
        times.append(f"[T={t}, C={c}] {ms:.4f} ms")
    say("ffn_times", f"built with {defines or 'no switch'}: " + "; ".join(times))


def phase_spatial_times(torch, defines):
    """CUDA-event ms of kernel 5 at the served I2V shape (48 rows, context
    145), built with ``defines``, and each of its __global__s' device time
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from videomv_tpu_torch.models.blocks import SpatialTransformer
    from videomv_tpu_torch.ops.fused_spatial import fused_spatial_transformer, spatial_params
    from videomv_tpu_torch.training.checkpoints import init_weights

    dev = torch.device("cuda", 0)
    s, c, heads, cc, r, kv_len = SPATIAL_S, SPATIAL_C, SPATIAL_HEADS, SPATIAL_CC, 48, 145
    mod = init_weights(SpatialTransformer(c, heads, 64, depth=1, context_dim=cc), seed=5,
                       zero_init=False).to(device=dev, dtype=torch.bfloat16).eval()
    params = spatial_params(mod.requires_grad_(False), vector_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((r, s, c), generator=gen, device=dev).to(torch.bfloat16)
    ctx = torch.randn((r, kv_len, cc), generator=gen, device=dev).to(torch.bfloat16)
    with torch.no_grad():
        ms = _time_one(torch, lambda: fused_spatial_transformer(x, ctx, params, heads))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fused_spatial_transformer(x, ctx, params, heads)
            torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = next((k for k in ("gn_stats",) + SPATIAL_WGMMA_KERNELS if k in e.name), e.name)
            by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us() / 5e3
    say("spatial_times", f"built with {defines or 'no switch'}: x [{r}, {s}, {c}] ctx [{r}, "
        f"{kv_len}, {cc}] {ms:.4f} ms; by kernel (ms) "
        + ", ".join(f"{k} {v:.4f}" for k, v in by_kernel.items()))


def phase_splat_bwd_times(torch, defines):
    """CUDA-event ms of kernel 4's culled kernel, built with ``defines``, on
    the 16-row 24-view 256² call and the 2-view 512² chunk of the kernels
    phase, with the heaviest-first order formed in the call."""
    from videomv_tpu_torch.ops import gaussian_splat as tgs
    from videomv_tpu_torch.ops import splat

    dev = torch.device("cuda", 0)
    times = []
    for size, views in ((SPLAT_SIZE, SPLAT_VIEWS), (TRAIN_RENDER_SIZE, TRAIN_VIEW_CHUNK)):
        g, cv, cvp, tan = _synthetic_scene(torch, dev, size=size, views=views)
        prep = {k: v[:, None] for k, v in tgs.prepare_gaussians(g).items()}
        proj = [p[0] for p in tgs.project_prepared(prep, cv, cvp, size, tan)]
        payload, ts, tc, _ = splat.bin_pairs(*proj, img_size=size,
                                             max_pairs=tgs.pair_capacity(SPLAT_GAUSSIANS, size))
        nts = size // splat.TILE
        saved = splat.composite(payload, ts, tc, nts)
        grad = torch.randn(saved.shape, generator=torch.Generator(device=dev).manual_seed(4),
                           device=dev)
        ms = _time_one(torch, lambda: splat.composite_backward(payload, ts, tc, saved, grad, nts))
        times.append(f"{views} views at {size}² {ms:.4f} ms")
    from videomv_tpu_torch.ops import _build

    log = str(_build.build_info()["log"]).splitlines()
    at = next(i for i, ln in enumerate(log) if "splat_composite_bwd_culled_kernel" in ln)
    regs = next(ln.split(":", 1)[-1].strip() for ln in log[at:] if "registers" in ln)
    say("splat_bwd_times", f"built with {defines or 'no switch'} ({regs}): " + "; ".join(times))


def _ablation(kind, variants):
    """One child process per build of the kernels with the switches named in
    each of ``variants``; the children build all at once, then time in turn."""
    cmd = [sys.executable, os.path.abspath(__file__), "--phases", f"{kind}_times"]
    builds = [subprocess.Popen(cmd + ["--build-only"] + (["--define", d] if d else []),
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for d in variants]
    for d, b in zip(variants, builds):
        out = b.communicate(timeout=900)[0]
        if b.returncode != 0:
            fail(f"{kind}_ablation", f"{d}: build exit {b.returncode}\n{out[-2000:]}")
    for defines in variants:
        out = subprocess.run(cmd + (["--define", defines] if defines else []),
                             capture_output=True, text=True, timeout=600)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith(f"[{kind}_times]")]
        if out.returncode != 0 or not lines:
            fail(f"{kind}_ablation", f"{defines}: exit {out.returncode}\n{out.stdout[-2000:]}"
                 f"\n{out.stderr[-2000:]}")
        print(lines[-1], flush=True)


def phase_ffn_ablation():
    _ablation("ffn", FFN_ABLATIONS)


def phase_kernels(torch, only=None):
    from videomv_tpu_torch import ops
    from videomv_tpu_torch.ops import flash_attention as fa
    from videomv_tpu_torch.ops import fused_ffn as ff
    from videomv_tpu_torch.ops.flash_attention import (
        attention_backward_reference, attention_lse_reference, attention_reference,
        flash_attention)
    from videomv_tpu_torch.ops.fused_ffn import geglu_ffn, geglu_ffn_reference

    dev = torch.device("cuda", 0)
    def chosen(name):  # --kernels cuts the phase to the named kernels
        return only is None or name in only

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    results = {name: [] for name in ("flash_attention", "flash_attention_bwd", "geglu_ffn")
               if chosen(name)}

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

    # the served shapes, then the unet_train phase's own and the batched
    # program's (twice a request's rows)
    attn_shapes = dict.fromkeys([
        *ATTN_SHAPES, *(s for rows in UNET_TRAIN_CHECK_ROWS for s in unet_train_attn_shapes(rows)),
        *BATCHED_REFINED_BY_SHAPE["flash_attention"]])
    for shape in (attn_shapes if chosen("flash_attention") else ()):
        q, k, v = (randn(*shape) for _ in range(3))
        ops.reset_launch_counts()
        kern = flash_attention(q, k, v)
        torch.cuda.synchronize()
        if ops.launch_counts()["flash_attention"] != 1:
            fail("kernels", f"attention {shape}: launch counter did not move")
        if not torch.equal(flash_attention(q, k, v), kern):  # one writer per element
            fail("kernels", f"attention {shape}: two launches differ")
        twin = attention_reference(q, k, v)
        ref32 = attention_reference(q.float(), k.float(), v.float())
        k_err, t_err, kt = errs(kern, twin, ref32)
        ms, plain_ms = _time_turns(torch, lambda: attention_reference(q, k, v),
                                   lambda: flash_attention(q, k, v))
        ok = k_err <= 2 * t_err + KERNEL_EPS and kt <= KERNEL_VS_TWIN_TOL
        # the other hand-written kernel on the same input, in turns with the
        # serving one: the dispatch by shape must have picked the faster
        served = fa.attention_variant(*shape)
        other_ms, served_ms = _time_turns(  # (second, first)
            torch, lambda: fa._launch(q, k, v, variant=served),
            lambda: fa._launch(q, k, v, variant=fa.VARIANT_MMA + fa.VARIANT_WGMMA - served))
        # the yardstick: one library call for the same function (the port
        # never calls it); it takes [B, H, S, D]
        qt, kt_, vt = (a.transpose(1, 2) for a in (q, k, v))
        lib_err = (F.scaled_dot_product_attention(qt, kt_, vt).transpose(1, 2).float()
                   - ref32).abs().max().item()
        library_ms = _time_one(torch, lambda: F.scaled_dot_product_attention(qt, kt_, vt))
        bound_ms, bound_by = _attn_bound(shape)
        results["flash_attention"].append(dict(
            shape=list(shape), calls_per_request=ATTN_SHAPES.get(shape, 0),
            calls_per_train_step=TRAIN_ATTN_SHAPES.get(shape, 0),
            **_slice_e_calls("flash_attention", shape), err_vs_fp32=k_err,
            twin_err_vs_fp32=t_err, max_abs_err=kt, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            variant=fa.VARIANT_NAMES[served], share_of_bound=bound_ms / ms,
            other_variant_ms=other_ms, served_variant_ms_in_turns=served_ms))
        say("kernels", f"flash_attention {list(shape)} ({fa.VARIANT_NAMES[served]} "
            f"kernel, {100 * bound_ms / ms:.1f}% of its bound): |k-fp32| {k_err:.3e} "
            f"|twin-fp32| {t_err:.3e} |k-twin| {kt:.3e} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) library call "
            f"(scaled_dot_product_attention) {library_ms:.4f} ms, its |fp32| error "
            f"{lib_err:.3e}; in turns with the other hand-written kernel: serving "
            f"{served_ms:.4f} ms, other {other_ms:.4f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("kernels", f"flash_attention {shape} outside its error bound")
        del q, k, v, kern, twin, ref32, qt, kt_, vt

    # SV3D's shapes, S % 128 != 0: the wgmma kernel's masked last tile (the
    # mma.sync kernel takes only 5,184, S % 64 == 0, and is timed there in
    # turns); the plain twin and fp32 in chunks of SV3D_TWIN_ROWS rows (whole,
    # their [B, H, S, S] logits would take 45 GB at 5,184 tokens), the twin's
    # time the sum of its chunks'
    sv3d_s = 0.0  # seconds of the SV3D rows, attention and FFN
    for shape in (SV3D_ATTN_SHAPES if chosen("flash_attention") else ()):
        row_t0 = time.time()
        q, k, v = (randn(*shape) for _ in range(3))
        ops.reset_launch_counts()
        kern = flash_attention(q, k, v)
        torch.cuda.synchronize()
        if ops.launch_counts_by_shape()["flash_attention"] != {shape: 1}:
            fail("kernels", f"attention {shape}: launch counter did not move")
        if not torch.equal(flash_attention(q, k, v), kern):
            fail("kernels", f"attention {shape}: two launches differ")
        k_err = t_err = kt = plain_ms = 0.0
        for r0 in range(0, shape[0], SV3D_TWIN_ROWS):
            sl = slice(r0, r0 + SV3D_TWIN_ROWS)
            qc, kc, vc = q[sl], k[sl], v[sl]
            twin = attention_reference(qc, kc, vc)
            ref32 = attention_reference(qc.float(), kc.float(), vc.float())
            e = errs(kern[sl], twin, ref32)
            k_err, t_err, kt = max(k_err, e[0]), max(t_err, e[1]), max(kt, e[2])
            del twin, ref32
            plain_ms += _time_one(torch, lambda: attention_reference(qc, kc, vc), 3)
        ms = _time_one(torch, lambda: flash_attention(q, k, v))
        ok = k_err <= 2 * t_err + KERNEL_EPS and kt <= KERNEL_VS_TWIN_TOL
        served = fa.attention_variant(*shape)
        other = fa.VARIANT_MMA + fa.VARIANT_WGMMA - served
        other_ms = served_ms = None
        if fa.variant_takes(other, shape[1], shape[3]):
            other_ms, served_ms = _time_turns(
                torch, lambda: fa._launch(q, k, v, variant=served),
                lambda: fa._launch(q, k, v, variant=other))
        qt, kt_, vt = (a.transpose(1, 2) for a in (q, k, v))
        library_ms = _time_one(torch, lambda: F.scaled_dot_product_attention(qt, kt_, vt))
        bound_ms, bound_by = _attn_bound(shape)
        results["flash_attention"].append(dict(
            shape=list(shape), calls_per_request=0, calls_per_train_step=0, err_vs_fp32=k_err, twin_err_vs_fp32=t_err, max_abs_err=kt,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, variant=fa.VARIANT_NAMES[served],
            share_of_bound=bound_ms / ms, other_variant_ms=other_ms,
            served_variant_ms_in_turns=served_ms))
        turns = (f"in turns with the mma.sync kernel: serving {served_ms:.4f} ms, other "
                 f"{other_ms:.4f} ms" if other_ms is not None else "the mma.sync kernel does "
                 "not take it")
        say("kernels", f"flash_attention {list(shape)} SV3D ({fa.VARIANT_NAMES[served]} kernel, "
            f"ragged tail, {100 * bound_ms / ms:.1f}% of its bound): |k-fp32| {k_err:.3e} "
            f"|twin-fp32| {t_err:.3e} |k-twin| {kt:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} "
            f"ms (chunks of {SV3D_TWIN_ROWS} rows) bound {bound_ms:.4f} ms ({bound_by}) library "
            f"call {library_ms:.4f} ms; {turns} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("kernels", f"flash_attention {shape} outside its error bound")
        del q, k, v, kern, qt, kt_, vt
        torch.cuda.empty_cache()
        sv3d_s += time.time() - row_t0

    # kernel 1's backward at every trained shape: the backward kernel on the
    # forward kernel's o and lse against its twin fed the same tensors and
    # against autograd of the fp32 plain attention (each gradient relative to
    # its largest entry), BWD_CHECK_CHUNK rows at a time; lse against its twin;
    # two runs bit-equal; kernel, twin and library (autograd of
    # scaled_dot_product_attention, which the port never calls) in turns
    for shape in (ATTN_BWD_SHAPES if chosen("flash_attention_bwd") else ()):
        q, k, v, go = (randn(*shape) for _ in range(4))
        o, lse = fa._launch(q, k, v, with_lse=True)
        ops.reset_launch_counts()
        kern = fa._launch_bwd(q, k, v, o, lse, go)
        torch.cuda.synchronize()
        if ops.launch_counts_by_shape()["flash_attention_bwd"] != {shape: 1}:
            fail("kernels", f"attention backward {shape}: launch counter did not move")
        if not all(torch.equal(a, b) for a, b in zip(fa._launch_bwd(q, k, v, o, lse, go), kern)):
            fail("kernels", f"attention backward {shape}: two runs differ")
        names = ("dq", "dk", "dv")
        acc = {n: [0.0] * 4 for n in names}  # max |k-ref|, |t-ref|, |k-t|, |ref|
        lse_err = 0.0
        for r0 in range(0, shape[0], BWD_CHECK_CHUNK):
            sl = slice(r0, r0 + BWD_CHECK_CHUNK)
            qc, kc, vc, gc_ = (t[sl] for t in (q, k, v, go))
            lse_err = max(lse_err, (lse[sl] - attention_lse_reference(qc, kc, vc)[1])
                          .abs().max().item())
            twin = attention_backward_reference(qc, kc, vc, o[sl], lse[sl], gc_)
            f32 = [t.float().requires_grad_() for t in (qc, kc, vc)]
            ref = torch.autograd.grad(attention_reference(*f32), f32, gc_.float())
            for n, kg, tg, rg in zip(names, (t[sl] for t in kern), twin, ref):
                kg, tg = kg.float(), tg.float()
                a = acc[n]
                a[0] = max(a[0], (kg - rg).abs().max().item())
                a[1] = max(a[1], (tg - rg).abs().max().item())
                a[2] = max(a[2], (kg - tg).abs().max().item())
                a[3] = max(a[3], rg.abs().max().item())
            del twin, f32, ref
        rel = {n: [a[i] / a[3] for i in range(3)] for n, a in acc.items()}
        k_err = max(r[0] for r in rel.values())
        t_err = max(r[1] for r in rel.values())
        kt = max(r[2] for r in rel.values())
        ok = (all(r[0] <= 2 * r[1] + KERNEL_EPS for r in rel.values()) and kt <= KERNEL_VS_TWIN_TOL
              and lse_err <= LSE_TOL)
        ms, plain_ms = _time_turns(torch, lambda: attention_backward_reference(q, k, v, o, lse, go),
                                   lambda: fa._launch_bwd(q, k, v, o, lse, go), iters=5)
        qt, kt_, vt = (a.transpose(1, 2).detach().requires_grad_() for a in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt_, vt)
        got_ = go.transpose(1, 2)
        library_ms = _time_one(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt_, vt), got_, retain_graph=True), 5)
        bound_ms, bound_by = _attn_bwd_bound(shape)
        results["flash_attention_bwd"].append(dict(
            shape=list(shape), calls_per_train_step=TRAIN_ATTN_BWD_SHAPES.get(shape, 0),
            calls_per_unet_train_step=unet_train_bwd_shapes(
                UNET_TRAIN_BATCH * UNET_TRAIN_VIEWS).get(shape, 0),
            calls_per_laion_video_step=unet_train_bwd_shapes(
                UNET_TRAIN_LAION_BATCH * UNET_TRAIN_VIEWS).get(shape, 0),
            calls_per_laion_image_step=unet_train_bwd_shapes(UNET_TRAIN_IMAGE_BATCH).get(shape, 0),
            calls_per_dist_train_step=DIST_TRAIN_BY_SHAPE["flash_attention_bwd"].get(shape, 0),
            err_vs_fp32=k_err, twin_err_vs_fp32=t_err, rel_err_vs_twin=kt,
            max_abs_err=max(a[2] for a in acc.values()), lse_err=lse_err,
            errors_by_gradient=rel, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, share_of_bound=bound_ms / ms))
        say("kernels", f"flash_attention backward {list(shape)} ({100 * bound_ms / ms:.1f}% of "
            f"its bound): relative to each gradient's largest entry (dq, dk, dv) |k-fp32| "
            f"{[f'{r[0]:.3e}' for r in rel.values()]} |twin-fp32| "
            f"{[f'{r[1]:.3e}' for r in rel.values()]} |k-twin| {kt:.3e}; |lse-twin| "
            f"{lse_err:.3e} (bound {LSE_TOL:.0e}); two runs bit-equal; kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), library call "
            f"(scaled_dot_product_attention's backward) {library_ms:.4f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("kernels", f"flash_attention backward {shape} outside its error bound")
        del q, k, v, go, o, lse, kern, qt, kt_, vt, lib_out, got_
        torch.cuda.empty_cache()

    ffn_shapes = dict.fromkeys([*FFN_SHAPES, *BATCHED_REFINED_BY_SHAPE["geglu_ffn"],
                                *SV3D_FFN_SHAPES])
    for t, c, inner in (ffn_shapes if chosen("geglu_ffn") else ()):
        row_t0 = time.time()
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
        if not torch.equal(geglu_ffn(x, w1, b1, w2, b2), kern):  # one writer per element
            fail("kernels", f"ffn {(t, c, inner)}: two launches differ")
        twin = geglu_ffn_reference(x, w1, b1, w2, b2)
        ref32 = geglu_ffn_reference(x.float(), w1.float(), b1, w2.float(), b2)
        k_err, t_err, kt = errs(kern, twin, ref32)
        ms, plain_ms = _time_turns(torch, lambda: geglu_ffn_reference(x, w1, b1, w2, b2),
                                   lambda: geglu_ffn(x, w1, b1, w2, b2))
        ok = k_err <= 2 * t_err + KERNEL_EPS and kt <= KERNEL_VS_TWIN_TOL
        served = ff.ffn_variant(t, c, inner)
        other_ms, served_ms = _time_turns(  # (second, first)
            torch, lambda: ff._launch(x, w1, b1, w2, b2, variant=served),
            lambda: ff._launch(x, w1, b1, w2, b2,
                               variant=ff.VARIANT_MMA + ff.VARIANT_WGMMA - served), iters=10)
        bound_ms, bound_by = _ffn_bound(t, c, inner)
        results["geglu_ffn"].append(dict(
            shape=[t, c, inner], calls_per_request=FFN_SHAPES.get((t, c, inner), 0),
            calls_per_train_step=0, **_slice_e_calls("geglu_ffn", (t, c, inner)),
            err_vs_fp32=k_err, twin_err_vs_fp32=t_err,
            max_abs_err=kt, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, variant=ff.VARIANT_NAMES[served], share_of_bound=bound_ms / ms,
            other_variant_ms=other_ms, served_variant_ms_in_turns=served_ms))
        say("kernels", f"geglu_ffn [T={t}, C={c}, I={inner}] ({ff.VARIANT_NAMES[served]} "
            f"kernel, {100 * bound_ms / ms:.1f}% of its bound): |k-fp32| {k_err:.3e} "
            f"|twin-fp32| {t_err:.3e} |k-twin| {kt:.3e} kernel {ms:.4f} ms "
            f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}); in turns with the "
            f"other hand-written kernel: serving {served_ms:.4f} ms, other {other_ms:.4f} ms "
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
        if (t, c, inner) in SV3D_FFN_SHAPES:
            sv3d_s += time.time() - row_t0
    if chosen("flash_attention") or chosen("geglu_ffn"):
        say("kernels", f"the SV3D rows (attention and FFN) took {sv3d_s:.1f}s")
    if chosen("group_norm"):
        results["group_norm"] = _group_norm_rows(torch, dev)
    if chosen("splat_composite"):
        results["splat_composite"], results["splat_composite_bwd"] = _splat_kernel_checks(
            torch, dev)
    torch.cuda.empty_cache()
    if chosen("fused_spatial"):
        results["fused_spatial"] = _spatial_kernel_checks(torch, dev)
    return results


def _graph_ms(torch, fn, iters=20, reps=3):
    """Device ms a call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times (no host time between the launches)."""
    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _group_norm_rows(torch, dev):
    """Kernel 6 at GN_SHAPES: against its plain twin and fp32 (the bound of
    kernels 1-5), bit-equal over two launches, one launch counted by shape;
    its time (a CUDA graph of 20 launches, in turns with the twin) against
    its bound (the input read once, the output written once, at 3.35 TB/s)
    and against F.group_norm + F.silu, the yardstick the port never calls."""
    import torch.nn.functional as F

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for n, c, f, side, permuted, silu in GN_SHAPES:
        shape = (n, c, f, side, side)
        if permuted:
            x = torch.randn(n * f, c, side, side, generator=gen, device=dev) * 1.5 + 0.5
            x = x.to(torch.bfloat16).reshape(n, f, c, side, side).permute(0, 2, 1, 3, 4)
        else:
            x = (torch.randn(*shape, generator=gen, device=dev) * 1.5 + 0.5).to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        b = (0.1 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        key = (n, c, f * side * side, silu)
        ops.reset_launch_counts()
        kern = gn.group_norm(x, w, b, 32, 1e-5, silu)
        torch.cuda.synchronize()
        if ops.launch_counts_by_shape()["group_norm"] != {key: 1}:
            fail("kernels", f"group_norm {key}: launch counter did not move")
        if not torch.equal(gn.group_norm(x, w, b, 32, 1e-5, silu), kern):
            fail("kernels", f"group_norm {key}: two launches differ")
        twin = gn.group_norm_reference(x, w, b, 32, 1e-5, silu)
        ref32 = F.group_norm(x.float(), 32, w.float(), b.float(), 1e-5)
        ref32 = F.silu(ref32) if silu else ref32
        k_err = (kern.float() - ref32).abs().max().item()
        t_err = (twin.float() - ref32).abs().max().item()
        kt = (kern.float() - twin.float()).abs().max().item()
        ok = k_err <= 2 * t_err + KERNEL_EPS and kt <= KERNEL_VS_TWIN_TOL
        del twin, ref32, kern

        def library():
            y = F.group_norm(x, 32, w, b, 1e-5)
            return F.silu(y) if silu else y

        plain = lambda: gn.group_norm_reference(x, w, b, 32, 1e-5, silu)
        kernel = lambda: gn.group_norm(x, w, b, 32, 1e-5, silu)
        p1, k1, k2, p2 = (_graph_ms(torch, fn) for fn in (plain, kernel, kernel, plain))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        library_ms = _graph_ms(torch, library)
        bound_ms, bound_by = _bound(2 * 2 * x.numel() + 4 * c, 0, PEAK_BF16_FLOPS)
        plan = gn._plan(dev.index or 0, n, c, 32, gn.kernel_layout(x, 32))
        rows.append(dict(shape=list(shape), permuted=permuted, silu=silu,
                         err_vs_fp32=k_err, twin_err_vs_fp32=t_err, max_abs_err=kt, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms, share_of_bound=bound_ms / ms,
                         plan=plan._asdict()))
        say("kernels", f"group_norm {list(shape)}{' permuted' if permuted else ''}"
            f"{' +silu' if silu else ''} (cluster {plan.cluster}, {plan.res_vecs} of "
            f"{plan.slice_vecs} vectors a CTA held, {100 * bound_ms / ms:.1f}% of its "
            f"bound): |k-fp32| {k_err:.3e} |twin-fp32| {t_err:.3e} |k-twin| {kt:.3e} kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) library "
            f"call (F.group_norm + F.silu) {library_ms:.4f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("kernels", f"group_norm {key} outside its error bound")
        del x
        torch.cuda.empty_cache()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ",".join(PHASES))
    p.add_argument("--kernels", default="",
                   help="comma-separated kernel names: the kernels phase checks these alone")
    p.add_argument("--define", default="",
                   help="comma-separated macros passed to nvcc as -D (the ablation switches)")
    p.add_argument("--build-only", action="store_true",
                   help="with an ablation's *_times phase: build the kernels and stop")
    args = p.parse_args(argv)
    phases = [s for s in args.phases.split(",") if s]
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        p.error(f"unknown phases {sorted(unknown)}")
    if "multirank" in phases and "dist_train" not in phases:
        p.error("multirank takes the dist_train phase's UNet, batch and loss: add dist_train")

    sys.path.insert(0, ROOT)
    import torch

    if args.define:
        from videomv_tpu_torch.ops import _build

        _build.NVCC_FLAGS.extend("-D" + d for d in args.define.split(",") if d)
    for kind, times in (("ffn", phase_ffn_times), ("spatial", phase_spatial_times),
                        ("splat_bwd", phase_splat_bwd_times)):
        if f"{kind}_times" in phases:  # a child of the ablation: nothing else runs
            if args.build_only:
                from videomv_tpu_torch.ops import _build

                _build.load_library()
                return None
            if not torch.cuda.is_available():
                fail(f"{kind}_times", "needs a CUDA device")
            return times(torch, args.define)
    run_t0 = time.time()
    smi = phase_env(torch)
    if "init_cost" in phases:
        phase_init_cost(torch)
    # every model from here on is seeded through the run's cache of draws
    from videomv_tpu_torch.training import checkpoints

    seeded = _SeededWeights(checkpoints.init_weights)
    checkpoints.init_weights = seeded
    if "ffn_ablation" in phases:
        phase_ffn_ablation()
    if "spatial_ablation" in phases:
        _ablation("spatial", SPATIAL_ABLATIONS)
    if "splat_bwd_ablation" in phases:
        _ablation("splat_bwd", SPLAT_BWD_ABLATIONS)
    if "build" in phases or "kernels" in phases:
        phase_build()
    only = [s for s in args.kernels.split(",") if s] or None
    kernel_results = {}
    if "kernels" in phases:
        t0 = time.time()
        kernel_results = phase_kernels(torch, only)
        say("kernels", f"phase {time.time() - t0:.1f}s")
    # kernel -> launches of one plain request, one refined request, one train
    # step: each counted with the counters reset just before that path ran
    train_run = f"train run of {TRAIN_STEPS} steps"
    unet_train_run = f"UNet train run of {UNET_TRAIN_STEPS} steps"
    i2v_train_run = f"I2V UNet train run of {I2V_TRAIN_STEPS} steps"
    i2v_refine_run = f"I2V refine train run of {I2V_TRAIN_STEPS} steps"
    slice_e = ("DDP train step (world 1)", "FSDP train step (world 1)",
               "batched plain request (2 prompts)", "batched refined request (2 prompts)",
               f"frame-parallel plain request, {MULTIRANK_STEPS} steps (rank 0 of 2)")
    by_path = {"plain request": {}, "refined request": {}, "I2V plain request": {},
               "I2V refined request": {}, train_run: {}, unet_train_run: {},
               i2v_train_run: {}, i2v_refine_run: {}, **{k: {} for k in slice_e}}
    if "unet" in phases:
        phase_unet(torch)
    if "refine" in phases:
        phase_refine(torch)
    if "vae_logits" in phases:
        phase_vae_logits(torch)
    if "slice" in phases:
        by_path["plain request"], by_path["refined request"] = phase_slice(torch)
    if "profile" in phases:
        phase_profile(torch)
    if "tracing" in phases:
        phase_tracing(torch)
    if "i2v" in phases:
        by_path["I2V plain request"], by_path["I2V refined request"] = phase_i2v(torch)
    if "train" in phases:
        by_path[train_run] = phase_train(torch)
    if "unet_train" in phases:
        by_path[unet_train_run] = phase_unet_train(torch)
    if "i2v_train" in phases:
        by_path[i2v_train_run], by_path[i2v_refine_run] = phase_i2v_train(torch)
    if "unet_train_memory" in phases:
        phase_unet_train_memory(torch)
    if "train_spread" in phases:
        phase_train_spread(torch)
    if "dist_train" in phases:
        t0 = time.time()
        by_path[slice_e[0]], by_path[slice_e[1]] = phase_dist_train(torch)
        say("dist_train", f"phase {time.time() - t0:.1f}s")
    if "batched_serving" in phases:
        t0 = time.time()
        by_path[slice_e[2]], by_path[slice_e[3]] = phase_batched_serving(torch)
        say("batched_serving", f"phase {time.time() - t0:.1f}s")
    if "multirank" in phases:
        t0 = time.time()
        by_path[slice_e[4]] = phase_multirank(torch)
        say("multirank", f"phase {time.time() - t0:.1f}s")
    if "variants" in phases:
        by_path.update(phase_variants(torch))
    say("env", f"seeded weights: {seeded.drawn_s:.1f} s drawing on the host (each model once, "
        f"summed over the threads that draw at once), {seeded.copied_s:.1f} s copying them "
        f"onto their devices; the whole run {time.time() - run_t0:.1f} s; {CLOCKS_QUERY}: "
        f"{nvidia_smi_line(CLOCKS_QUERY)}")

    # One entry per kernel. ms, plain_ms, bound_ms and library_ms are totals
    # over one run of the path named in "path": each shape's time per call
    # (kernels phase) times its calls on that path. The attention kernel and
    # the two splat kernels are totalled over the train run, the attention
    # backward over the UNet train run, the FFN kernel (which a train step
    # does not launch) over a refined request, the fused spatial block over a
    # refined I2V request with its flag on. launches is the count read after
    # that path ran (null unless its phase ran).
    record = []
    for name, runs in kernel_results.items():
        for r in runs:  # slice F's paths (the variants phase), by shape
            if name in ("flash_attention", "flash_attention_bwd", "geglu_ffn"):
                r["calls_by_slice_f_path"] = {path: shapes.get(name, {}).get(tuple(r["shape"]), 0)
                                              for path, shapes in VARIANT_CALLS.items()}
        if name == "group_norm":  # launches asserted by the slice and i2v phases
            record.append(dict(name=name, **KERNELS[name], shapes=runs))
            continue
        if name == "geglu_ffn":
            path, calls, times = "refined request", "calls_per_request", 1
        elif name == "fused_spatial":
            path, calls, times = "I2V refined request", "calls_per_request", 1
        elif name == "flash_attention_bwd":
            path, calls, times = unet_train_run, "calls_per_unet_train_step", UNET_TRAIN_STEPS
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
            kernel_ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"), bound_by=top["bound_by"],
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
        from videomv_tpu_torch.training.checkpoints import init_models

        os.chdir(ROOT)  # the configs' relative paths (prompts, log_dir)
        pipe = T2VPipeline(load_inference_config("configs/t2v_infer.yaml"), device="cuda")
        if pipe.lgm is None:
            fail("slice", "configs/t2v_infer.yaml no longer sets UNet.use_lgm_refine")
        init_models([(pipe.models[name], seed) for name, seed in _SEEDS.items()],
                    zero_init=False, device=pipe.device)
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
    if counts != dict(_ZERO_COUNTS, flash_attention=10, geglu_ffn=21):
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
        dec_in = log32["vae.decode"][0]
        vae_w = copy.deepcopy(pipe.vae).float()  # the served weights, fp32 arithmetic
        dec16, enc16 = pipe.vae.decode(*dec_in), pipe.vae.encode_first_stage(*enc_in)
        forced = {
            "unet": rel(log16["unet"][1], log32["unet"][1]),  # same inputs already
            "vae.decode": rel(dec16, vae_w.decode(*dec_in)),
            "lgm": rel(pipe.lgm(*log32["lgm"][0]), gauss32),
            "render": (render16 - render32).abs().max().item(),
            "vae.encode_first_stage": rel(enc16, vae_w.encode_first_stage(*enc_in)),
        }
        # against the fp32 draw the bf16 weights were rounded from, and that
        # rounding alone
        vae_draw = {"vae.decode": (rel(dec16, log32["vae.decode"][1]),
                                   rel(vae_w.decode(*dec_in), log32["vae.decode"][1])),
                    "vae.encode_first_stage": (
                        rel(enc16, log32["vae.encode_first_stage"][1]),
                        rel(vae_w.encode_first_stage(*enc_in),
                            log32["vae.encode_first_stage"][1]))}
    del ref, log16, log32, gauss32, render16, render32, enc_in, dec_in, vae_w, dec16, enc16
    torch.cuda.empty_cache()
    bounds = dict(REFINE_STAGE_TOL, render=SPLAT_TOL)
    bad = {k: v for k, v in forced.items() if not v <= bounds[k]}
    say("refine", f"teacher-forced stages, bf16 kernels vs fp32 plain (relative max error; "
        f"render: max|d| kernel vs twin; the VAE stages against the served weights in "
        f"fp32): {forced}, bounds {bounds}; the VAE stages against the fp32 draw, and the "
        f"bf16 rounding of the weights alone: {vae_draw}; {time.time() - t0:.1f}s")
    if not torch.isfinite(cond16).all() or tuple(cond16.shape) != (1, 4, 24, 32, 32):
        fail("refine", f"refined latents {tuple(cond16.shape)} not finite or misshapen")
    if not torch.equal(cond16, uncond16):
        fail("refine", "shared uncond must return the cond row twice")
    if counts16 != dict(_ZERO_COUNTS, flash_attention=21, geglu_ffn=21, splat_composite=1):
        fail("refine", f"expected 21 attention + 21 FFN + 1 splat launches, got {counts16}")
    if any(counts32.values()):
        fail("refine", f"the fp32 reference launched kernels: {counts32}")
    if bad:
        fail("refine", f"stages outside their bounds: {bad}")
    if not rms <= REFINE_L2_TOL:
        fail("refine", f"relative L2 error {rms:.3e} above {REFINE_L2_TOL}")


def phase_vae_logits(torch):
    """The refine phase twice on the same inputs: with the VAE's attention
    logits formed as a bf16 product (as before they kept fp32) and as they
    are, fp32 (``fp32_logits``). Only the VAE's logits change, so the text
    conditioning and every stage's input are the same in both runs; a
    stage outside its bound is printed, not raised."""
    from videomv_tpu_torch.models import autoencoder

    fp32_logits = autoencoder.fp32_logits
    for tag, logits in (("bf16 product", lambda eq, a, b: torch.einsum(eq, a, b).float()),
                        ("fp32 (served)", fp32_logits)):
        autoencoder.fp32_logits = logits
        say("vae_logits", f"the refine phase with the VAE's attention logits as a {tag}:")
        try:
            phase_refine(torch)
        except SystemExit:
            pass
        finally:
            autoencoder.fp32_logits = fp32_logits


def _serve(torch, pipe, prompts, refine, tag, pair_log, by_shape=None, want=None,
           fused_by_shape=None):
    """One generate() per prompt (the first is warm-up), each with the
    launch counters reset just before it and read just after; ``by_shape``
    is what the attention and FFN counters must read split by shape,
    ``fused_by_shape`` the fused block's (none unless its switch is on).
    Returns the outputs, the last request's counts and its latency (s)."""
    import numpy as np

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.ops.gaussian_splat import pair_capacity

    cap = pair_capacity(SPLAT_GAUSSIANS, SPLAT_SIZE)
    if want is None:
        want = REFINED_LAUNCHES if refine else PLAIN_LAUNCHES
    outs, counts, dt = [], {}, None
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
        if by_shape is not None and _without_kernel_6(shapes) != dict(
                by_shape, flash_attention_bwd={}, fused_spatial=fused_by_shape or {}):
            fail("slice", f"{tag}: expected launches by shape {by_shape}, got {shapes}")
        if shapes["fused_spatial"] != (fused_by_shape or {}):
            fail("slice", f"{tag}: expected fused launches by shape {fused_by_shape or {}}, got "
                 f"{shapes['fused_spatial']}")
        if fr.dtype != np.uint8 or fr.shape != (24, 256, 256, 3):
            fail("slice", f"frames {fr.dtype} {fr.shape}, expected uint8 (24, 256, 256, 3)")
        if not np.isfinite(out["latents"]).all():
            fail("slice", "non-finite latents")
        outs.append(out)
    if len(outs) > 1 and np.array_equal(outs[0]["frames"], outs[1]["frames"]):
        fail("slice", f"{tag}: two different prompts gave identical views")
    return outs, counts, dt


def _without_kernel_6(shapes):
    """Launches by shape of kernels 1, 2 and 5: what the phases held them to
    before kernel 6, whose launches the slice and i2v phases hold to the
    GroupNorm calls (``_graphs_against_eager``); the frozen VAE and UNet of
    the training, batched and multi-rank phases launch it too."""
    return {k: v for k, v in shapes.items() if k != "group_norm"}


class _GroupNormCalls:
    """Counts, by (N, C, F·H·W, silu), the calls of every ``blocks.GroupNorm``
    of a pipeline's UNet and VAE made while it is entered (forward hooks: a
    replayed CUDA graph runs none)."""

    def __init__(self, pipe):
        from videomv_tpu_torch.models.blocks import GroupNorm

        self.norms = [m for model in (pipe.unet, pipe.vae) for m in model.modules()
                      if isinstance(m, GroupNorm)]
        self.by_shape, self.handles = {}, []

    def _hook(self, module, args, kwargs, out):
        x = args[0]
        key = (x.shape[0], x.shape[1], math.prod(x.shape[2:]), bool(kwargs.get("silu", False)))
        self.by_shape[key] = self.by_shape.get(key, 0) + 1

    def __enter__(self):
        self.handles = [m.register_forward_hook(self._hook, with_kwargs=True)
                        for m in self.norms]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def _graphs_against_eager(torch, pipe, request, tag, phase):
    """``request()`` served from the pipeline's CUDA graphs (every signature
    it meets captured by the requests before), then the same request with
    the graphs off (the eager loop): the latents bit-equal, the launches by
    shape equal, every forward of the first a replay. Returns its seconds."""
    import numpy as np

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.utils import profiling

    t0 = time.time()
    graphs, runs = pipe.unet.graphs, {}
    names = ("unet.forwards", "unet.graph_replays", "unet.graph_captures")
    for mode in ("graphs", "eager"):
        pipe.unet.graphs = graphs if mode == "graphs" else None
        before = profiling.counts()
        ops.reset_launch_counts()
        profiling.reset_counts(["gn.plain"])
        try:
            with _GroupNormCalls(pipe) as calls:
                out = request()
        finally:
            pipe.unet.graphs = graphs
        torch.cuda.synchronize()
        after = profiling.counts()
        runs[mode] = (out["latents"], ops.launch_counts_by_shape(),
                      {k: after.get(k, 0) - before.get(k, 0) for k in names})
        if profiling.counts_by_shape("gn.plain"):
            fail(phase, f"{tag} ({mode}): GroupNorm calls took the plain path: "
                 f"{profiling.counts_by_shape('gn.plain')}")
    # every GroupNorm call of the eager request (the hooks see no replay)
    # launched kernel 6, by shape
    (lat, shapes, n), (lat_e, shapes_e, n_e) = runs["graphs"], runs["eager"]
    say(phase, f"{tag}: kernel 6 launches by shape {shapes_e['group_norm']}")
    if shapes_e["group_norm"] != calls.by_shape:
        fail(phase, f"{tag}: kernel 6 launched {shapes_e['group_norm']}, the eager request's "
             f"GroupNorms were called {calls.by_shape}")
    diff = float(np.abs(lat.astype(np.float64) - lat_e).max())
    secs = time.time() - t0
    say(phase, f"{tag}: CUDA graphs against the eager loop, latents max|d| {diff!r} (bound 0, "
        f"bit-equal); counters {n} (eager {n_e}); launches by shape "
        f"{'equal' if shapes == shapes_e else 'DIFFERENT'}; {secs:.1f}s")
    if diff != 0.0:
        fail(phase, f"{tag}: latents from the CUDA graphs differ from the eager loop's by "
             f"max|d| {diff!r} (bound 0)")
    if shapes != shapes_e:
        fail(phase, f"{tag}: launches by shape {shapes} from the CUDA graphs, {shapes_e} eager "
             f"(must be equal)")
    if n["unet.graph_replays"] != n["unet.forwards"] or n["unet.graph_captures"] != 0:
        fail(phase, f"{tag}: {n['unet.graph_replays']} of {n['unet.forwards']} forwards "
             f"replayed, {n['unet.graph_captures']} captures (every forward replayed and none "
             f"captured expected)")
    return secs


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

    torch.cuda.synchronize()
    held0 = torch.cuda.memory_reserved() / 2**30, torch.cuda.memory_allocated() / 2**30
    with _PairLog() as pair_log:
        plain, counts_plain, plain_s = _serve(torch, pipe, prompts, False, "plain", pair_log,
                                              PLAIN_BY_SHAPE)
        refined, counts, _ = _serve(torch, pipe, prompts, True, "refined", pair_log,
                                    {"flash_attention": ATTN_SHAPES, "geglu_ffn": FFN_SHAPES})
        # the UNet's graphs (the 48- and 24-row forwards) were captured above:
        # their pool is memory reserved that max_memory_allocated does not see
        torch.cuda.synchronize()
        pool = [g for g in torch.cuda.memory_snapshot()
                if tuple(g.get("segment_pool_id", (0, 0))) != (0, 0)]
        say("slice", f"CUDA graph pool: {sum(g['total_size'] for g in pool) / 2**30:.4f} GiB "
            f"reserved in {len(pool)} segments, {sum(g['allocated_size'] for g in pool) / 2**30:.4f}"
            f" GiB of it allocated; memory_reserved {held0[0]:.4f} -> "
            f"{torch.cuda.memory_reserved() / 2**30:.4f} GiB and memory_allocated {held0[1]:.4f} "
            f"-> {torch.cuda.memory_allocated() / 2**30:.4f} GiB over the requests that captured "
            f"them")
        for refine in (False, True):
            _graphs_against_eager(torch, pipe, lambda: pipe.generate(
                prompts[0], steps=50, guide_scale=9.0, use_gs_refine=refine, seed=11),
                f"{'refined' if refine else 'plain'} request", "slice")
        # the fused block's switch serves T2V too: its 32² blocks over the
        # 77-token text context
        with _FusedSpatialFlag(True):
            _, _, on_s = _serve(torch, pipe, prompts, False, "plain, fused block on", pair_log,
                                want=T2V_PLAIN_ON, fused_by_shape=T2V_FUSED_BY_SHAPE)
        say("slice", f"plain T2V request, timed: fused-block switch off {plain_s:.3f} s, on "
            f"{on_s:.3f} s")
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


def phase_i2v(torch):
    """configs/i2vgen_xl_infer.yaml as shipped (no override), seeded weights,
    on the card in bf16: (a) one full-width UNetSD_I2VGen CFG forward at 8
    views with the fused spatial block switched on against the fp32 host
    forward and against the card's forward with the switch off; (b) requests
    from data/images/test_obj.png — plain with the switch off, plain with it
    on, refined `shared` with it on (the first of each pair is warm-up) —
    with latency, peak memory and asserted launch counts; (c) one CFG
    forward's device time by class, switch on and off; (d) the CLI once with
    the switch on. The script sets and restores the switch around each part.
    Returns the launch counts of one plain and one refined request with the
    switch on."""
    import copy
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.config import load_inference_config
    from videomv_tpu_torch.data.cameras import orbit_camera_for_t2v
    from videomv_tpu_torch.inference import I2VPipeline
    from videomv_tpu_torch.inference.__main__ import main as cli_main
    from videomv_tpu_torch.inference.pipeline import unet_kwargs_from_cfg
    from videomv_tpu_torch.models import UNetSD_I2VGen
    from videomv_tpu_torch.training.checkpoints import init_models, init_weights

    global _PIPE, _HOST_UNET
    _PIPE = _HOST_UNET = None  # the T2V serving models are done
    gc.collect()
    torch.cuda.empty_cache()
    os.chdir(ROOT)
    t0 = time.time()
    cfg = load_inference_config(I2V_CFG)
    if cfg.get("gs_refine_uncond") != "shared" or not cfg.UNet.get("use_lgm_refine"):
        fail("i2v", f"{I2V_CFG} no longer ships the refine with gs_refine_uncond: shared")
    with open(cfg.test_list_path) as fh:
        images = [ln.strip() for ln in fh if ln.strip() and not ln.startswith("#")]
    if not images or not os.path.exists(images[0]):
        fail("i2v", f"no image listed in {cfg.test_list_path}")
    with torch.device("meta"):
        host = UNetSD_I2VGen(**unet_kwargs_from_cfg(cfg.UNet))
    pipe = I2VPipeline(cfg, device="cuda")
    # the host UNet and the card's towers drawn at once
    with ThreadPoolExecutor(max_workers=1) as pool:
        drawn = pool.submit(init_weights, host, 0, False, "cpu")
        init_models([(pipe.models[name], seed) for name, seed in _SEEDS.items()],
                    zero_init=False, device=pipe.device)
        host = drawn.result().eval().requires_grad_(False)
    pipe.load_state_dicts(unet=host.state_dict())  # casts all to bf16
    n_par = {k: sum(p.numel() for p in m.parameters()) / 1e6 for k, m in pipe.models.items()}
    say("i2v", f"I2VPipeline of {I2V_CFG}: parameters (M) {n_par}, dtype {pipe.dtype}, guidance "
        f"{cfg.guide_scale}, refine steps {tuple(cfg.get('gs_refine_steps', (20, 30, 40)))}; "
        f"init {time.time() - t0:.1f}s")

    # ---- (a) the full-width forward, 8 views, CFG rows 2
    t0 = time.time()
    rs = np.random.default_rng(0)
    f = 8
    x = rs.standard_normal((1, 4, f, 32, 32)).astype(np.float32)
    y = rs.standard_normal((2, 77, 1024)).astype(np.float32)
    local = rs.standard_normal((1, 4, 1, 32, 32)).astype(np.float32)
    img = np.concatenate([rs.standard_normal((1, 1024)).astype(np.float32),
                          np.zeros((1, 1024), np.float32)])
    cam = orbit_camera_for_t2v(f)
    args = dict(y=torch.from_numpy(y), camera_data=torch.from_numpy(np.concatenate([cam, cam])),
                local_image=torch.from_numpy(np.concatenate([local, local])),
                image=torch.from_numpy(img))
    x2, t2 = torch.from_numpy(np.concatenate([x, x])), torch.tensor([981, 981])
    card_args = {k: v.cuda() for k, v in args.items()}
    outs, counts = {}, {}
    with torch.no_grad():
        for on in (True, False):
            with _FusedSpatialFlag(on):
                ops.reset_launch_counts()
                outs[on] = pipe.unet(x2.cuda(), t2.cuda(), **card_args).cpu()
                torch.cuda.synchronize()
                counts[on] = ops.launch_counts()
        torch.set_num_threads(os.cpu_count() or 1)
        out_host = host(x2, t2, **args)
    scale = out_host.abs().max().item()
    rel = {on: ((outs[on] - out_host).abs().max() / scale).item() for on in outs}
    on_off = ((outs[True] - outs[False]).abs().max() / scale).item()
    say("i2v", f"UNetSD_I2VGen dim 320 x (1,2,4,4), 8 views, CFG rows 2, context 145: bf16 card "
        f"vs fp32 host max|d|/max|ref| {rel[True]:.3e} with the fused block, {rel[False]:.3e} "
        f"without (bound {UNET_REL_TOL:.0e}); on vs off {on_off:.3e}; max|ref| {scale:.3e}; "
        f"launches on {counts[True]}, off {counts[False]}; {time.time() - t0:.1f}s")
    if counts[True] != dict(_ZERO_COUNTS, fused_spatial=5, flash_attention=5, geglu_ffn=16):
        fail("i2v", f"flag on: expected 5 fused + 5 attention + 16 FFN, got {counts[True]}")
    if counts[False] != dict(_ZERO_COUNTS, flash_attention=10, geglu_ffn=21):
        fail("i2v", f"flag off: expected 10 attention + 21 FFN, got {counts[False]}")
    if not all(torch.isfinite(o).all() for o in outs.values()):
        fail("i2v", "non-finite output on the card")
    if not (rel[True] <= UNET_REL_TOL and rel[False] <= UNET_REL_TOL):
        fail("i2v", f"relative error {rel} above {UNET_REL_TOL}")
    del host, out_host, outs
    gc.collect()

    # ---- (b) requests
    def serve(refine, on, want, fused_by_shape, tag, n=2):
        last = None
        for i in range(n):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with _FusedSpatialFlag(on), _PairLog():
                ops.reset_launch_counts()
                t1 = time.perf_counter()
                out = pipe.generate_from_image(images[0], steps=50, use_gs_refine=refine,
                                               seed=21 + i)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t1
                got, shapes = ops.launch_counts(), ops.launch_counts_by_shape()
            if os.environ.get(SPATIAL_FLAG):
                fail("i2v", "the fused block's switch was left on")
            peak = torch.cuda.max_memory_allocated() / 2**30
            fr = out["frames"]
            say("i2v", f"{tag} request {i} ({'warm-up' if i == 0 and n > 1 else 'timed'}) "
                f"{images[0]!r}: {dt:.3f} s, peak {peak:.2f} GiB, frames {fr.dtype} "
                f"{list(fr.shape)}, launches {got}")
            if got != want:
                fail("i2v", f"{tag}: expected launches {want}, got {got}")
            if shapes["fused_spatial"] != fused_by_shape:
                fail("i2v", f"{tag}: expected fused launches by shape {fused_by_shape}, got "
                     f"{shapes['fused_spatial']}")
            if fr.dtype != np.uint8 or fr.shape != (24, 256, 256, 3):
                fail("i2v", f"frames {fr.dtype} {fr.shape}, expected uint8 (24, 256, 256, 3)")
            if not np.isfinite(out["latents"]).all():
                fail("i2v", "non-finite latents")
            if last is not None and np.array_equal(last["frames"], fr):
                fail("i2v", f"{tag}: two seeds gave identical views")
            last = out
        return last, got

    plain_off, _ = serve(False, False, I2V_PLAIN_OFF, {}, "plain, switch off")
    plain_on, counts_plain = serve(False, True, I2V_PLAIN_ON, I2V_FUSED_BY_SHAPE["plain"],
                                   "plain, switch on")
    refined_on, counts_refined = serve(True, True, I2V_REFINED_ON, I2V_FUSED_BY_SHAPE["refined"],
                                       "refined shared, switch on")
    with _FusedSpatialFlag(True):
        _graphs_against_eager(torch, pipe, lambda: pipe.generate_from_image(
            images[0], steps=50, use_gs_refine=True, seed=21), "refined request, switch on", "i2v")
    # same seed, switch on vs off: two bf16 roundings of one sampler
    d = np.abs(plain_on["latents"] - plain_off["latents"])
    say("i2v", f"plain latents, switch on vs off (same seed): max|d| {d.max():.3e}, mean|d| "
        f"{d.mean():.3e}, max|latent| {np.abs(plain_off['latents']).max():.3e}")
    if np.array_equal(plain_on["frames"], refined_on["frames"]):
        fail("i2v", "the refine left the sample unchanged")

    # ---- (c) one CFG forward (48 rows) by class, switch on and off
    gen = torch.Generator(device=pipe.device).manual_seed(0)
    xf = torch.randn((2, 4, 24, 32, 32), generator=gen, device=pipe.device)
    tf = torch.full((2,), 981, device=pipe.device)
    with torch.no_grad():
        rgb = np.asarray(plain_off["frames"][0], np.float32) / 255.0
        yw = torch.cat([pipe.encode_text([""]), pipe._negative()])
        emb = pipe.encode_image_clip(rgb)
        lat = pipe.encode_local_latent(rgb)
        cam24 = pipe._get_cameras(15.0, 2.0)[0].expand(2, -1, -1)
        kw = dict(y=yw, camera_data=cam24, local_image=torch.cat([lat, lat]),
                  image=torch.cat([emb, torch.zeros_like(emb)]))
        clip_ms = _time_one(torch, lambda: pipe.encode_image_clip(rgb), 5)
        lat_ms = _time_one(torch, lambda: pipe.encode_local_latent(rgb), 5)
        fwd_ms = {}
        for on in (False, True, True, False):
            with _FusedSpatialFlag(on):
                fwd_ms.setdefault(on, []).append(
                    _time_one(torch, lambda: pipe.unet(xf, tf, **kw), 5))
    say("profile", f"CUDA events, I2V CFG forward (48 rows, context 145): switch off "
        f"{sum(fwd_ms[False]) / 2:.2f} ms, on {sum(fwd_ms[True]) / 2:.2f} ms (turns off / on / on "
        f"/ off); ViT-H visual tower + resize {clip_ms:.2f} ms; reference-frame VAE encode "
        f"{lat_ms:.2f} ms")
    for on in (True, False):
        with _FusedSpatialFlag(on):
            _profile_forward(torch, lambda: pipe.unet(xf, tf, **kw),
                             f"I2V CFG forward, fused block {'on' if on else 'off'}",
                             f"profile_i2v_forward_{'on' if on else 'off'}.json")
    del pipe, plain_off, plain_on, refined_on
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) the CLI once, the switch on
    t0 = time.time()
    with _FusedSpatialFlag(True):
        ops.reset_launch_counts()
        written = cli_main(["--cfg", I2V_CFG, "--debug", "--device", "cuda"])
        cli_counts = ops.launch_counts()
    if (len(written) != 2 or not all(os.path.exists(p) for p in written)
            or "_gs" not in os.path.basename(written[1])
            or "test_obj" not in os.path.basename(written[0])):
        fail("i2v", f"the CLI wrote {written}, expected the plain and the _gs output")
    want = {k: I2V_PLAIN_ON[k] + I2V_REFINED_ON[k] for k in I2V_PLAIN_ON}
    if cli_counts != want:
        fail("i2v", f"the CLI launched {cli_counts}, expected {want}")
    say("i2v", f"VIDEOMV_ENABLE_FUSED_SPATIAL=1 CLI main() --debug (no override) wrote {written} "
        f"in {time.time() - t0:.1f}s, launches {cli_counts}")
    gc.collect()
    torch.cuda.empty_cache()
    return counts_plain, counts_refined


_KERNEL_CLASSES = (  # (class, name substrings), first match wins
    ("fused_spatial (ours)", SPATIAL_WGMMA_KERNELS + (
        "spatial_block_kernel", "spatial_kv_kernel", "ctx_kv_kernel", "gn_stats_kernel")),
    ("flash_attention (ours)", ("flash_attn_fwd_kernel", "flash_attn_wgmma_kernel")),
    ("geglu_ffn (ours)", ("geglu_ffn_kernel", "geglu_ffn_wgmma_kernel")),
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
        # the served render's composite: its stats, the twin, the per-tile kernel
        what = f"served refine render, 8-row payload, 24 views at {st.output_size}²"
        stats = _splat_stats(torch, payload, ts, tc, nts)
        _say_splat_stats("profile", what, stats)
        kern = splat.composite(payload, ts, tc, nts)
        err = (kern - splat.composite_reference(payload, ts, tc, nts)).abs().max().item()
        bound_ms, bound_by, walk_ms = _splat_bound(
            24, 8, cap, nts * nts, stats["live_pairs"], stats["alive_points"])
        say("profile", f"splat_composite {what}: |k-twin| {err:.3e} (bound {SPLAT_TOL:.0e}), "
            f"bound {bound_ms:.4f} ms ({bound_by}), segment-walk count {walk_ms:.4f} ms "
            f"{'ok' if err <= SPLAT_TOL else 'FAIL'}")
        if not err <= SPLAT_TOL:
            fail("profile", "splat composite (served render) outside its error bound")
        _splat_variants(torch, payload, ts, tc, nts, kern, "profile", what)
        del kern
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

    _profile_forward(torch, forward, "CFG forward", "profile_cfg_forward.json")


def _check_trace(rec, refine, tag):
    """One traced request's record against the tracing phase's checks."""
    from videomv_tpu_torch.utils import profiling

    spans = rec["spans"]
    zero = sorted({s["name"] for s in spans if not s["dev_ms"] > 0})
    if zero:
        fail("tracing", f"{tag}: spans with no device time: {zero}")
    root = spans[0]
    top = sum(s["dev_ms"] for s in spans if s["parent"] == 0)
    if root["name"] != "pipeline.request" or top < TRACE_COVER * root["dev_ms"]:
        fail("tracing", f"{tag}: top-level spans cover {top:.3f} of {root['name']}'s "
             f"{root['dev_ms']:.3f} device ms (at least {TRACE_COVER:.0%} expected)")
    for i, s in enumerate(spans):
        if s["name"] == "refine":
            kids = [c for c in spans if c["parent"] == i]
            total = sum(c["dev_ms"] for c in kids)
            if len(kids) != 5 or abs(total - s["dev_ms"]) > TRACE_TOL * s["dev_ms"]:
                fail("tracing", f"{tag}: the refine's stages {[c['name'] for c in kids]} sum "
                     f"to {total:.3f} device ms of its {s['dev_ms']:.3f} (within "
                     f"{TRACE_TOL:.0%} expected)")
    by = profiling.summarize(rec)
    c = rec["counts"]
    want = REFINED_LAUNCHES if refine else PLAIN_LAUNCHES
    got = {k: c.get(f"launch.{k}", 0) for k in want}
    steps, refines = 50, 3 if refine else 0
    if (got != want or c.get("sampler.steps") != steps or c.get("refine.calls", 0) != refines
            or by["sampler.forward"]["n"] != steps - refines
            or c.get("sampler.forwards") != steps - refines):
        fail("tracing", f"{tag}: the record counts {c}, sampler.forward x"
             f"{by['sampler.forward']['n']}; expected launches {want}, {steps} steps, "
             f"{refines} refines")
    if refine and not 0 < c["splat.pairs_kept"] <= c["splat.pairs_demanded"]:
        fail("tracing", f"{tag}: pairs kept {c['splat.pairs_kept']} of "
             f"{c['splat.pairs_demanded']} demanded")
    return top / root["dev_ms"]


def phase_tracing(torch):
    """The program's spans and counters on the card (``utils.profiling``):
    for a plain and a refined request of the shipped T2V config, one warm-up
    request, then TRACE_TURNS requests with tracing off and on in turns (host
    seconds fenced by synchronize; the on-cost), the traced requests' records
    checked (``_check_trace``), then one request under torch.profiler (host
    and device activity) and its idle device time by span."""
    import statistics

    from torch.profiler import ProfilerActivity

    from videomv_tpu_torch.utils import profiling

    t_phase = time.time()
    pipe = _pipeline(torch)
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        cuda_only = profiling.active()
    say("tracing", f"spans record under a profiler of the device's activity alone: {cuda_only}")
    # the host cost of one span, off and on (inside a request on the card)
    cost = {}
    for on in (False, True):
        profiling.enable(on)
        with profiling.request("tracing.cost", pipe.device):
            t0 = time.perf_counter()
            for _ in range(TRACE_COST_SPANS):
                with profiling.span("tracing.cost.span"):
                    pass
            cost[on] = (time.perf_counter() - t0) / TRACE_COST_SPANS * 1e6
    profiling.enable(False)
    profiling.clear()
    say("tracing", f"host cost of one span: {cost[False]:.3f} us off, {cost[True]:.3f} us on "
        f"({TRACE_COST_SPANS} spans in a request)")
    # CUDA events from forward hooks on the UNet, as the benchmark's
    # sampler.unet_fwd_ms.serve takes them (CFG calls: a batch of 2),
    # beside the sampler.forward spans
    hooked, pending = [], []

    def pre(module, args):
        if profiling.active():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pending.append((args[0].shape[0], ev))

    def post(module, args, out):
        if pending:
            rows, ev = pending.pop()
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            hooked.append((rows, ev, end))
    hooks = [pipe.unet.register_forward_pre_hook(pre), pipe.unet.register_forward_hook(post)]
    for refine in (False, True):
        tag = "refined request" if refine else "plain request"

        def request():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.generate("a wooden chair", steps=50, guide_scale=9.0, use_gs_refine=refine,
                          seed=11)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        request()  # warm-up
        profiling.clear()
        secs = {False: [], True: []}
        for _ in range(TRACE_TURNS):
            for on in (False, True):
                profiling.enable(on)
                secs[on].append(request())
        profiling.enable(False)
        recs = profiling.requests()
        if len(recs) != TRACE_TURNS:
            fail("tracing", f"{tag}: {len(recs)} records of {TRACE_TURNS} traced requests")
        cover = [_check_trace(rec, refine, tag) for rec in recs]
        off, on = statistics.median(secs[False]), statistics.median(secs[True])
        span_ms = statistics.mean(s["dev_ms"] for rec in recs for s in rec["spans"]
                                  if s["name"] == "sampler.forward")
        hook_ms = statistics.mean(a.elapsed_time(b) for rows, a, b in hooked if rows > 1)
        hooked.clear()
        say("tracing", f"{tag}: CFG forward, sampler.forward spans {span_ms:.3f} ms against "
            f"the UNet's forward hooks {hook_ms:.3f} ms in the same requests "
            f"({100 * (span_ms / hook_ms - 1):+.2f} %)")
        if abs(span_ms / hook_ms - 1) > TRACE_TOL:
            fail("tracing", f"{tag}: sampler.forward {span_ms:.3f} ms, the hooks' "
                 f"{hook_ms:.3f} ms (within {TRACE_TOL:.0%} expected)")
        by = profiling.summarize(recs[-1])
        say("tracing", f"{tag}: seconds off {[round(x, 4) for x in secs[False]]}, on "
            f"{[round(x, 4) for x in secs[True]]}; medians {off:.4f} / {on:.4f} s, on-cost "
            f"{on - off:+.4f} s ({100 * (on / off - 1):+.2f} %); top-level spans cover "
            f"{[round(100 * x, 2) for x in cover]} % of the request's device time")
        say("tracing", f"{tag}, last traced request, device ms by span (n, total, mean): "
            + "; ".join(f"{k} {v['n']} {v['dev_ms']:.2f} {v['dev_ms'] / v['n']:.2f}"
                        for k, v in by.items())
            + f"; counters {recs[-1]['counts']}")
        profiling.clear()
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_s = request()
        t0 = time.time()
        idle = profiling.idle_by_span(prof)
        say("tracing", f"{tag} under torch.profiler (host and device), {profiled_s:.3f} s: "
            f"idle {sum(idle.values()):.4f} s of the device, by span (s): "
            f"{ {k: round(v, 4) for k, v in idle.items()} } (read in {time.time() - t0:.1f} s)")
        _check_trace(profiling.requests()[0], refine, tag + " (profiled)")
        hooked.clear()
        profiling.clear()
    for h in hooks:
        h.remove()
    say("tracing", f"phase {time.time() - t_phase:.1f}s")


def _profile_forward(torch, forward, what, trace_name, n_fwd=2):
    """The device kernels of ``n_fwd`` calls of ``forward`` under
    torch.profiler, by class and by name; the trace goes to
    workspace/profile/. Returns ms of kernels per call by class."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
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
        return {}
    classes = {}
    for name, ms in kernels.items():
        low = name.lower()
        cls = next((c for c, keys in _KERNEL_CLASSES if any(k in low for k in keys)), "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    say("profile", f"torch.profiler, {n_fwd} x {what}: wall {wall_ms / n_fwd:.2f} ms, "
        f"kernels {busy / n_fwd:.2f} ms per forward, device busy {100 * busy / wall_ms:.1f}%")
    for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:24s} {ms / n_fwd:9.3f} ms/forward {100 * ms / busy:5.1f}%", flush=True)
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms / n_fwd:9.3f} ms/forward  {name[:110]}", flush=True)
    out_dir = os.path.join(ROOT, "workspace", "profile")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, trace_name))
    return {cls: ms / n_fwd for cls, ms in classes.items()}


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
    from videomv_tpu_torch.parallel import make_t2v_apply
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
    towers = (("unet", trainer.unet), ("vae", trainer.vae), ("clip", trainer.clip),
              ("lpips", trainer.lpips))
    frozen = {n: _module_checksum(torch, m) for n, m in towers}
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
        f"launches by shape {shapes['flash_attention']}, its backward's "
        f"{shapes['flash_attention_bwd']}; demanded "
        f"pairs per rendered view min/max {min(demanded)}/{max(demanded)} of capacity {cap}")
    want = {k: v * TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}
    if counts != want:
        fail("train", f"expected launches {want} over {TRAIN_STEPS} steps, got {counts}")
    want = {"flash_attention": {k: v * TRAIN_STEPS for k, v in TRAIN_ATTN_SHAPES.items()},
            "flash_attention_bwd": {k: v * TRAIN_STEPS for k, v in TRAIN_ATTN_BWD_SHAPES.items()},
            "geglu_ffn": {}, "fused_spatial": {}}
    if _without_kernel_6(shapes) != want:
        fail("train", f"expected launches by shape {want}, got {shapes}")
    if len(vals) != TRAIN_STEPS or not all(x == x and abs(x) < 1e30 for row in vals for x in row):
        fail("train", f"non-finite loss in {vals}")
    if last != vals[-1][0] or trainer.lgm_state.step != TRAIN_STEPS:
        fail("train", "train() did not return the last step's loss after TRAIN_STEPS steps")
    if threading.active_count() != n_threads:
        fail("train", f"the prefetch worker outlived train(): {n_threads} threads before, "
             f"{[t.name for t in threading.enumerate()]} after")
    moved = max((a - b.detach().cpu()).abs().max().item()
                for a, b in zip(before, trainer.lgm.parameters()))
    if not moved > 0:
        fail("train", "the LGM parameters did not change")
    for name, module in towers:
        if frozen[name] != _module_checksum(torch, module):
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
            make_t2v_apply(_Timed(trainer.unet, timers, "unet forward")),
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
            "composite forward, the per-tile kernel, 1 chunk": _time_one(
                torch, lambda: splat._composite_forward(payload.detach(), ts, tc, nts,
                                                        variant=splat.VARIANT_PER_TILE), 5),
            "composite backward kernel, 1 chunk": _time_one(
                torch, lambda: splat.composite_backward(payload.detach(), ts, tc, out_tiles,
                                                        gtiles, nts), 5),
            "composite backward, the per-tile kernel, 1 chunk": _time_one(
                torch, lambda: splat.composite_backward(
                    payload.detach(), ts, tc, out_tiles, gtiles, nts,
                    variant=splat.BWD_VARIANT_PER_TILE), 5),
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
        f"3 + 4 vs through their twins, same Gaussians: loss {loss_k:.6f} vs {loss_t:.6f} "
        f"(|d|/|ref| {abs(loss_k - loss_t) / abs(loss_t):.3e}, bound 1e-04), "
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
    plain = build_lgm_refine_step(trainer.unet_apply, trainer.vae, trainer.lgm, trainer.diffusion,
                                  **kw)
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


def phase_train_spread(torch):
    """The train phase's two data-dependent gradient checks (d loss / d
    Gaussians through kernels 3 + 4 against their twins; the bf16 LGM
    gradient against fp32) on TRAIN_SPREAD_DRAWS draws of the step's
    randoms after the phase's TRAIN_STEPS steps: how far each reading
    spreads below its bound from run to run. It holds no reading to its
    bound: it prints them all and their extremes."""
    from videomv_tpu_torch.config import load_config
    from videomv_tpu_torch.data.datasets import SyntheticMVDataset, batch_iterator
    from videomv_tpu_torch.training.engine import T2VTrainer
    from videomv_tpu_torch.training.lgm_refine import build_lgm_refine_step, draw_refine_randoms

    os.chdir(ROOT)
    trainer = T2VTrainer(load_config("configs/t2v_train.yaml", opts=TRAIN_OPTS),
                         device="cuda").init(zero_init=False)
    trainer.train(num_steps=TRAIN_STEPS, batch_size=1)
    opt, lgm = trainer.lgm.opt, trainer.lgm
    host = next(batch_iterator(SyntheticMVDataset(resolution=tuple(trainer.resolution),
                                                  max_frames=trainer.max_frames), 1))
    feats = trainer.encode_batch(host)
    feats.update(trainer._gs_features(host))
    plain = build_lgm_refine_step(trainer.unet_apply, trainer.vae, lgm, trainer.diffusion,
                                  **dict(trainer._step_kwargs, autocast_dtype=None))

    def lgm_grads(step, prep):
        trainer.lgm_state.optimizer.zero_grad()
        step.loss_from(prep)[0].backward()
        flat = torch.cat([p.grad.flatten() for p in lgm.parameters()])
        trainer.lgm_state.optimizer.zero_grad()
        return flat

    dg, dl, cos, ratio = [], [], [], []
    for i in range(TRAIN_SPREAD_DRAWS):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        prep = trainer.refine_step.prepare(feats, draw_refine_randoms(
            gen, feats["latents"], trainer.diffusion, opt.num_input_views,
            opt.num_views - opt.num_input_views))
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            gauss = lgm(prep["lgm_in"]).float()

        def dgauss():
            g = gauss.clone().requires_grad_()
            loss, _ = trainer.refine_step.loss_from(prep, gaussians=g)
            return loss.item(), torch.autograd.grad(loss, g)[0]

        loss_k, dg_k = dgauss()
        with _TwinSplat():
            loss_t, dg_t = dgauss()
        dg.append(((dg_k - dg_t).abs().max() / dg_t.abs().max()).item())
        dl.append(abs(loss_k - loss_t) / abs(loss_t))
        if i % 3 == 0:
            g16 = lgm_grads(trainer.refine_step, prep)
            with _TwinSplat():
                g32 = lgm_grads(plain, prep)
            cos.append((torch.dot(g16, g32) / (g16.norm() * g32.norm())).item())
            ratio.append((g16.norm() / g32.norm()).item())
            del g16, g32
        del prep, gauss, dg_k, dg_t
    say("train_spread", f"{TRAIN_SPREAD_DRAWS} draws after {TRAIN_STEPS} steps: d loss / d "
        f"Gaussians max|d|/max|ref| {[f'{x:.3e}' for x in dg]}")
    srt = sorted(dg)
    say("train_spread", f"d loss / d Gaussians: median {srt[len(srt) // 2]:.3e}, largest "
        f"{srt[-3:]} (bound {TRAIN_DGAUSS_TOL:.0e}); loss |d|/|ref| largest {max(dl):.3e} "
        f"(bound 1e-04); LGM gradient ({len(cos)} draws) cosine smallest {min(cos):.4f} "
        f"(bound >= {TRAIN_GRAD_MIN_COS}), |g16|/|g32| {min(ratio):.4f} .. {max(ratio):.4f} "
        f"(bound {TRAIN_GRAD_NORM_RATIO})")
    del trainer, plain, feats
    torch.cuda.empty_cache()


def _step_by_parts(torch, trainer, host, gen, p_zero, rows, n):
    """``n`` finetune steps of ``trainer`` on the host batch ``host`` by parts
    under CUDA events (encode, forward, backward with the recompute, the
    optimizer, an EMA lerp over a copy of the UNet), printed with their
    median and the host wall of each step."""
    from videomv_tpu_torch.parallel import draw_train_randoms
    from videomv_tpu_torch.parallel.train_step import _dropout_stream

    unet, opt = trainer.unet, trainer.state.optimizer
    ema = [p.detach().clone() for p in unet.parameters()]  # the EMA lerp, timed alone
    runs, walls = [], []
    for _ in range(n):
        timers = _EventTimers(torch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with timers(f"encode (VAE {rows} frames + text)"):
            feats = trainer.encode_batch(host)
        draws = draw_train_randoms(gen, feats["latents"], trainer.diffusion, p_zero)
        opt.zero_grad()
        with _dropout_stream(gen):
            with timers("forward (q_sample, UNet, loss)"):
                loss = trainer.train_step.loss_fn(feats, draws)
            with timers("backward (recompute + grads)"):
                loss.backward()
        with timers("optimizer (AdamW, key scale)"):
            opt.step()
        with timers("EMA lerp"), torch.no_grad():
            torch._foreach_mul_(ema, 0.9999)
            torch._foreach_add_(ema, [p.detach() for p in unet.parameters()], alpha=1e-4)
        del feats, draws, loss
        runs.append(timers.ms())
        walls.append((time.perf_counter() - t1) * 1e3)
    trainer.state.step += n
    del ema
    parts = {k: sorted(r[k] for r in runs)[n // 2] for k in runs[0]}
    say("unet_train", f"CUDA events, one step at {rows} rows by part (median of {n}): "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.2f} ms; host wall of the step, median "
        f"{sorted(walls)[n // 2]:.2f} ms (walls {[round(w, 2) for w in walls]})")
    return parts


def _bits_checksum(torch, t):
    """Two integer sums of a tensor's bits, the plain one and one weighted by
    each element's position modulo a prime: equal before and after means
    bit-identical up to a collision of both. (The plain sum alone collides
    when an optimizer step moves the elements of a small tensor by equal
    numbers of units in the last place in both directions, as AdamW's first
    steps of ±lr do.)"""
    bits = t.detach().view(torch.int16 if t.element_size() == 2 else torch.int32).long().flatten()
    weights = torch.arange(bits.numel(), device=bits.device) % 8191 + 1
    return bits.sum().item(), (bits * weights).sum().item()


def _module_checksum(torch, module):
    return [_bits_checksum(torch, p) for p in module.parameters()]


def _write_laion_shard(path, n, seed=0):
    """A LAION-style tar shard of ``n`` (jpg, txt, json) samples of seeded
    noise images that pass the reader's filters."""
    import io
    import tarfile

    import numpy as np
    from PIL import Image

    rs = np.random.default_rng(seed)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rs.integers(0, 256, (288, 320, 3), dtype=np.uint8)).save(
                buf, format="JPEG")
            for ext, data in (("jpg", buf.getvalue()), ("txt", f"a photo {i}".encode()),
                              ("json", json.dumps({"aesthetic": 6.0}).encode())):
                info = tarfile.TarInfo(f"{i:09d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def phase_unet_train(torch):
    """configs/t2v_train.yaml as shipped (the plain UNet finetune) at full
    width on the card: T2VTrainer takes UNET_TRAIN_STEPS steps at batch
    UNET_TRAIN_BATCH (launch counters reset just before, read just after),
    then a step by parts, the busy share, the gradient check, a save /
    restore round trip, the CLI at the shipped batch and the joint LAION run.
    Returns the launch counts of the UNET_TRAIN_STEPS-step run."""
    import gc
    import shutil
    import threading

    from torch.profiler import ProfilerActivity, profile

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.config import load_config
    from videomv_tpu_torch.data.datasets import SyntheticMVDataset, batch_iterator
    from videomv_tpu_torch.ops.flash_attention import attention_reference
    from videomv_tpu_torch.parallel import build_train_step, draw_train_randoms, make_t2v_apply
    from videomv_tpu_torch.training.__main__ import main as train_cli
    from videomv_tpu_torch.training.engine import T2VTrainer

    global _PIPE, _HOST_UNET
    _PIPE = _HOST_UNET = None  # the trainer builds its own models
    gc.collect()
    torch.cuda.empty_cache()
    os.chdir(ROOT)
    t0 = time.time()
    cfg = load_config("configs/t2v_train.yaml", opts=UNET_TRAIN_OPTS)
    trainer = T2VTrainer(cfg, device="cuda").init(zero_init=False)
    unet, dev = trainer.unet, trainer.device
    n_unet = sum(p.numel() for p in unet.parameters())
    opt = trainer.state.optimizer
    say("unet_train", f"T2VTrainer of configs/t2v_train.yaml (use_lgm_refine "
        f"{trainer.use_lgm_refine}): UNet dim {unet.dim} x {tuple(unet.dim_mult)}, "
        f"{n_unet / 1e9:.3f} B parameters all trained (fp32, autocast "
        f"{trainer.dtype}), use_checkpoint {unet.use_checkpoint} ({unet.remat_policy}), "
        f"{trainer.max_frames} views at {trainer.resolution}, {type(opt).__name__} with "
        f"grad_scale {opt.grad_scale} on {len(opt.scaled)} SD-origin tensors, EMA "
        f"{trainer.state.ema is not None}; init {time.time() - t0:.1f}s")
    if (trainer.use_lgm_refine or not unet.use_checkpoint or unet.dim != 320
            or trainer.max_frames != UNET_TRAIN_VIEWS or not n_unet > 1.4e9):
        fail("unet_train", "configs/t2v_train.yaml no longer ships the full-width UNet finetune")

    frozen = {n: _module_checksum(torch, getattr(trainer, n)) for n in ("vae", "clip")}
    before = _module_checksum(torch, unet)

    # ---- the main path: UNET_TRAIN_STEPS steps through T2VTrainer.train
    losses = []
    step_fn = trainer.train_step

    def logged_step(*a, **k):
        loss = step_fn(*a, **k)
        losses.append(loss)
        return loss
    trainer.train_step = logged_step
    n_threads = threading.active_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    last = trainer.train(num_steps=UNET_TRAIN_STEPS, batch_size=UNET_TRAIN_BATCH)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    counts, shapes = ops.launch_counts(), ops.launch_counts_by_shape()
    main_counts = counts
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer.train_step = step_fn
    vals = [float(x) for x in losses]
    rows = UNET_TRAIN_BATCH * UNET_TRAIN_VIEWS
    say("unet_train", f"{UNET_TRAIN_STEPS} steps at batch {UNET_TRAIN_BATCH} ({rows} rows) in "
        f"{run_s:.3f} s (the first includes warm-up), peak {peak:.2f} GiB, loss per step "
        f"{vals}, launches {counts}, attention launches by shape {shapes['flash_attention']}, "
        f"its backward's {shapes['flash_attention_bwd']}")
    want = {k: v * UNET_TRAIN_STEPS for k, v in UNET_TRAIN_LAUNCHES.items()}
    if counts != want:
        fail("unet_train", f"expected launches {want}, got {counts}")
    want = unet_train_by_shape(rows, UNET_TRAIN_STEPS)
    if _without_kernel_6(shapes) != want:
        fail("unet_train", f"expected launches by shape {want}, got {shapes}")
    if len(vals) != UNET_TRAIN_STEPS or not all(v == v and abs(v) < 1e30 for v in vals):
        fail("unet_train", f"non-finite loss in {vals}")
    if last != vals[-1] or trainer.state.step != UNET_TRAIN_STEPS:
        fail("unet_train", "train() did not return the last loss after UNET_TRAIN_STEPS steps")
    if threading.active_count() != n_threads:
        fail("unet_train", f"the prefetch worker outlived train(): {n_threads} threads before, "
             f"{[t.name for t in threading.enumerate()]} after")
    after = _module_checksum(torch, unet)
    still = [n for (n, _), a, b in zip(unet.named_parameters(), before, after) if a == b]
    if still:
        fail("unet_train", f"{len(still)} of {len(after)} UNet parameters did not move: "
             f"{still[:10]}")
    for name, sums in frozen.items():
        if sums != _module_checksum(torch, getattr(trainer, name)):
            fail("unet_train", f"the frozen {name} changed")
    say("unet_train", f"all {len(after)} UNet parameter tensors moved; VAE and text tower "
        f"bit-identical; optimizer count {opt.count}")
    del before, after, frozen

    # ---- a step by parts (CUDA events), median of 3, and the host wall
    host = next(batch_iterator(SyntheticMVDataset(resolution=tuple(trainer.resolution),
                                                  max_frames=trainer.max_frames),
                               UNET_TRAIN_BATCH))
    gen = torch.Generator(device=dev).manual_seed(3)
    p_zero = float(cfg.get("p_zero", 0.1))
    _step_by_parts(torch, trainer, host, gen, p_zero, rows, 3)

    # ---- the device busy share of whole steps under torch.profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(2):
            trainer.train_step(trainer.state, trainer.encode_batch(host), generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    if busy == 0:
        say("unet_train", "torch.profiler recorded no device time: busy share not measured")
    else:
        classes = {}
        for name, ms in kernels.items():
            low = name.lower()
            cls = next((c for c, keys in _KERNEL_CLASSES if any(k in low for k in keys)),
                       "other")
            classes[cls] = classes.get(cls, 0.0) + ms
        say("unet_train", f"torch.profiler, 2 train steps (encode included): wall "
            f"{wall_ms / 2:.2f} ms, kernels {busy / 2:.2f} ms per step, device busy "
            f"{100 * busy / wall_ms:.1f}%")
        for cls, ms in sorted(classes.items(), key=lambda kv: -kv[1]):
            print(f"  {cls:24s} {ms / 2:9.3f} ms/step {100 * ms / busy:5.1f}%", flush=True)
        for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
            print(f"  {ms / 2:9.3f} ms/step  {name[:110]}", flush=True)
    del prof, kernels

    # ---- what the attention's forward and backward cost, alone, at the
    # step's shapes: kernel 1 (forward, then forward + backward kernel) against
    # the plain twin's forward + autograd backward, each with its peak above
    # the inputs
    pieces = {}
    for shape in unet_train_attn_shapes(rows):
        g2 = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (torch.randn(shape, generator=g2, device=dev).bfloat16().requires_grad_()
                   for _ in range(3))
        go = torch.randn(shape, generator=g2, device=dev).bfloat16()
        with torch.no_grad():
            pieces[f"kernel 1 forward {shape}"] = _time_one(
                torch, lambda: ops.flash_attention.flash_attention(q, k, v), 5)
        for name, fn in (("kernel 1", ops.flash_attention.flash_attention),
                         ("twin", attention_reference)):
            pieces[f"{name} forward + backward {shape}"] = _time_one(
                torch, lambda: torch.autograd.grad(fn(q, k, v), (q, k, v), go), 3)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            torch.autograd.grad(fn(q, k, v), (q, k, v), go)
            pieces[f"{name} forward + backward peak GiB {shape}"] = (
                torch.cuda.max_memory_allocated() - base) / 2**30
        del q, k, v, go
    say("unet_train", "attention alone at the step's shapes (10 calls of each a step, each "
        "forward twice, one backward): " + "; ".join(
            f"{k} {v:.3f}" + ("" if "GiB" in k else " ms") for k, v in pieces.items()))

    # ---- one step's UNet gradient: bf16 autocast + kernel 1 vs fp32 + plain
    # paths, same batch and draws, every dropout at p = 0 in training mode
    feats = trainer.encode_batch(host)
    draws = draw_train_randoms(gen, feats["latents"], trainer.diffusion, p_zero)
    dropouts = [(m, m.p) for m in unet.modules() if isinstance(m, torch.nn.Dropout)]
    for m, _ in dropouts:
        m.p = 0.0

    def unet_grad(loss_fn):
        opt.zero_grad()
        loss = loss_fn(feats, draws)
        loss.backward()
        flat = torch.cat([p.grad.flatten() for p in unet.parameters()])
        opt.zero_grad()
        return loss.item(), flat

    ops.reset_launch_counts()
    loss16, g16 = unet_grad(trainer.train_step.loss_fn)
    k16 = ops.launch_counts()
    plain = build_train_step(make_t2v_apply(unet), trainer.diffusion, use_ema=False,
                             p_zero=p_zero, zero_y=trainer.zero_y, autocast_dtype=None)
    ops.reset_launch_counts()
    loss32, g32 = unet_grad(plain.loss_fn)
    if any(ops.launch_counts().values()) or k16 != UNET_TRAIN_LAUNCHES:
        fail("unet_train", f"launches: bf16 step {k16}, fp32 step {ops.launch_counts()}")
    for m, p in dropouts:
        m.p = p
    cos = (torch.dot(g16, g32) / (g16.norm() * g32.norm())).item()
    ratio = (g16.norm() / g32.norm()).item()
    rel_l2 = ((g16 - g32).norm() / g32.norm()).item()
    say("unet_train", f"UNet gradient of one step ({g16.numel() / 1e9:.3f} B values), same "
        f"batch and draws, dropout 0 in training mode, bf16 autocast + kernel 1 vs fp32 + plain "
        f"paths: loss {loss16:.6f} vs {loss32:.6f}, cosine {cos:.4f} (bound >= "
        f"{TRAIN_GRAD_MIN_COS}), |g16|/|g32| {ratio:.4f} (bound {TRAIN_GRAD_NORM_RATIO}), "
        f"|d|/|ref| {rel_l2:.3e}")
    if (not cos >= TRAIN_GRAD_MIN_COS
            or not TRAIN_GRAD_NORM_RATIO[0] <= ratio <= TRAIN_GRAD_NORM_RATIO[1]):
        fail("unet_train", "the bf16 gradient disagrees with the fp32 one")
    del g16, g32, feats, plain

    # ---- the visualisation hook once on the live UNet (eval mode, bf16
    # autocast over the fp32 masters), 2 DDIM steps of one validation prompt
    trainer.cfg.ddim_timesteps = 2
    viz_dir = os.path.join(ROOT, "workspace", "chip_smoke_unet_train")
    hook = trainer.make_viz_hook(viz_dir)
    hook.prompts = hook.prompts[:1]
    t1 = time.perf_counter()
    written = hook(trainer.state.step, unet) if hook is not None else None
    say("unet_train", f"viz hook, 1 prompt x 2 DDIM steps with CFG: wrote {written} in "
        f"{time.perf_counter() - t1:.1f} s; UNet back in training mode {unet.training}")
    if not written or not os.path.exists(written) or not unet.training:
        fail("unet_train", "the visualisation hook wrote nothing")
    del hook

    # ---- save / restore of the full-width state: parameters, moments, step
    ckpt_dir = os.path.join(ROOT, "workspace", "chip_smoke_unet_train", "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    need = sum(t.numel() * t.element_size()
               for t in list(unet.parameters()) + opt.mu + opt.nu)
    free = shutil.disk_usage(ckpt_dir).free
    say("unet_train", f"checkpoint of {need / 2**30:.2f} GiB, {free / 2**30:.1f} GiB free")
    if free < 1.1 * need:
        fail("unet_train", "the disk cannot hold the full-width checkpoint")
    ref = [t.detach().clone() for t in list(unet.parameters()) + opt.mu + opt.nu]
    step_before, count_before = trainer.state.step, opt.count
    t1 = time.perf_counter()
    path = trainer.save(ckpt_dir)
    save_s = time.perf_counter() - t1
    with torch.no_grad():
        for t in list(unet.parameters()) + opt.mu + opt.nu:
            t.zero_()
    trainer.state.step, opt.count = 0, 0
    t1 = time.perf_counter()
    trainer.restore(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    same = all(torch.equal(a, b) for a, b in zip(ref, list(unet.parameters()) + opt.mu + opt.nu))
    say("unet_train", f"save / restore: {os.path.getsize(path) / 2**30:.2f} GiB, save "
        f"{save_s:.1f} s, restore {load_s:.1f} s, step {trainer.state.step}, count {opt.count}, "
        f"parameters and both moments identical {same}")
    if not same or (trainer.state.step, opt.count) != (step_before, count_before):
        fail("unet_train", "the checkpoint did not restore the train state")
    os.remove(path)
    del trainer, ref, unet, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the CLI once, on the card by default, at the shipped batch
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    loss = train_cli(["--cfg", "configs/t2v_train.yaml", "--steps", "2", "--batch-size",
                      str(UNET_TRAIN_CLI_BATCH), *UNET_TRAIN_OPTS])
    say("unet_train", f"CLI main() --steps 2 --batch-size {UNET_TRAIN_CLI_BATCH} (the shipped "
        f"batch_sizes['24']): final loss {loss:.6f} in {time.time() - t1:.1f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not loss == loss:
        fail("unet_train", "the CLI's loss is not finite")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- configs/t2v_train_laion.yaml: image steps at f = 1 every 2nd step
    shard = os.path.join(ROOT, "workspace", "chip_smoke_laion", "00000.tar")
    _write_laion_shard(shard, 2 * UNET_TRAIN_IMAGE_BATCH)
    laion = load_config("configs/t2v_train_laion.yaml", opts=[
        *UNET_TRAIN_OPTS, "image_every", str(UNET_TRAIN_IMAGE_EVERY),
        "img_dataset.shards", json.dumps([shard])])
    shipped = laion.batch_sizes
    if int(shipped["1"]) != UNET_TRAIN_IMAGE_BATCH:
        fail("unet_train", f"configs/t2v_train_laion.yaml ships image batch {shipped['1']}")
    t1 = time.time()
    if int(shipped["24"]) != UNET_TRAIN_LAION_BATCH:
        fail("unet_train", f"configs/t2v_train_laion.yaml ships video batch {shipped['24']}")
    trainer = T2VTrainer(laion, device="cuda").init(zero_init=False)
    seen, step_s = [], []
    step_fn = trainer.train_step

    def shape_step(state, feats, **kw):
        seen.append(tuple(feats["latents"].shape))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = step_fn(state, feats, **kw)
        torch.cuda.synchronize()
        step_s.append(round(time.perf_counter() - t2, 3))
        return out
    trainer.train_step = shape_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    loss = trainer.train(num_steps=UNET_TRAIN_LAION_STEPS)  # the shipped batch_sizes
    torch.cuda.synchronize()
    counts, shapes = ops.launch_counts(), ops.launch_counts_by_shape()
    n_img = sum(1 for s in seen if s[2] == 1)
    say("unet_train", f"configs/t2v_train_laion.yaml (EMA {trainer.state.ema is not None}), "
        f"{UNET_TRAIN_LAION_STEPS} steps, image_every {UNET_TRAIN_IMAGE_EVERY} (shipped "
        f"{load_config('configs/t2v_train_laion.yaml').image_every}), the shipped batches "
        f"{dict(shipped)}: latents per step {seen}, step seconds (host, synchronised, the "
        f"first of each shape includes warm-up) {step_s}, final loss {loss:.6f}, launches "
        f"{counts}, attention by shape {shapes['flash_attention']}, its backward's "
        f"{shapes['flash_attention_bwd']}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {time.time() - t1:.1f}s with init")
    n_vid = UNET_TRAIN_LAION_STEPS - n_img
    want = unet_train_by_shape(UNET_TRAIN_IMAGE_BATCH, n_img)
    for name, by in unet_train_by_shape(UNET_TRAIN_LAION_BATCH * UNET_TRAIN_VIEWS, n_vid).items():
        for k, v in by.items():
            want[name][k] = want[name].get(k, 0) + v
    if (n_img != UNET_TRAIN_LAION_STEPS // UNET_TRAIN_IMAGE_EVERY
            or {s[0] for s in seen} != {UNET_TRAIN_LAION_BATCH, UNET_TRAIN_IMAGE_BATCH}
            or _without_kernel_6(shapes) != want or not loss == loss):
        fail("unet_train", f"joint LAION run: expected launches by shape {want} with "
             f"{UNET_TRAIN_LAION_STEPS // UNET_TRAIN_IMAGE_EVERY} image steps")
    # one video step at the shipped batch by parts, and its peak
    trainer.train_step = step_fn
    host = next(batch_iterator(SyntheticMVDataset(resolution=tuple(trainer.resolution),
                                                  max_frames=trainer.max_frames),
                               UNET_TRAIN_LAION_BATCH))
    torch.cuda.reset_peak_memory_stats()
    _step_by_parts(torch, trainer, host, torch.Generator(device=trainer.device).manual_seed(4),
                   float(laion.get("p_zero", 0.1)), UNET_TRAIN_LAION_BATCH * UNET_TRAIN_VIEWS, 1)
    say("unet_train", f"peak of that step (EMA and AdamW state resident) "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del trainer, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return main_counts


def phase_i2v_train(torch):
    """configs/i2vgen_xl_train.yaml as shipped (no override to the model) at
    full width on the card: (a) the I2V UNet finetune — T2VTrainer takes
    I2V_TRAIN_STEPS steps at batch I2V_TRAIN_BATCH (launch counters reset
    just before, read just after and held by shape), then a step by parts,
    the busy share and one step's UNet gradient bf16 with kernel 1 vs fp32
    plain; (b) i2v_viz once over the EMA weights, hit by viz_interval inside
    a one-step run; the CLI at the shipped batch with its peak memory; (c) the
    same config with UNet.use_lgm_refine True: I2V_TRAIN_STEPS LGM-refine
    steps at batch 1 behind the frozen I2V UNet with launches held by shape,
    and the LGM gradient bf16 with kernels 3 + 4 vs fp32 plain. Returns the
    launch counts of the two runs of (a) and (c)."""
    import gc
    import threading

    from torch.profiler import ProfilerActivity, profile

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.config import load_config
    from videomv_tpu_torch.data.datasets import SyntheticMVDataset, batch_iterator
    from videomv_tpu_torch.models import OpenCLIPTextVisual, UNetSD_I2VGen
    from videomv_tpu_torch.parallel import build_train_step, draw_train_randoms, make_i2v_apply
    from videomv_tpu_torch.parallel.train_step import _dropout_stream
    from videomv_tpu_torch.training.__main__ import main as train_cli
    from videomv_tpu_torch.training.engine import T2VTrainer
    from videomv_tpu_torch.training.lgm_refine import build_lgm_refine_step, draw_refine_randoms

    global _PIPE, _HOST_UNET
    _PIPE = _HOST_UNET = None  # the trainer builds its own models
    gc.collect()
    torch.cuda.empty_cache()
    os.chdir(ROOT)
    phase_t0 = t0 = time.time()
    shipped = load_config(I2V_TRAIN_CFG)
    cfg = load_config(I2V_TRAIN_CFG, opts=I2V_TRAIN_OPTS)
    trainer = T2VTrainer(cfg, device="cuda").init(zero_init=False)
    unet, dev, opt = trainer.unet, trainer.device, trainer.state.optimizer
    n_unet = sum(p.numel() for p in unet.parameters())
    n_clip = sum(p.numel() for p in trainer.clip.parameters())
    dropouts = [m for m in unet.modules() if isinstance(m, torch.nn.Dropout)]
    d = trainer.diffusion
    say("i2v_train", f"T2VTrainer of {I2V_TRAIN_CFG} (is_i2v {trainer.is_i2v}): "
        f"{type(unet).__name__} dim {unet.dim} x {tuple(unet.dim_mult)}, {n_unet / 1e9:.3f} B "
        f"parameters all trained (fp32, autocast {trainer.dtype}), use_checkpoint "
        f"{unet.use_checkpoint}, dropout {sorted({m.p for m in dropouts})}; "
        f"{type(trainer.clip).__name__} {n_clip / 1e6:.1f} M frozen in "
        f"{next(trainer.clip.parameters()).dtype}; diffusion {cfg.Diffusion.schedule} "
        f"{dict(cfg.Diffusion.schedule_param)} / {d.mean_type}, "
        f"noise_strength {d.noise_strength}; p_zero {cfg.p_zero}; {type(opt).__name__} with "
        f"grad_scale {opt.grad_scale} on {len(opt.scaled)} SD-origin tensors; EMA "
        f"{trainer.state.ema is not None}; {trainer.max_frames} views at {trainer.resolution}; "
        f"init {time.time() - t0:.1f}s")
    if (not trainer.is_i2v or not isinstance(unet, UNetSD_I2VGen) or trainer.use_lgm_refine
            or not isinstance(trainer.clip, OpenCLIPTextVisual) or not unet.use_checkpoint
            or unet.dim != 320 or not n_unet > 1.42e9 or trainer.state.ema is None
            or d.mean_type != "v" or d.noise_strength != 0.1 or float(cfg.p_zero) != 0.0
            or opt.grad_scale != 0.5 or not opt.scaled
            or trainer.max_frames != UNET_TRAIN_VIEWS):
        fail("i2v_train", f"{I2V_TRAIN_CFG} no longer ships the full-width I2V finetune")

    frozen = {n: _module_checksum(torch, getattr(trainer, n)) for n in ("vae", "clip")}
    before = _module_checksum(torch, unet)
    ema_before = [_bits_checksum(torch, e) for e in trainer.state.ema]

    # ---- (a) the main path: I2V_TRAIN_STEPS steps through T2VTrainer.train
    t0 = time.time()
    losses = []
    step_fn = trainer.train_step

    def logged_step(*a, **k):
        loss = step_fn(*a, **k)
        losses.append(loss)
        return loss
    trainer.train_step = logged_step
    n_threads = threading.active_count()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    last = trainer.train(num_steps=I2V_TRAIN_STEPS, batch_size=I2V_TRAIN_BATCH)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    counts, shapes = ops.launch_counts(), ops.launch_counts_by_shape()
    unet_counts = counts
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer.train_step = step_fn
    vals = [float(x) for x in losses]
    rows = I2V_TRAIN_BATCH * UNET_TRAIN_VIEWS
    say("i2v_train", f"{I2V_TRAIN_STEPS} steps at batch {I2V_TRAIN_BATCH} ({rows} rows) in "
        f"{run_s:.3f} s (the first includes warm-up), peak {peak:.2f} GiB, loss per step "
        f"{vals}, launches {counts}, attention launches by shape {shapes['flash_attention']}")
    want = {k: v * I2V_TRAIN_STEPS for k, v in UNET_TRAIN_LAUNCHES.items()}
    if counts != want:
        fail("i2v_train", f"expected launches {want}, got {counts}")
    want = unet_train_by_shape(rows, I2V_TRAIN_STEPS)
    if _without_kernel_6(shapes) != want:
        fail("i2v_train", f"expected launches by shape {want}, got {shapes}")
    if len(vals) != I2V_TRAIN_STEPS or not all(v == v and abs(v) < 1e30 for v in vals):
        fail("i2v_train", f"non-finite loss in {vals}")
    if last != vals[-1] or trainer.state.step != I2V_TRAIN_STEPS:
        fail("i2v_train", "train() did not return the last loss after I2V_TRAIN_STEPS steps")
    if threading.active_count() != n_threads:
        fail("i2v_train", f"the prefetch worker outlived train(): {n_threads} threads before, "
             f"{[t.name for t in threading.enumerate()]} after")
    after = _module_checksum(torch, unet)
    still = sum(a == b for a, b in zip(before, after))
    ema_after = [_bits_checksum(torch, e) for e in trainer.state.ema]
    ema_still = sum(a == b for a, b in zip(ema_before, ema_after))
    # an EMA tensor whose step is below its float32 ulp at decay 0.9999 may stay
    if still or ema_still == len(after):
        fail("i2v_train", f"{still} UNet and {ema_still} EMA tensors of {len(after)} did not move")
    for name, sums in frozen.items():
        if sums != _module_checksum(torch, getattr(trainer, name)):
            fail("i2v_train", f"the frozen {name} changed")
    say("i2v_train", f"all {len(after)} UNet parameter tensors moved, their EMA "
        f"{len(after) - ema_still}; VAE and text + visual towers bit-identical; optimizer count "
        f"{opt.count}; "
        f"{time.time() - t0:.1f}s")
    del before, after, frozen, ema_before, ema_after

    # ---- a step by parts (CUDA events), median of 3, and the host wall
    t0 = time.time()
    host = next(batch_iterator(SyntheticMVDataset(resolution=tuple(trainer.resolution),
                                                  max_frames=trainer.max_frames),
                               I2V_TRAIN_BATCH))
    gen = torch.Generator(device=dev).manual_seed(3)
    p_zero = float(cfg.get("p_zero", 0.1))
    ema, decay = trainer.state.ema, float(cfg.get("ema_decay", 0.9999))
    runs, walls = [], []
    for _ in range(3):
        timers = _EventTimers(torch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with timers(f"encode (VAE {rows} frames, text, view 0 through the visual tower)"):
            feats = trainer.encode_batch(host)
        draws = draw_train_randoms(gen, feats["latents"], trainer.diffusion, p_zero)
        opt.zero_grad()
        with _dropout_stream(gen):
            with timers("forward (q_sample, UNet, loss)"):
                loss = trainer.train_step.loss_fn(feats, draws)
            with timers("backward (recompute + grads)"):
                loss.backward()
        with timers("optimizer (AdamW, key scale)"):
            opt.step()
        with timers("EMA lerp"), torch.no_grad():
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, [p.detach() for p in unet.parameters()], alpha=1 - decay)
        ms = timers.ms()
        walls.append((time.perf_counter() - t1) * 1e3)
        runs.append(ms)
    trainer.state.step += 3
    del loss
    parts = {k: sorted(r[k] for r in runs)[1] for k in runs[0]}
    say("i2v_train", "CUDA events, one step by part (median of 3): " + "; ".join(
        f"{k} {v:.2f} ms" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.2f} ms; host wall of the step, median "
        f"{sorted(walls)[1]:.2f} ms (walls {[round(w, 2) for w in walls]}); {CLOCKS_QUERY}: "
        f"{nvidia_smi_line(CLOCKS_QUERY)}; {time.time() - t0:.1f}s")

    # ---- the device busy share of whole steps under torch.profiler
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(2):
            trainer.train_step(trainer.state, trainer.encode_batch(host), generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    busy = sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    del prof
    say("i2v_train", (f"torch.profiler, 2 train steps (encode included): wall {wall_ms / 2:.2f} "
                      f"ms, kernels {busy / 2:.2f} ms per step, device busy "
                      f"{100 * busy / wall_ms:.1f}%" if busy else
                      "torch.profiler recorded no device time: busy share not measured")
        + f"; {time.time() - t0:.1f}s")

    # ---- one step's UNet gradient: bf16 autocast + kernel 1 vs fp32 + plain
    # paths, same batch and draws, every dropout at p = 0 in training mode
    t0 = time.time()
    feats = trainer.encode_batch(host)
    draws = draw_train_randoms(gen, feats["latents"], trainer.diffusion, p_zero)
    kept = [m.p for m in dropouts]
    for m in dropouts:
        m.p = 0.0

    def unet_grad(loss_fn):
        opt.zero_grad()
        loss = loss_fn(feats, draws)
        loss.backward()
        flat = torch.cat([p.grad.flatten() for p in unet.parameters()])
        opt.zero_grad()
        return loss.item(), flat

    ops.reset_launch_counts()
    loss16, g16 = unet_grad(trainer.train_step.loss_fn)
    k16 = ops.launch_counts()
    plain = build_train_step(make_i2v_apply(unet), trainer.diffusion, use_ema=False,
                             p_zero=p_zero, zero_y=trainer.zero_y, autocast_dtype=None)
    ops.reset_launch_counts()
    loss32, g32 = unet_grad(plain.loss_fn)
    if any(ops.launch_counts().values()) or k16 != UNET_TRAIN_LAUNCHES:
        fail("i2v_train", f"launches: bf16 step {k16}, fp32 step {ops.launch_counts()}")
    for m, p in zip(dropouts, kept):
        m.p = p
    cos = (torch.dot(g16, g32) / (g16.norm() * g32.norm())).item()
    ratio = (g16.norm() / g32.norm()).item()
    rel_l2 = ((g16 - g32).norm() / g32.norm()).item()
    say("i2v_train", f"I2V UNet gradient of one step ({g16.numel() / 1e9:.3f} B values), same "
        f"batch and draws, dropout 0 in training mode, bf16 autocast + kernel 1 vs fp32 + plain "
        f"paths: loss {loss16:.6f} vs {loss32:.6f}, cosine {cos:.4f} (bound >= "
        f"{TRAIN_GRAD_MIN_COS}), |g16|/|g32| {ratio:.4f} (bound {TRAIN_GRAD_NORM_RATIO}), "
        f"|d|/|ref| {rel_l2:.3e}; {time.time() - t0:.1f}s")
    if (not cos >= TRAIN_GRAD_MIN_COS
            or not TRAIN_GRAD_NORM_RATIO[0] <= ratio <= TRAIN_GRAD_NORM_RATIO[1]):
        fail("i2v_train", "the bf16 gradient disagrees with the fp32 one")
    del g16, g32, feats, plain

    # ---- (b) i2v_viz once over the EMA weights: viz_interval hits the next
    # step of a one-step run; a logged "i2v viz failed" fails the phase
    t0 = time.time()
    step = trainer.state.step + 1
    trainer.cfg.viz_interval = step
    viz_path = os.path.join(trainer.cfg.log_dir, "viz", f"viz_step_{step:08d}")
    logs = _LogCapture("videomv_tpu_torch.training.engine")
    with logs:
        ops.reset_launch_counts()
        trainer.train(num_steps=1, batch_size=I2V_TRAIN_BATCH)
        torch.cuda.synchronize()
        viz_counts, viz_shapes = ops.launch_counts(), ops.launch_counts_by_shape()
    written = [p for p in (viz_path + ".mp4", viz_path) if os.path.exists(p)]
    failed = [r for r in logs.records if "i2v viz failed" in r]
    say("i2v_train", f"i2v_viz at step {step} (viz_interval {step}, {cfg.get('ddim_timesteps', 50)} "
        f"DDIM steps, CFG {cfg.visual_train.guide_scale}, EMA weights): wrote {written}, "
        f"launches of the one-step run with it {viz_counts}, attention by shape "
        f"{viz_shapes['flash_attention']}, UNet back in training mode {unet.training}; "
        f"{time.time() - t0:.1f}s")
    if failed or not written or not unet.training or not any(
            "wrote i2v visualization" in r for r in logs.records):
        fail("i2v_train", f"i2v_viz wrote nothing: {failed or logs.records[-3:]}")
    del trainer, unet, opt, step_fn, ema, host, dropouts
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the CLI once, on the card by default, at the shipped batch
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    loss = train_cli(["--cfg", I2V_TRAIN_CFG, "--steps", "2", "log_dir", I2V_TRAIN_LOG_DIR])
    cli_peak = torch.cuda.max_memory_allocated() / 2**30
    say("i2v_train", f"CLI main() --cfg {I2V_TRAIN_CFG} --steps 2 (the shipped batch_sizes "
        f"{dict(shipped.batch_sizes)}, EMA on, no model override): final loss {loss:.6f}, peak "
        f"{cli_peak:.2f} GiB; {time.time() - t0:.1f}s with init")
    if not loss == loss:
        fail("i2v_train", "the CLI's loss is not finite")
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) the LGM-refine finetune behind the frozen I2V UNet
    t0 = time.time()
    rcfg = load_config(I2V_TRAIN_CFG, opts=[*I2V_TRAIN_OPTS, "UNet.use_lgm_refine", "True"])
    trainer = T2VTrainer(rcfg, device="cuda").init(zero_init=False)
    lopt = trainer.lgm.opt
    say("i2v_train", f"T2VTrainer of {I2V_TRAIN_CFG} + use_lgm_refine: frozen "
        f"{type(trainer.unet).__name__} in {next(trainer.unet.parameters()).dtype} (training "
        f"mode {trainer.unet.training}), LGM {sum(p.numel() for p in trainer.lgm.parameters()) / 1e6:.1f} M "
        f"trained, {lopt.num_views} supervision views at {lopt.output_size}², view chunk "
        f"{trainer._step_kwargs['view_chunk']}; init {time.time() - t0:.1f}s")
    if (not trainer.is_i2v or (lopt.output_size, trainer._step_kwargs["view_chunk"])
            != (TRAIN_RENDER_SIZE, TRAIN_VIEW_CHUNK) or not trainer.unet.training):
        fail("i2v_train", "the I2V refine no longer renders 512² in chunks of 2 views")
    t0 = time.time()
    lgm_before = [p.detach().to("cpu", copy=True) for p in trainer.lgm.parameters()]
    unet_sums = _module_checksum(torch, trainer.unet)
    rlosses = []
    rstep = trainer.refine_step

    def logged_refine(*a, **k):
        loss, aux = rstep(*a, **k)
        rlosses.append((loss, aux["psnr"], aux["loss_lpips"]))
        return loss, aux
    trainer.refine_step = logged_refine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    trainer.train(num_steps=I2V_TRAIN_STEPS, batch_size=1)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    refine_counts, shapes = ops.launch_counts(), ops.launch_counts_by_shape()
    peak = torch.cuda.max_memory_allocated() / 2**30
    trainer.refine_step = rstep
    vals = [[float(x) for x in row] for row in rlosses]
    say("i2v_train", f"I2V refine: {I2V_TRAIN_STEPS} steps at batch 1 in {run_s:.3f} s (the "
        f"first includes warm-up), peak {peak:.2f} GiB, (loss, psnr, lpips) per step {vals}, "
        f"launches {refine_counts}, attention by shape {shapes['flash_attention']}")
    want = {k: v * I2V_TRAIN_STEPS for k, v in TRAIN_LAUNCHES.items()}
    if refine_counts != want:
        fail("i2v_train", f"refine: expected launches {want}, got {refine_counts}")
    want = {"flash_attention": {k: v * I2V_TRAIN_STEPS for k, v in TRAIN_ATTN_SHAPES.items()},
            "flash_attention_bwd": {k: v * I2V_TRAIN_STEPS
                                    for k, v in TRAIN_ATTN_BWD_SHAPES.items()},
            "geglu_ffn": {}, "fused_spatial": {}}
    if _without_kernel_6(shapes) != want:
        fail("i2v_train", f"refine: expected launches by shape {want}, got {shapes}")
    if len(vals) != I2V_TRAIN_STEPS or not all(x == x and abs(x) < 1e30 for r in vals for x in r):
        fail("i2v_train", f"refine: non-finite loss in {vals}")
    moved = max((a - b.detach().cpu()).abs().max().item()
                for a, b in zip(lgm_before, trainer.lgm.parameters()))
    if not moved > 0 or _module_checksum(torch, trainer.unet) != unet_sums:
        fail("i2v_train", "refine: the LGM did not move or the frozen I2V UNet changed")
    del lgm_before

    # the LGM gradient of one step from the same LGM input: bf16 autocast +
    # kernels vs fp32 + plain paths
    host = next(batch_iterator(SyntheticMVDataset(resolution=tuple(trainer.resolution),
                                                  max_frames=trainer.max_frames), 1))
    feats = trainer.encode_batch(host)
    feats.update(trainer._gs_features(host))
    draws = draw_refine_randoms(gen, feats["latents"], trainer.diffusion,
                                lopt.num_input_views, lopt.num_views - lopt.num_input_views)
    prep = trainer.refine_step.prepare(feats, draws)

    def lgm_grads(step):
        trainer.lgm_state.optimizer.zero_grad()
        loss, _ = step.loss_from(prep)
        loss.backward()
        flat = torch.cat([p.grad.flatten() for p in trainer.lgm.parameters()])
        trainer.lgm_state.optimizer.zero_grad()
        return loss.item(), flat

    ops.reset_launch_counts()
    loss16, g16 = lgm_grads(trainer.refine_step)
    k16 = ops.launch_counts()
    plain = build_lgm_refine_step(trainer.unet_apply, trainer.vae, trainer.lgm,
                                  trainer.diffusion,
                                  **dict(trainer._step_kwargs, autocast_dtype=None))
    with _TwinSplat():
        ops.reset_launch_counts()
        loss32, g32 = lgm_grads(plain)
        if any(ops.launch_counts().values()):
            fail("i2v_train", f"the fp32 reference launched kernels: {ops.launch_counts()}")
    cos = (torch.dot(g16, g32) / (g16.norm() * g32.norm())).item()
    ratio = (g16.norm() / g32.norm()).item()
    rel_l2 = ((g16 - g32).norm() / g32.norm()).item()
    say("i2v_train", f"I2V refine LGM gradient of one step ({g16.numel() / 1e6:.1f} M values) "
        f"from the same LGM input, bf16 autocast + kernels ({k16}) vs fp32 + plain paths: loss "
        f"{loss16:.6f} vs {loss32:.6f}, cosine {cos:.4f} (bound >= {TRAIN_GRAD_MIN_COS}), "
        f"|g16|/|g32| {ratio:.4f} (bound {TRAIN_GRAD_NORM_RATIO}), |d|/|ref| {rel_l2:.3e}; "
        f"{time.time() - t0:.1f}s")
    if (not cos >= TRAIN_GRAD_MIN_COS
            or not TRAIN_GRAD_NORM_RATIO[0] <= ratio <= TRAIN_GRAD_NORM_RATIO[1]
            or not k16["splat_composite"] or not k16["splat_composite_bwd"]):
        fail("i2v_train", "the I2V refine's bf16 LGM gradient disagrees with the fp32 one")
    del trainer, g16, g32, prep, feats, plain, rstep
    gc.collect()
    torch.cuda.empty_cache()
    say("i2v_train", f"phase {time.time() - phase_t0:.1f}s")
    return unet_counts, refine_counts


class _LogCapture(logging.Handler):
    """Within ``with``, keeps the messages (INFO and up) that the named
    logger emits; its level is restored on exit."""

    def __init__(self, name):
        super().__init__(level=logging.INFO)
        self.records, self._logger = [], logging.getLogger(name)

    def emit(self, record):
        self.records.append(record.getMessage())

    def __enter__(self):
        self._level = self._logger.level
        self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        self._logger.setLevel(self._level)


class _SeededWeights:
    """Stands in for ``training.checkpoints.init_weights`` for the run (every
    model of every phase is seeded through it): each (module layout, seed)
    is drawn once, by the program's own ``init_weights`` with ``zero_init=
    False`` on the host, and kept there. Any later request for it copies the
    kept values and, with ``zero_init``, zeroes the zero-init layers, which
    is what ``init_weights`` makes of the same draw. So the trainers of the
    later phases take the seeded UNets and towers of the earlier ones
    instead of drawing them again."""

    def __init__(self, init_weights):
        self._init, self._kept, self._key_locks = init_weights, {}, {}
        self._lock = threading.Lock()
        self.drawn_s = self.copied_s = 0.0

    def __call__(self, module, seed, zero_init=True, device=None):
        import copy

        import torch

        from videomv_tpu_torch.training.checkpoints import _zero_init_names

        key = (type(module).__name__, int(seed),
               tuple((n, tuple(p.shape)) for n, p in module.named_parameters()))
        with self._lock:
            key_lock = self._key_locks.setdefault(key, threading.Lock())
        with key_lock:
            if key not in self._kept:
                t0 = time.perf_counter()
                host = self._init(copy.deepcopy(module), seed, zero_init=False, device="cpu")
                self._kept[key] = {n: p.detach() for n, p in host.named_parameters()}
                self.drawn_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        kept = self._kept[key]
        if device is not None:
            module.to_empty(device=device)
        zeros = _zero_init_names(module) if zero_init else set()
        with torch.no_grad():
            for n, p in module.named_parameters():
                if n in zeros:
                    p.zero_()
                else:
                    p.copy_(kept[n])
        self.copied_s += time.perf_counter() - t0
        return module


def phase_init_cost(torch):
    """Where the seeded init of the I2V trainer's models (configs/
    i2vgen_xl_train.yaml: UNetSD_I2VGen, the joint text + visual tower, the
    SD VAE) spends its time, onto the card: the sequential loop that
    ``init_weights`` ran before (each parameter drawn, scaled and copied in
    turn; the three parts timed apart), then ``init_models`` of the three at
    once (the draw in a worker thread ahead of the scaling and copy, the
    models in threads); the two must give bit-identical parameters."""
    import math

    import numpy as np

    from videomv_tpu_torch.config import load_config
    from videomv_tpu_torch.inference.pipeline import unet_kwargs_from_cfg
    from videomv_tpu_torch.models import AutoencoderKL, OpenCLIPTextVisual, UNetSD_I2VGen
    from videomv_tpu_torch.training.checkpoints import _zero_init_names, init_models

    cfg = load_config(os.path.join(ROOT, I2V_TRAIN_CFG))

    def build():
        with torch.device("meta"):
            return [(UNetSD_I2VGen(**unet_kwargs_from_cfg(cfg.UNet)), 0),
                    (AutoencoderKL(), 1), (OpenCLIPTextVisual(), 2)]

    old, parts = build(), {"draw": 0.0, "scale": 0.0, "copy": 0.0}
    t0 = time.perf_counter()
    with torch.no_grad():
        for module, seed in old:  # init_weights as a sequential loop
            module.to_empty(device="cuda")
            rng = np.random.default_rng(seed)
            zeros = _zero_init_names(module)
            for name, p in module.named_parameters():
                shape = tuple(p.shape)
                t1 = time.perf_counter()
                n = rng.standard_normal(shape, dtype=np.float32)
                t2 = time.perf_counter()
                if name in zeros:
                    val = np.zeros(shape, np.float32)
                elif len(shape) >= 2:
                    val = n * np.float32(math.prod(shape[1:]) ** -0.5)
                elif name.endswith("weight"):
                    val = 1.0 + 0.1 * n
                else:
                    val = 0.1 * n
                t3 = time.perf_counter()
                p.copy_(torch.from_numpy(val))
                parts["draw"] += t2 - t1
                parts["scale"] += t3 - t2
                parts["copy"] += time.perf_counter() - t3
    torch.cuda.synchronize()
    old_s = time.perf_counter() - t0
    new = build()
    t0 = time.perf_counter()
    init_models(new, device="cuda")
    torch.cuda.synchronize()
    new_s = time.perf_counter() - t0
    n_vals = sum(p.numel() for m, _ in old for p in m.parameters())
    same = all(torch.equal(a, b) for (ma, _), (mb, _) in zip(old, new)
               for a, b in zip(ma.parameters(), mb.parameters()))
    say("init_cost", f"seeded init of UNetSD_I2VGen + SD VAE + joint CLIP ({n_vals / 1e9:.3f} B "
        f"values, zero_init on) onto the card: the sequential loop {old_s:.1f} s (numpy draw "
        f"{parts['draw']:.1f} s, scaling {parts['scale']:.1f} s, host-to-device copy "
        f"{parts['copy']:.1f} s); init_models {new_s:.1f} s; bit-identical {same}; "
        f"{os.cpu_count()} host cores")
    if not same:
        fail("init_cost", "init_models drew other values than the sequential loop")


def phase_unet_train_memory(torch):
    """One step of configs/t2v_train_laion.yaml as shipped (EMA on) at each
    (frames, batch) of UNET_TRAIN_MEMORY_BATCHES: its peak memory and wall,
    or the first line of the out-of-memory error. A measurement of what the
    card holds: the error is printed, and fails the phase only at the
    config's own batches."""
    import gc

    from videomv_tpu_torch.config import load_config
    from videomv_tpu_torch.data.datasets import batch_iterator
    from videomv_tpu_torch.training.engine import T2VTrainer

    os.chdir(ROOT)
    shard = os.path.join(ROOT, "workspace", "chip_smoke_laion", "00000.tar")
    _write_laion_shard(shard, max(b for f, b in UNET_TRAIN_MEMORY_BATCHES if f == 1))
    cfg = load_config("configs/t2v_train_laion.yaml",
                      opts=[*UNET_TRAIN_OPTS, "img_dataset.shards", json.dumps([shard])])
    trainer = T2VTrainer(cfg, device="cuda").init(zero_init=False)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    for frames, batch in UNET_TRAIN_MEMORY_BATCHES:
        ds = trainer.make_image_dataset() if frames == 1 else trainer.make_dataset()
        host = next(batch_iterator(ds, batch))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        try:
            loss = float(trainer.train_step(trainer.state, trainer.encode_batch(host),
                                            generator=gen))
            torch.cuda.synchronize()
            out = (f"loss {loss:.6f}, {(time.perf_counter() - t1) * 1e3:.1f} ms with its "
                   f"encode (first at this shape), peak "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        except torch.cuda.OutOfMemoryError as e:
            out = f"out of memory: {str(e).splitlines()[0]}"
            if int(cfg.batch_sizes.get(str(frames), 0)) == batch:
                fail("unet_train_memory", f"the shipped batch {batch} at f = {frames}: {out}")
        trainer.state.optimizer.zero_grad()
        del host
        gc.collect()
        torch.cuda.empty_cache()
        say("unet_train_memory", f"configs/t2v_train_laion.yaml, one step at f = {frames}, "
            f"batch {batch} ({frames * batch} UNet rows): {out}")

# ---------------------------------------------------------------- slice E


def _flat_grad(torch, unet):
    """Every UNet gradient as one fp32 vector (an FSDP shard gathered)."""
    from torch.distributed.tensor import DTensor

    return torch.cat([(p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad)
                      .float().flatten() for p in unet.parameters()])


class _GradCapture:
    """An optimizer that takes no step: ``step()`` keeps the gradient the
    optimizer would have used (after the step's all-reduce), or with
    ``keep=False`` its norm and every GRAD_SAMPLE_STRIDE-th entry alone (on
    the host)."""

    def __init__(self, torch, unet, keep=True):
        self.torch, self.unet, self.keep = torch, unet, keep
        self.flat = self.norm = self.sample = None

    def zero_grad(self):
        for p in self.unet.parameters():
            p.grad = None

    def step(self):
        flat = _flat_grad(self.torch, self.unet)
        self.norm = float(flat.norm())
        self.sample = flat[::GRAD_SAMPLE_STRIDE].cpu()
        self.flat = flat if self.keep else None


class _KeepGrads:
    """Steps ``opt`` and keeps the whole gradient (FSDP shards gathered) it
    stepped on, by parameter."""

    def __init__(self, opt, unet):
        self.opt, self.unet, self.grads = opt, unet, None

    def zero_grad(self):
        self.opt.zero_grad()

    def step(self):
        from torch.distributed.tensor import DTensor

        self.grads = [(p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad).clone()
                      for p in self.unet.parameters()]
        return self.opt.step()


def _grad_agreement(torch, got, ref):
    """(cosine, norm ratio) of two flattened gradients."""
    cos = (torch.dot(got, ref) / (got.norm() * ref.norm())).item()
    return cos, (got.norm() / ref.norm()).item()


def phase_dist_train(torch):
    """configs/t2v_train.yaml's UNet finetune at full width, batch 2, one step
    on a fixed batch and fixed draws: plain (no process group), then under
    torch.distributed at world size 1 on NCCL, replicated (the data-parallel
    step) and with the UNet's blocks FSDP-sharded, then one AdamW step of the
    sharded state. Each step's loss and gradient are held to the plain
    step's (the replicated loss bit-equal), its kernel 1 launches to twenty by
    shape, its peak memory printed. Writes the UNet, the batch and the draws
    for the multirank phase. Returns the launch counts of the two steps."""
    import gc

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.config import load_config
    from videomv_tpu_torch.data.datasets import SyntheticMVDataset, batch_iterator
    from videomv_tpu_torch.parallel import (
        TrainState,
        apply_fsdp,
        build_train_step,
        draw_train_randoms,
        init_distributed,
        make_mesh,
    )
    from videomv_tpu_torch.training.engine import T2VTrainer
    from videomv_tpu_torch.training.optim import build_optimizer

    global _PIPE, _HOST_UNET
    _PIPE = _HOST_UNET = None
    gc.collect()
    torch.cuda.empty_cache()
    os.chdir(ROOT)
    if dist.is_initialized():
        fail("dist_train", "a process group exists before the phase")
    t0 = time.time()
    cfg = load_config("configs/t2v_train.yaml", opts=UNET_TRAIN_OPTS)
    trainer = T2VTrainer(cfg, device="cuda").init(zero_init=False)
    unet, dev = trainer.unet, trainer.device
    if trainer.mesh is not None or unet.dim != 320 or trainer.max_frames != UNET_TRAIN_VIEWS:
        fail("dist_train", "configs/t2v_train.yaml no longer builds the one-device UNet finetune")
    host = next(batch_iterator(SyntheticMVDataset(resolution=tuple(trainer.resolution),
                                                  max_frames=trainer.max_frames),
                               DIST_TRAIN_BATCH))
    feats = trainer.encode_batch(host)
    p_zero = float(cfg.get("p_zero", 0.1))
    draws = draw_train_randoms(torch.Generator(device=dev).manual_seed(5), feats["latents"],
                               trainer.diffusion, p_zero)
    for m in unet.modules():  # the steps are compared: no dropout masks
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    rows = DIST_TRAIN_BATCH * UNET_TRAIN_VIEWS
    want_shapes = {"geglu_ffn": {}, "fused_spatial": {}, **DIST_TRAIN_BY_SHAPE}
    say("dist_train", f"T2VTrainer of configs/t2v_train.yaml (UNet "
        f"{sum(p.numel() for p in unet.parameters()) / 1e9:.3f} B parameters, fp32 under bf16 "
        f"autocast, block checkpointing) at batch {DIST_TRAIN_BATCH} ({rows} rows); init "
        f"{time.time() - t0:.1f}s")

    def step(mode, step_fn, capture):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        loss = step_fn(TrainState(0, unet, capture), feats, draws=draws)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        counts, shapes = ops.launch_counts(), ops.launch_counts_by_shape()
        peak = torch.cuda.max_memory_allocated() / 2**30
        say("dist_train", f"{mode}: loss {loss.item():.9f}, {dt:.3f} s (host clock, "
            f"synchronised), peak {peak:.2f} GiB, launches {counts}, attention by shape "
            f"{shapes['flash_attention']}")
        if counts != UNET_TRAIN_LAUNCHES or _without_kernel_6(shapes) != want_shapes:
            fail("dist_train", f"{mode}: expected launches {UNET_TRAIN_LAUNCHES} by shape "
                 f"{want_shapes}, got {counts} / {shapes}")
        return loss.item(), counts

    def build(mesh=None):
        return build_train_step(trainer.unet_apply, trainer.diffusion, use_ema=False,
                                p_zero=p_zero, zero_y=trainer.zero_y,
                                autocast_dtype=torch.bfloat16, mesh=mesh)

    plain_cap = _GradCapture(torch, unet)
    loss_plain, _ = step("plain step (no process group)", build(), plain_cap)
    g_plain = plain_cap.flat
    # the multirank phase's ranks take this UNet, batch and draws from a file
    os.makedirs(MULTIRANK_DIR, exist_ok=True)
    t1 = time.time()
    torch.save({"unet": {k: v.detach().cpu() for k, v in unet.state_dict().items()},
                "feats": {k: v.cpu() for k, v in feats.items()},
                "draws": [draws.t.cpu(), draws.noise.cpu(), draws.drop.cpu()],
                "zero_y": trainer.zero_y.cpu(), "loss": loss_plain, "grad_norm": plain_cap.norm,
                "grad_sample": plain_cap.sample, "p_zero": p_zero}, MULTIRANK_TRAIN)
    say("dist_train", f"wrote the UNet, batch and draws for the multirank phase "
        f"({os.path.getsize(MULTIRANK_TRAIN) / 2**30:.2f} GiB) in {time.time() - t1:.1f}s")

    rdv = os.path.join(MULTIRANK_DIR, "rendezvous_world1")
    if os.path.exists(rdv):
        os.remove(rdv)
    init_distributed(torch.device("cuda", 0), f"file://{rdv}", 0, 1)
    try:
        say("dist_train", f"process group: {dist.get_backend()} world {dist.get_world_size()}")
        mesh = make_mesh(device_type="cuda")
        cap = _GradCapture(torch, unet)
        loss_dp, counts_dp = step("replicated (data-parallel) step, world 1", build(mesh), cap)
        cos, ratio = _grad_agreement(torch, cap.flat, g_plain)
        say("dist_train", f"replicated vs plain: loss {loss_dp!r} vs {loss_plain!r} "
            f"(bit-equal {loss_dp == loss_plain}), gradient cosine {cos:.6f}, norm ratio "
            f"{ratio:.6f}")
        if loss_dp != loss_plain:
            fail("dist_train", "the replicated step's loss is not the plain step's")
        if not (cos >= TRAIN_GRAD_MIN_COS
                and TRAIN_GRAD_NORM_RATIO[0] <= ratio <= TRAIN_GRAD_NORM_RATIO[1]):
            fail("dist_train", "the replicated step's gradient disagrees with the plain one")
        cap.flat = None

        trainer.state.optimizer = None  # the one-device AdamW's moments are not the sharded ones
        gc.collect()
        torch.cuda.empty_cache()
        units = apply_fsdp(unet.fsdp_units(), mesh)
        sharded = sum(isinstance(p, DTensor) for p in unet.parameters())
        cap = _GradCapture(torch, unet)
        loss_fsdp, counts_fsdp = step(f"FSDP step ({units} units, {sharded} sharded tensors), "
                                      "world 1", build(mesh), cap)
        cos, ratio = _grad_agreement(torch, cap.flat, g_plain)
        rel = abs(loss_fsdp - loss_plain) / abs(loss_plain)
        say("dist_train", f"FSDP vs plain: loss {loss_fsdp!r} vs {loss_plain!r} (|d|/|ref| "
            f"{rel:.2e}, bound {DIST_LOSS_RTOL}), gradient cosine {cos:.6f}, norm ratio "
            f"{ratio:.6f}")
        if not (rel <= DIST_LOSS_RTOL and cos >= TRAIN_GRAD_MIN_COS
                and TRAIN_GRAD_NORM_RATIO[0] <= ratio <= TRAIN_GRAD_NORM_RATIO[1]):
            fail("dist_train", "the FSDP step disagrees with the plain one")
        del cap, g_plain
        opt = build_optimizer(unet.named_parameters(), lr=3e-5, warmup_steps=0)
        probe = next(p for p in unet.parameters() if isinstance(p, DTensor))
        before = probe.to_local().clone()
        torch.cuda.reset_peak_memory_stats()
        loss = build(mesh)(TrainState(0, unet, opt), feats, draws=draws)
        torch.cuda.synchronize()
        moved = not torch.equal(before, probe.to_local())
        say("dist_train", f"one AdamW step of the sharded state: loss {loss.item():.6f}, a sharded "
            f"parameter moved {moved}, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not (moved and math.isfinite(loss.item())):
            fail("dist_train", "the sharded AdamW step did not move the parameters")
        del opt
        gc.collect()
        torch.cuda.empty_cache()

        # one Adafactor step of the sharded state against the plain Adafactor
        # on the same parameters and gradient
        def whole(p):
            return (p.full_tensor() if isinstance(p, DTensor) else p).detach().clone()

        kw = dict(lr=1e-3, warmup_steps=0, optimizer="adafactor")
        before = [whole(p) for p in unet.parameters()]
        keep = _KeepGrads(build_optimizer(unet.named_parameters(), **kw), unet)
        torch.cuda.reset_peak_memory_stats()
        loss = build(mesh)(TrainState(0, unet, keep), feats, draws=draws)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        plain = [(n, torch.nn.Parameter(b.clone()))
                 for (n, _), b in zip(unet.named_parameters(), before)]
        for (_, q), g in zip(plain, keep.grads):
            q.grad = g
        build_optimizer(plain, **kw).step()
        # stacked, so that a non-finite entry shows
        err = torch.stack([(whole(p) - q).abs().max() / q.abs().max().clamp_min(1e-30)
                           for p, (_, q) in zip(unet.parameters(), plain)]).max().item()
        moved = torch.stack([(whole(p) - b).abs().max()
                             for p, b in zip(unet.parameters(), before)]).max().item()
        bad = [sum(not bool(torch.isfinite(t).all()) for t in ts)
               for ts in (keep.grads, [whole(p) for p in unet.parameters()])]
        zero = sum(not bool(g.any()) for g in keep.grads)
        say("dist_train", f"one Adafactor step of the sharded state: loss {loss.item():.6f}, "
            f"parameters against the plain Adafactor on the same gradient max|d|/max|ref| "
            f"{err:.3e} (bound {ADAFACTOR_PARAM_TOL:.0e}), largest move {moved:.3e}, "
            f"non-finite gradients / parameters {bad}, all-zero gradients {zero} of "
            f"{len(keep.grads)}, peak {peak:.2f} GiB")
        if not (err <= ADAFACTOR_PARAM_TOL and moved > 0):
            fail("dist_train", "the sharded Adafactor step disagrees with the plain one")
        del before, keep, plain
    finally:
        dist.destroy_process_group()
    del trainer, unet, feats
    gc.collect()
    torch.cuda.empty_cache()
    return counts_dp, counts_fsdp


class _FirstForward:
    """Keeps the output of the UNet's first forward after ``arm()``."""

    def __init__(self, unet):
        self.out = None
        self.armed = False
        self.handle = unet.register_forward_hook(self._hook)

    def arm(self):
        self.out, self.armed = None, True

    def _hook(self, module, args, out):
        if self.armed:
            self.out, self.armed = out.detach().float().clone(), False


def _rel_max(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _rel_l2(got, ref):
    return float((got - ref).norm() / ref.norm())


def phase_batched_serving(torch):
    """configs/t2v_infer.yaml as shipped, generate_batch(force_batched=True)
    of two prompts (one batched program: CFG rows [2 cond; 2 uncond]),
    plain and refined ``shared``, each row held against a single-prompt
    request fed the same noise row (the first CFG forward and the final
    latents), launches asserted by shape, the batch's wall against the two
    requests'. Returns the batched requests' launch counts."""
    from videomv_tpu_torch import ops

    pipe = _pipeline(torch)
    with open(pipe.cfg.test_list_path) as fh:
        prompts = [ln.strip() + ", 3d asset" for ln in fh if ln.strip()][:BATCH_PROMPTS]
    y = pipe.encode_text(prompts)
    zero = pipe._negative()
    noise = pipe._noise(BATCH_PROMPTS, seed=21)
    first = _FirstForward(pipe.unet)
    out_counts = {}
    try:
        for refine in (False, True):
            tag = "refined (shared)" if refine else "plain"
            want = REFINED_LAUNCHES if refine else PLAIN_LAUNCHES
            batch_shapes = BATCHED_REFINED_BY_SHAPE if refine else BATCHED_PLAIN_BY_SHAPE
            singles, walls = [], []
            for i in range(BATCH_PROMPTS):
                first.arm()
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = pipe.generate(prompts[i], steps=50, guide_scale=9.0, use_gs_refine=refine,
                                    y_words=y[i:i + 1], negative_words=zero,
                                    noise=noise[i:i + 1])
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                if ops.launch_counts() != want:
                    fail("batched_serving", f"{tag} request {i}: launches {ops.launch_counts()}")
                singles.append((first.out, torch.from_numpy(out["latents"])))
            first.arm()
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = pipe.generate_batch(prompts, steps=50, guide_scale=9.0, use_gs_refine=refine,
                                      y_words=y, negative_words=zero, noise=noise,
                                      force_batched=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, shapes = ops.launch_counts(), ops.launch_counts_by_shape()
            peak = torch.cuda.max_memory_allocated() / 2**30
            out_counts[refine] = counts
            # as many launches as one request, each over twice the rows
            if counts != want or _without_kernel_6(shapes) != dict(
                    batch_shapes, flash_attention_bwd={}, fused_spatial={}):
                fail("batched_serving", f"{tag} batch: expected {want} by shape {batch_shapes}, "
                     f"got {counts} / {shapes}")
            fr = out["frames"]
            if fr.dtype.name != "uint8" or fr.shape != (BATCH_PROMPTS, 24, 256, 256, 3):
                fail("batched_serving", f"frames {fr.dtype} {fr.shape}")
            lat = torch.from_numpy(out["latents"])
            errs = []
            for i, (fwd, lat1) in enumerate(singles):
                rows = first.out[[i, BATCH_PROMPTS + i]]  # row i's cond and uncond
                errs.append((_rel_max(rows, fwd), _rel_l2(lat[i:i + 1], lat1)))
            say("batched_serving", f"{tag}, 2 prompts, 50 steps: one batched request "
                f"{wall:.3f} s (peak {peak:.2f} GiB) against two requests {walls[0]:.3f} + "
                f"{walls[1]:.3f} = {sum(walls):.3f} s (host clock, synchronised; not a claim); "
                f"launches {counts}; per row, first CFG forward max|d|/max|ref| and final "
                f"latents relative L2 against its single request: {errs} (bounds "
                f"{UNET_TOL}, {SERVE_LATENT_RL2})")
            if not all(a <= UNET_TOL and b <= SERVE_LATENT_RL2 for a, b in errs):
                fail("batched_serving", f"{tag}: a row disagrees with its single request")
    finally:
        first.handle.remove()
    return out_counts[False], out_counts[True]


def _nccl_two_ranks(rank, n):
    """Both ranks on cuda:0 ask NCCL for a communicator; returns its error."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    group = dist.new_group(backend="nccl")
    try:
        dist.all_reduce(torch.ones(1, device="cuda:0"), group=group)
        torch.cuda.synchronize()
        return "no error: NCCL took two ranks on one device"
    except Exception as e:  # noqa: BLE001 - the probe reports the refusal
        return f"{type(e).__name__}: {e}"


def _multirank_rank(rank, n, steps, serve_path, train_path):
    """One of two ranks on cuda:0 over gloo: a frame-parallel plain T2V
    request (sp = 2) of configs/t2v_infer.yaml at ``steps`` DDIM steps, then
    one data-parallel finetune step of the dist_train UNet at global batch 2
    (a row each). Returns this rank's numbers."""
    import gc

    import torch

    sys.path.insert(0, ROOT)
    from videomv_tpu_torch import ops
    from videomv_tpu_torch.config import load_config, load_inference_config
    from videomv_tpu_torch.diffusion import GaussianDiffusion
    from videomv_tpu_torch.inference import T2VPipeline
    from videomv_tpu_torch.models import UNetSD_T2VBase
    from videomv_tpu_torch.inference.pipeline import unet_kwargs_from_cfg
    from videomv_tpu_torch.parallel import (
        TrainDraws,
        TrainState,
        build_train_step,
        make_mesh,
        make_t2v_apply,
        shard_batch,
    )

    os.chdir(ROOT)
    torch.cuda.set_device(0)
    out = {}
    served = torch.load(serve_path, map_location="cpu", mmap=True, weights_only=True)
    pipe = T2VPipeline(load_inference_config("configs/t2v_infer.yaml"), device="cuda:0")
    pipe.load_state_dicts(unet=served["unet"], vae=served["vae"])
    first = _FirstForward(pipe.unet)
    first.arm()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    r = pipe.generate("x", steps=steps, guide_scale=9.0, frame_parallel=True,
                      y_words=served["y"].cuda(), negative_words=served["zero_y"].cuda(),
                      noise=served["noise"].cuda())
    torch.cuda.synchronize()
    out["request_s"] = time.perf_counter() - t0
    out["launches"], out["counts"] = ops.launch_counts_by_shape(), ops.launch_counts()
    out["latents"] = r["latents"]
    out["first"] = first.out.cpu().numpy()
    out["frames"] = r["frames"].shape
    first.handle.remove()
    del pipe, served, first
    gc.collect()
    torch.cuda.empty_cache()

    state = torch.load(train_path, map_location="cpu", mmap=True, weights_only=True)
    cfg = load_config("configs/t2v_train.yaml")
    with torch.device("meta"):
        unet = UNetSD_T2VBase(**unet_kwargs_from_cfg(cfg.UNet))
    unet.to_empty(device="cuda:0")
    unet.load_state_dict(state["unet"])
    unet.float().train()
    for m in unet.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    d = dict(cfg.Diffusion)
    d.pop("type", None)
    d.pop("ddim_timesteps", None)
    mesh = make_mesh(device_type="cuda")
    step = build_train_step(make_t2v_apply(unet), GaussianDiffusion(**d), use_ema=False,
                            p_zero=state["p_zero"], zero_y=state["zero_y"].cuda(),
                            autocast_dtype=torch.bfloat16, mesh=mesh)
    feats = shard_batch(mesh, {k: v.cuda() for k, v in state["feats"].items()})
    draws = TrainDraws(*(x.cuda() for x in state["draws"]))
    cap = _GradCapture(torch, unet, keep=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss = step(TrainState(0, unet, cap), feats, draws=draws)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    out["step_launches"] = ops.launch_counts_by_shape()
    # numpy: a CPU tensor would travel to the parent as a shared-memory handle
    # that dies with this process
    out["loss"], out["grad_norm"], out["grad_sample"] = loss.item(), cap.norm, cap.sample.numpy()
    out["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def phase_multirank(torch):
    """Two ranks on the one card: NCCL's answer to two ranks on one device,
    then gloo with CUDA tensors: a frame-parallel plain T2V request at sp = 2
    against the same request on one rank, and one data-parallel finetune
    step at global batch 2 against dist_train's loss. Returns rank 0's
    launch counts of the request."""
    import numpy as np

    from videomv_tpu_torch.parallel import spawn

    pipe = _pipeline(torch)
    t0 = time.time()
    for f in (MULTIRANK_NCCL_RDV, MULTIRANK_GLOO_RDV):
        if os.path.exists(f):
            os.remove(f)
    try:
        answer = spawn(_nccl_two_ranks, 2, init_file=MULTIRANK_NCCL_RDV,
                       deadline_s=90)[0]
    except TimeoutError as e:  # a hang is an answer too: the ranks were killed
        answer = f"no answer: {e}"
    say("multirank", f"NCCL, two ranks on cuda:0 ({time.time() - t0:.1f}s): rank 0 "
        f"{answer[:400]!r}")
    if not os.path.exists(MULTIRANK_TRAIN):
        fail("multirank", "needs the dist_train phase's file (--phases ...,dist_train,multirank)")
    if not pipe.max_frames % 2 == 0:
        fail("multirank", f"{pipe.max_frames} frames do not split over 2 ranks")
    y = pipe.encode_text(["a wooden chair, 3d asset"])
    zero = pipe._negative()
    noise = pipe._noise(1, seed=23)
    t0 = time.time()
    torch.save({"unet": pipe.unet.state_dict(), "vae": pipe.vae.state_dict(), "y": y.cpu(),
                "zero_y": zero.cpu(), "noise": noise.cpu()}, MULTIRANK_SERVE)
    say("multirank", f"wrote the served weights for the ranks in {time.time() - t0:.1f}s")
    first = _FirstForward(pipe.unet)
    first.arm()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = pipe.generate("x", steps=MULTIRANK_STEPS, guide_scale=9.0, y_words=y,
                        negative_words=zero, noise=noise)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    ref_first = first.out.cpu()
    first.handle.remove()
    t0 = time.time()
    res = spawn(_multirank_rank, 2, init_file=MULTIRANK_GLOO_RDV,
                deadline_s=MULTIRANK_DEADLINE_S,
                args=(MULTIRANK_STEPS, MULTIRANK_SERVE, MULTIRANK_TRAIN))
    spawn_s = time.time() - t0
    lat_ref = torch.from_numpy(ref["latents"])
    f_local = pipe.max_frames // 2
    errs = []
    for r, o in enumerate(res):
        block = ref_first[:, :, r * f_local:(r + 1) * f_local]
        errs.append((_rel_max(torch.from_numpy(o["first"]), block),
                     _rel_l2(torch.from_numpy(o["latents"]), lat_ref)))
    same = np.array_equal(res[0]["latents"], res[1]["latents"])
    want = MULTIRANK_BY_SHAPE
    got = _without_kernel_6(res[0]["launches"])
    say("multirank", f"gloo, two ranks on cuda:0 (spawned and finished in {spawn_s:.1f}s): "
        f"frame-parallel plain request, sp 2, {MULTIRANK_STEPS} steps: "
        f"{[round(o['request_s'], 3) for o in res]} s per rank against {one_s:.3f} s on one "
        f"rank (not a claim); frames {res[0]['frames']}; both ranks' latents equal {same}; per "
        f"rank, the first CFG forward of its frames max|d|/max|ref| and the latents relative L2 "
        f"against one rank {errs} (bounds {UNET_TOL}, {SERVE_LATENT_RL2}); rank 0 launches by "
        f"shape {got}")
    if not same or not all(a <= UNET_TOL and b <= SERVE_LATENT_RL2 for a, b in errs):
        fail("multirank", "the frame-parallel request disagrees with one rank")
    if {k: v for k, v in got.items() if v} != {k: v for k, v in want.items() if v}:
        fail("multirank", f"expected rank 0's launches by shape {want}, got {got}")
    want = unet_train_by_shape(UNET_TRAIN_VIEWS)  # a row a rank
    say("multirank", f"data-parallel step, launches by shape per rank "
        f"{[o['step_launches'] for o in res]}")
    if any(_without_kernel_6(o["step_launches"]) != want for o in res):
        fail("multirank", f"expected each rank's step launches by shape {want}")
    plain = torch.load(MULTIRANK_TRAIN, map_location="cpu", mmap=True, weights_only=True)
    ref_loss = plain["loss"]
    rel = abs(res[0]["loss"] - ref_loss) / abs(ref_loss)
    # the gradient each rank's optimizer would take (after the all-reduce)
    # against the plain step's on the whole batch: its norm, and the cosine
    # of every GRAD_SAMPLE_STRIDE-th entry
    agree = [_grad_agreement(torch, torch.from_numpy(o["grad_sample"]).double(),
                             plain["grad_sample"].double()) for o in res]
    ratios = [o["grad_norm"] / plain["grad_norm"] for o in res]
    grads_equal = (res[0]["grad_norm"] == res[1]["grad_norm"]
                   and np.array_equal(res[0]["grad_sample"], res[1]["grad_sample"]))
    say("multirank", f"data-parallel finetune step, global batch 2 (a row a rank): loss "
        f"{res[0]['loss']:.9f} / {res[1]['loss']:.9f} against dist_train's {ref_loss:.9f} "
        f"(|d|/|ref| {rel:.2e}, bound {DIST_LOSS_RTOL}); gradient norm per rank "
        f"{[o['grad_norm'] for o in res]} against the plain step's {plain['grad_norm']:.6f} "
        f"(ratios {ratios}, bounds {TRAIN_GRAD_NORM_RATIO}); cosine of every "
        f"{GRAD_SAMPLE_STRIDE}th entry ({plain['grad_sample'].numel()}) against the plain "
        f"step's {[a[0] for a in agree]} (bound {TRAIN_GRAD_MIN_COS}); both ranks' gradients "
        f"equal {grads_equal}; step {[round(o['step_s'], 3) for o in res]} s, peak "
        f"{[round(o['step_peak_gib'], 2) for o in res]} GiB per rank; the collectives ran on CUDA "
        f"tensors over gloo, none staged through host memory by the port")
    if res[0]["loss"] != res[1]["loss"] or rel > DIST_LOSS_RTOL:
        fail("multirank", "the data-parallel step's loss disagrees with dist_train's")
    if not (grads_equal and all(a[0] >= TRAIN_GRAD_MIN_COS for a in agree)
            and all(TRAIN_GRAD_NORM_RATIO[0] <= x <= TRAIN_GRAD_NORM_RATIO[1] for x in ratios)):
        fail("multirank", "the data-parallel step's all-reduced gradient disagrees with the "
             "plain step's")
    del plain
    for f in (MULTIRANK_SERVE, MULTIRANK_TRAIN):
        os.remove(f)
    return res[0]["counts"]



# ------------------------------------------------------------------ variants
# Slice F: the dormant temporal variants of the T2V UNet, the samplers no
# served path calls, the `dots` remat policies and Adafactor over FSDP.


def _plan_launches(kw, rows, hw, forwards=1):
    """Kernels 1 and 2's launches by shape in ``forwards`` forwards of the
    UNet of ``kw`` (``unet_kwargs_from_cfg``) over ``rows`` rows of hw x hw
    latents, derived from its block plan and the two kernels' gates: each
    spatial transformer's self-attention and FFN, and the FFN of each
    temporal transformer (``transformer`` or ``attemask``; the rotary blocks
    have none)."""
    import torch

    from videomv_tpu_torch.models.unet_t2v import build_unet_plan
    from videomv_tpu_torch.ops import attention_eligible, ffn_eligible

    bf, hd = torch.bfloat16, kw["head_dim"]
    out = {"flash_attention": {}, "geglu_ffn": {}}

    def add(name, shape):
        out[name][shape] = out[name].get(shape, 0) + forwards

    def visit(kind, name, cout, side):
        s = side * side
        if kind == "spatial":
            q = (rows, s, cout // hd, hd)
            if attention_eligible(q, q, bf, True):
                add("flash_attention", q)
            inner = cout
        elif kind == "temporal" and kw["temporal_block"] != "rotary":
            inner = (kw["num_heads"] if name == "input_blocks_0_1" else cout // hd) * hd
        else:
            return
        if ffn_eligible(rows * s, inner, 4 * inner, bf, True):
            add("geglu_ffn", (rows * s, inner, 4 * inner))

    enc, dec = build_unet_plan(kw["dim"], kw["dim_mult"], kw["num_res_blocks"],
                               kw["attn_scales"], kw["temporal_attention"])
    side = hw
    for entry in enc:
        for kind, name, _, cout in entry:
            visit(kind, name, cout, side)
            if kind == "down":
                side //= 2
    mid = kw["dim"] * kw["dim_mult"][-1]
    visit("spatial", "middle_block_1", mid, side)
    if kw["temporal_attention"]:
        visit("temporal", "middle_block_2", mid, side)
    for entry in dec:
        for kind, name, _, cout in entry:
            visit(kind, name, cout, side)
            if kind == "up":
                side *= 2
    return out


def _checked_shapes():
    """Kernels 1 (forward and backward) and 2's shapes the kernels phase
    holds against their twins."""
    return {"flash_attention": {*ATTN_SHAPES, *BATCHED_REFINED_BY_SHAPE["flash_attention"],
                                *(s for rows in UNET_TRAIN_CHECK_ROWS
                                  for s in unet_train_attn_shapes(rows))},
            "flash_attention_bwd": set(ATTN_BWD_SHAPES),
            "geglu_ffn": {*FFN_SHAPES, *BATCHED_REFINED_BY_SHAPE["geglu_ffn"]}}


def _launched(torch, phase, what, want=None):
    """The launch counts since the last reset by shape: every shape one the
    kernels phase checks, and (with ``want``) the counts expected."""
    from videomv_tpu_torch import ops

    counts, shapes = ops.launch_counts(), ops.launch_counts_by_shape()
    checked = _checked_shapes()
    for name in ("flash_attention", "flash_attention_bwd", "geglu_ffn"):
        new = set(shapes[name]) - checked[name]
        if new:
            fail(phase, f"{what}: {name} launched at shapes the kernels phase does not check: "
                 f"{sorted(new)}")
    if counts["fused_spatial"] or counts["splat_composite"] or counts["splat_composite_bwd"]:
        fail(phase, f"{what}: unexpected launches {counts}")
    if want is not None and {k: shapes[k] for k in want} != want:
        fail(phase, f"{what}: expected launches by shape {want}, got {shapes}")
    return counts, {k: dict(v) for k, v in shapes.items()}


def _variant_host_unet(torch, opts):
    """The full-width UNet of configs/t2v_infer.yaml with ``opts``, fp32 on
    the host: every tensor it shares (name and shape) with the cached T2V
    draw (``_host_unet``) is that draw's; the rest (the rotary blocks, the
    relative position bias) is drawn from VARIANT_SEED as init_weights draws
    (zero_init False). Returns the UNet, its kwargs and how many tensors
    were drawn."""
    import numpy as np

    from videomv_tpu_torch.config import load_inference_config
    from videomv_tpu_torch.inference.pipeline import unet_kwargs_from_cfg
    from videomv_tpu_torch.models import UNetSD_T2VBase

    cfg = load_inference_config(os.path.join(ROOT, "configs", "t2v_infer.yaml"), opts=opts)
    kw = unet_kwargs_from_cfg(cfg.UNet)
    with torch.device("meta"):
        unet = UNetSD_T2VBase(**kw)
    unet.to_empty(device="cpu")
    shared = dict(_host_unet(torch).named_parameters())
    rng, drawn = np.random.default_rng(VARIANT_SEED), 0
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if name in shared and shared[name].shape == p.shape:
                p.copy_(shared[name])
                continue
            n = rng.standard_normal(tuple(p.shape), dtype=np.float32)
            if n.ndim >= 2:
                n *= np.float32(math.prod(n.shape[1:]) ** -0.5)
            elif name.endswith("weight"):
                n = np.float32(1.0) + np.float32(0.1) * n
            else:
                n *= np.float32(0.1)
            p.copy_(torch.from_numpy(n))
            drawn += 1
    return unet.eval().requires_grad_(False), kw, drawn, cfg


def _cfg_model(torch, unet, y, zero_y, cam, rows=None):
    """The served CFG denoiser over ``unet``: [cond; uncond] rows in one
    forward (``rows`` None), or the cond rows alone (``rows='cond'``)."""
    if rows == "cond":
        return lambda xt, t: unet(xt, t, y=y, camera_data=cam)

    def model(xt, t):
        out = unet(torch.cat([xt, xt]), torch.cat([t, t]), y=torch.cat([y, zero_y]),
                   camera_data=torch.cat([cam, cam]))
        return out[:1], out[1:]
    return model


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _first_prediction(torch, model_bf16, model_fp32, x, t, guide):
    """One sampler's first forward, bf16 with the kernels against fp32
    plain, both on the card: max|d|/max|ref| of the UNet's output (its CFG
    rows), held to UNET_REL_TOL as every forward is (PERF.md §2), and of the
    guided prediction, which amplifies the rows' difference by the guidance
    (printed)."""
    with torch.no_grad():
        outs = [model(x, t) for model in (model_bf16, model_fp32)]
    if guide is None:
        rel = _rel(outs[0], outs[1])
        return rel, rel
    rows = _rel(torch.cat(outs[0]), torch.cat(outs[1]))
    mixed = [o[1] + guide * (o[0] - o[1]) for o in outs]
    return rows, _rel(mixed[0], mixed[1])


def _remat_policies(torch):
    """configs/t2v_train.yaml's UNet finetune step at batch 2 under each
    remat policy on one batch, one set of draws and one dropout stream: the
    step by parts (CUDA events; the second of two runs), its peak memory,
    kernel 1's launches by shape, the loss (bit-equal to full's) and the
    gradient (cosine to full's)."""
    import gc

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.config import load_config
    from videomv_tpu_torch.data.datasets import SyntheticMVDataset, batch_iterator
    from videomv_tpu_torch.parallel import draw_train_randoms
    from videomv_tpu_torch.parallel.train_step import _dropout_stream
    from videomv_tpu_torch.training.engine import T2VTrainer

    os.chdir(ROOT)
    cfg = load_config("configs/t2v_train.yaml", opts=UNET_TRAIN_OPTS)
    trainer = T2VTrainer(cfg, device="cuda").init(zero_init=False)
    unet, dev = trainer.unet, trainer.device
    if not unet.use_checkpoint:
        fail("variants", "configs/t2v_train.yaml no longer sets use_checkpoint")
    host = next(batch_iterator(SyntheticMVDataset(resolution=tuple(trainer.resolution),
                                                  max_frames=trainer.max_frames),
                               UNET_TRAIN_BATCH))
    with torch.no_grad():
        feats = trainer.encode_batch(host)
    draws = draw_train_randoms(torch.Generator(device=dev).manual_seed(5), feats["latents"],
                               trainer.diffusion, float(cfg.get("p_zero", 0.1)))
    want = unet_train_by_shape(UNET_TRAIN_BATCH * UNET_TRAIN_VIEWS)
    ref_loss = ref_grad = None
    out = {}
    for policy in REMAT_POLICIES:
        unet.remat_policy = policy
        for _ in range(2):
            for p in unet.parameters():
                p.grad = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            timers = _EventTimers(torch)
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            with _dropout_stream(torch.Generator(device=dev).manual_seed(7)):
                with timers("forward"):
                    loss = trainer.train_step.loss_fn(feats, draws)
                with timers("backward (recompute + gradients)"):
                    loss.backward()
            ms = timers.ms()
            wall = (time.perf_counter() - t1) * 1e3
            peak = torch.cuda.max_memory_allocated()
        counts, shapes = _launched(torch, "variants", f"remat {policy} step", want)
        grad = _flat_grad(torch, unet)
        if ref_grad is None:
            ref_loss, ref_grad, cos = loss.item(), grad, 1.0
        else:
            cos = _grad_agreement(torch, grad, ref_grad)[0]
        say("variants", f"remat_policy {policy}: loss {loss.item()!r} (full's {ref_loss!r}, "
            f"bit-equal {loss.item() == ref_loss}), gradient cosine to full's {cos:.8f} "
            f"(bound {REMAT_MIN_COS}); peak {peak / 2**30:.2f} GiB, {(peak - base) / 2**30:.2f} "
            f"GiB above the resident state; CUDA events " + "; ".join(
                f"{k} {v:.2f} ms" for k, v in ms.items())
            + f"; host wall {wall:.2f} ms; launches {counts}, attention by shape "
            f"{shapes['flash_attention']}, its backward's {shapes['flash_attention_bwd']}")
        if loss.item() != ref_loss or not cos >= REMAT_MIN_COS:
            fail("variants", f"remat_policy {policy} changed the step's loss or gradient")
        out[f"remat {policy} step"] = (counts, shapes)
        del grad, loss
    unet.remat_policy = "full"
    del trainer, unet, feats, ref_grad
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _samplers(torch, host_fp32):
    """PLMS, DDIM inversion (and DDIM back) and DDPM over the served T2V
    UNet (configs/t2v_infer.yaml, bf16 with the kernels) at 24 views: each
    one's latency, launches by shape (derived from the block plan), finite
    latents and its first step's prediction bf16 vs fp32 on the card."""
    from videomv_tpu_torch import ops
    from videomv_tpu_torch.diffusion import (
        GaussianDiffusion,
        ddim_reverse_sample_loop,
        ddim_sample_loop,
        ddim_timestep_seq,
        ddpm_sample_loop,
        plms_sample_loop,
    )
    from videomv_tpu_torch.inference.pipeline import unet_kwargs_from_cfg

    pipe = _pipeline(torch)
    kw = unet_kwargs_from_cfg(pipe.cfg.UNet)
    f, (h, w) = pipe.max_frames, pipe.latent_hw
    with open(pipe.cfg.test_list_path) as fh:
        prompt = next(ln.strip() for ln in fh if ln.strip())
    y, zero_y = pipe.encode_text([prompt]), pipe._negative()
    cam = pipe._get_cameras(15.0, 2.0)[0]
    guided = _cfg_model(torch, pipe.unet, y, zero_y, cam)
    guided32 = _cfg_model(torch, host_fp32, y, zero_y, cam)
    cond = _cfg_model(torch, pipe.unet, y, zero_y, cam, rows="cond")
    cond32 = _cfg_model(torch, host_fp32, y, zero_y, cam, rows="cond")
    d = pipe.diffusion
    T = d.num_timesteps
    noise = pipe._noise(1, seed=31)
    paths = {}

    def run(name, fn, forwards, rows, first_step):
        want = _plan_launches(kw, rows, h, forwards)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        lat = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        counts, shapes = _launched(torch, "variants", name, want)
        finite = bool(torch.isfinite(lat).all())
        first, guided_first = first_step
        say("variants", f"{name}: {dt:.3f} s ({forwards} forwards of {rows} rows, "
            f"{1e3 * dt / forwards:.2f} ms a forward), peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, latents finite {finite}, first "
            f"forward bf16 vs fp32 max|d|/max|ref| {first:.3e} (bound {UNET_REL_TOL:.0e}; the "
            f"guided prediction {guided_first:.3e}); launches {counts}, by shape {shapes}")
        if not finite or not first <= UNET_REL_TOL:
            fail("variants", f"{name}: non-finite latents or its first step off fp32")
        paths[name] = (counts, shapes)
        return lat, dt

    steps = SAMPLER_STEPS
    t0 = torch.full((1,), int(ddim_timestep_seq(T, steps)[0]), device=noise.device)
    with torch.no_grad():
        first = _first_prediction(torch, guided, guided32, noise, t0, 9.0)
        run(f"PLMS, {steps} steps, CFG 9.0", lambda: plms_sample_loop(
            d, guided, noise, plms_timesteps=steps, guide_scale=9.0), steps + 1, 2 * f, first)

        x0 = pipe.generate(prompt, steps=50, guide_scale=9.0, seed=11)["latents"]
        x0 = torch.from_numpy(x0).to(noise.device)
        zero_t = torch.zeros(1, dtype=torch.long, device=noise.device)
        first = _first_prediction(torch, cond, cond32, x0, zero_t, None)
        xt, _ = run(f"DDIM inversion, {steps} steps, cond rows (a plain request's latents)",
                    lambda: ddim_reverse_sample_loop(d, cond, x0, ddim_timesteps=steps),
                    steps, f, first)
        first = _first_prediction(torch, cond, cond32, xt, t0, None)
        back, _ = run(f"DDIM back, {steps} steps, cond rows", lambda: ddim_sample_loop(
            d, cond, xt, ddim_timesteps=steps), steps, f, first)
        rl2 = ((back - x0).norm() / x0.norm()).item()
        say("variants", f"DDIM inversion round trip: |x0' - x0| / |x0| {rl2:.4e} (reported; "
            f"DDIM's 20-step map is not exactly invertible)")

        dcfg = dict(pipe.cfg.Diffusion)
        dcfg.pop("type", None)
        dcfg["schedule_param"] = dict(dcfg.get("schedule_param", {}), num_timesteps=DDPM_STEPS)
        d50 = GaussianDiffusion(**dcfg)
        first = _first_prediction(torch, guided, guided32, noise,
                                  torch.full((1,), DDPM_STEPS - 1, device=noise.device), 9.0)
        gen = torch.Generator(device=noise.device).manual_seed(3)
        _, dt = run(f"DDPM over {dcfg['schedule']}, num_timesteps cut to {DDPM_STEPS} (shipped "
                    f"{T}), CFG 9.0", lambda: ddpm_sample_loop(
                        d50, guided, noise, guide_scale=9.0, generator=gen),
                    DDPM_STEPS, 2 * f, first)
        say("variants", f"DDPM: {1e3 * dt / DDPM_STEPS:.2f} ms a step; at the shipped {T} steps "
            f"{dt / DDPM_STEPS * T:.1f} s a request (estimated from the cut run)")
    return paths


def _variant_unets(torch):
    """The rotary and attemask UNets at full width: a 48-row forward bf16
    with the kernels against the fp32 plain path on the card (the rotary one
    also with a video_mask that drops two views and a focus_present_mask
    row), then one 50-step CFG request through T2VPipeline built from the
    merged config, with launches by shape derived from the block plan."""
    import gc

    import numpy as np

    from videomv_tpu_torch import ops
    from videomv_tpu_torch.data.cameras import orbit_camera_for_t2v
    from videomv_tpu_torch.inference import T2VPipeline

    base = _pipeline(torch)
    paths = {}
    for block, opts in VARIANT_OPTS.items():
        t1 = time.time()
        host, kw, drawn, cfg = _variant_host_unet(torch, opts)
        vpipe = T2VPipeline(cfg, device="cuda")
        vpipe.vae, vpipe.clip, vpipe.lgm = base.vae, base.clip, None
        vpipe.load_state_dicts(unet=host.state_dict())
        card32 = host.to("cuda")
        say("variants", f"{block} UNet (temporal_block {kw['temporal_block']}, "
            f"temporal_attn_times {kw['temporal_attn_times']}, use_sim_mask "
            f"{kw['use_sim_mask']}): {sum(p.numel() for p in card32.parameters()) / 1e9:.4f} B "
            f"parameters, {drawn} tensors drawn (the rest the T2V draw's), built in "
            f"{time.time() - t1:.1f}s")
        f = vpipe.max_frames
        rs = np.random.default_rng(1)
        x = torch.from_numpy(rs.standard_normal((1, 4, f, 32, 32)).astype(np.float32)).cuda()
        y = torch.from_numpy(rs.standard_normal((2, 77, 1024)).astype(np.float32)).cuda()
        cam = torch.from_numpy(np.asarray(orbit_camera_for_t2v(f))).cuda()
        args = (torch.cat([x, x]), torch.tensor([981, 981], device="cuda"))
        vm = torch.ones(2, f, dtype=torch.bool, device="cuda")
        vm[:, 5], vm[:, 17] = False, False
        fpm = torch.tensor([True, False], device="cuda")
        cases = {"no mask": {}}
        if block == "rotary":
            cases.update({"video_mask (views 5 and 17 dropped)": dict(video_mask=vm),
                          "focus_present_mask (row 0)": dict(focus_present_mask=fpm)})
        want = _plan_launches(kw, 2 * f, 32)
        for what, masks in cases.items():
            with torch.no_grad():
                ops.reset_launch_counts()
                got = vpipe.unet(*args, y=y, camera_data=torch.cat([cam, cam]), **masks)
                torch.cuda.synchronize()
                _launched(torch, "variants", f"{block} forward", want)
                ref = card32(*args, y=y, camera_data=torch.cat([cam, cam]), **masks)
            rel = _rel(got, ref)
            say("variants", f"{block} forward, 48 rows, {what}: bf16 with the kernels vs fp32 "
                f"plain on the card max|d|/max|ref| {rel:.3e} (bound {UNET_REL_TOL:.0e}), "
                f"max|ref| {ref.abs().max().item():.3e}, finite {bool(torch.isfinite(got).all())}")
            if not (torch.isfinite(got).all() and rel <= UNET_REL_TOL):
                fail("variants", f"{block} forward ({what}) off its fp32 reference")
        del card32, host
        gc.collect()
        torch.cuda.empty_cache()
        with open(base.cfg.test_list_path) as fh:
            prompt = next(ln.strip() for ln in fh if ln.strip())
        want = _plan_launches(kw, 2 * f, 32, forwards=50)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        out = vpipe.generate(prompt, steps=50, guide_scale=9.0, seed=11)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        counts, shapes = _launched(torch, "variants", f"{block} request", want)
        fr = out["frames"]
        say("variants", f"{block} request (50 steps, CFG 9.0, 24 views): {dt:.3f} s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, frames {fr.dtype} "
            f"{list(fr.shape)}, launches {counts}, by shape {shapes} (the block plan's)")
        if fr.shape != (24, 256, 256, 3) or not np.isfinite(out["latents"]).all():
            fail("variants", f"{block} request: frames {fr.shape} or non-finite latents")
        paths[f"{block} request"] = (counts, shapes)
        del vpipe
        gc.collect()
        torch.cuda.empty_cache()
    return paths


def phase_variants(torch):
    """Slice F at full width: the remat policies on the T2V finetune step,
    the samplers over the served T2V UNet, the rotary and attemask UNets.
    Records each path's launches by shape in VARIANT_CALLS and returns the
    launch counts by path."""
    import copy
    import gc

    t0 = time.time()
    # the plan's launches of a T2V CFG forward are what the slice counts
    from videomv_tpu_torch.config import load_inference_config
    from videomv_tpu_torch.inference.pipeline import unet_kwargs_from_cfg

    kw = unet_kwargs_from_cfg(load_inference_config(
        os.path.join(ROOT, "configs", "t2v_infer.yaml")).UNet)
    served = {k: {s: c // 50 for s, c in v.items()} for k, v in PLAIN_BY_SHAPE.items()}
    if _plan_launches(kw, 48, 32) != served:
        fail("variants", f"the block plan's launches {_plan_launches(kw, 48, 32)} are not a "
             f"served forward's {served}")
    paths = _remat_policies(torch)
    host32 = copy.deepcopy(_host_unet(torch)).to("cuda")
    paths.update(_samplers(torch, host32))
    del host32
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(_variant_unets(torch))
    VARIANT_CALLS.update({path: shapes for path, (_, shapes) in paths.items()})
    say("variants", f"phase {time.time() - t0:.1f}s")
    return {path: counts for path, (counts, _) in paths.items()}


if __name__ == "__main__":
    main()
