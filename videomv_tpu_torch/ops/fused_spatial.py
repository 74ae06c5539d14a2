"""Fused spatial-transformer block: the CUDA kernel ``csrc/fused_spatial.cu``
and its plain PyTorch twin.

Port of ``videomv_tpu/ops/fused_spatial.py``. ``fused_spatial_transformer(x,
ctx, params, n_heads)`` runs one whole depth-1 ``SpatialTransformer``
(GroupNorm 32 → proj_in → LN → self-attention → LN → cross-attention over
``ctx`` → LN → GEGLU feed-forward → proj_out → + x) on ``x [R, S, C]`` (the JAX
package's layout: rows of H·W tokens) and ``ctx [R, L, Cc]``. ``params`` is
the block's tensors by the names of ``PARAM_NAMES`` in ``nn.Linear`` layout
(``spatial_params(module)`` reads them off a ``SpatialTransformer``). On a
CUDA tensor it launches the hand-written kernel (bf16 x, ctx and weights,
fp32 norm scales and biases) or raises; on a CPU tensor it runs
``spatial_block_reference``, the fp32 twin.

The kernel is opt-in, as in the JAX package: ``spatial_fused_eligible`` is
false unless ``VIDEOMV_ENABLE_FUSED_SPATIAL`` is set (``enabled()``, the one
reader of the switch), and then holds for the UNets' 32² stage only: the JAX
package's rule (``C == heads·64 <= 384``, ``S % 512 == 0``) where the wgmma
kernel takes the shape (C = 320, 5 heads, context width 1024), bf16 on a
CUDA device. Every other shape takes the module path. The JAX package's
VMEM-sizing switches (rows per grid cell, bf16 residuals) have no
counterpart: the kernel keeps fp32 residuals. ``spatial_plan`` and
``spatial_tensor_maps`` describe the kernel's tiling and TMA maps as
``csrc/fused_spatial.cu`` lays them out.

The counter ``launch.fused_spatial`` of ``utils.profiling`` counts wrapper
calls that launched the kernel (one call runs its four ``__global__`` phases
on one stream and counts once), by ``(R, S, C, L)`` too.

Under grad it is a ``torch.autograd.Function`` like the JAX package's
``custom_vjp``: the forward is the kernel, the backward differentiates
``spatial_block_reference`` on the saved inputs.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import _build

__all__ = [
    "PARAM_NAMES",
    "enabled",
    "fused_spatial_transformer",
    "kernel_params",
    "spatial_block_reference",
    "spatial_fused_eligible",
    "spatial_params",
    "spatial_plan",
    "spatial_tensor_maps",
]

D_HEAD = 64
GROUPS = 32
ENV_FLAG = "VIDEOMV_ENABLE_FUSED_SPATIAL"

# the block's tensors in the kernel's argument order: matrices in nn.Linear
# layout [out, in]; ``w1`` is the GEGLU projection [2·inner_ff, C] (lin rows
# first, gate rows second)
PARAM_NAMES = (
    "gn_s", "gn_b", "win", "bin",
    "ln1_s", "ln1_b", "wq1", "wk1", "wv1", "wo1", "bo1",
    "ln2_s", "ln2_b", "wq2", "wk2", "wv2", "wo2", "bo2",
    "ln3_s", "ln3_b", "w1", "b1", "w2", "b2",
    "wpo", "bpo",
)
_MATRICES = frozenset(n for n in PARAM_NAMES if n.startswith("w"))
_VECTORS = tuple(n for n in PARAM_NAMES if n not in _MATRICES)

# the width and context width csrc/fused_spatial.cu is built for
WGMMA_C, WGMMA_CC = 320, 1024
MAX_DYNAMIC_SMEM = 232448  # bytes one block may ask for on sm_90


def spatial_plan(c: int = WGMMA_C, cc: int = WGMMA_CC) -> dict:
    """The wgmma kernel's tiling, as csrc/fused_spatial.cu lays it out (sizes
    in bytes). A block owns 64 tokens and is two consumer warpgroups (256
    threads, no producer: the last warp done with a stage refills it); each
    warpgroup computes 160 of the 320 output columns of every product as two
    m64n80 wgmmas. Phase C's shared memory: the fp32 residual [64, C + 8], the
    bf16 A operand [64, C] as swizzled [64 x 64] tiles (GroupNorm / LN
    outputs, Q, the head outputs, r3), a ring of weight stages (two [80 x 64]
    boxes each), two GEGLU g tiles, the barriers; an attention's K/V stages
    (K and V of 128 keys) alias the ring and the g tiles. Phase B has no g
    tiles; phase A holds a context tile [64, cc] and the ring."""
    if c != WGMMA_C or cc != WGMMA_CC:
        raise ValueError(f"the wgmma kernel is built for C = {WGMMA_C}, Cc = {WGMMA_CC}; got "
                         f"C = {c}, Cc = {cc}")
    rows, tile = 64, 64 * 128
    residual = rows * (c + 8) * 4
    operand = (c // 64) * tile
    stage, stages = 2 * 80 * 128, 4
    ring = stage * stages
    g_tiles = 2 * tile
    kv_stage, kv_stages = 2 * 128 * 128, 3
    barriers = 256
    front = 1024 + residual + operand + ring + barriers
    return dict(rows=rows, threads=256, warpgroups=2, wgmma_n=80, columns_per_warpgroup=160,
                residual_bytes=residual, operand_bytes=operand, stage_bytes=stage,
                stages=stages, g_bytes=g_tiles, keys=128, kv_stage_bytes=kv_stage,
                kv_stages=kv_stages, barrier_bytes=barriers, ffn_chunk=64, ffn_lin_cols=32,
                block_smem_bytes=front + g_tiles, front_smem_bytes=front,
                ctx_smem_bytes=1024 + (cc // 64) * tile + ring + barriers,
                # registers a thread holds live at most: the product's two
                # accumulators (80) + the FFN's lin / gate (32); in an
                # attention the logits (64), O (32) and P (32)
                accumulator_registers=max(80 + 32, 64 + 32 + 32), register_cap=255)


def spatial_tensor_maps(r: int, s: int, c: int, kv_len: int, cc: int, inner_ff: int) -> dict:
    """The TMA tensor maps of one wgmma launch, innermost dimension first
    (elements; strides in bytes of the outer dimensions; the box is one
    load): the weights in nn.Linear layout [out, in] (K-major B operands as
    they lie), the context [R·L, Cc], and K/V of both attentions read in place
    as [R, tokens, heads, 64] (K1/V1 [R, S, C], K2/V2 [R·L, C])."""
    heads = c // D_HEAD
    box80, box_lg = (64, 80), (64, 32)
    maps = {n: dict(dims=(c, c), strides_bytes=(2 * c,), box=box80)
            for n in ("win", "wq1", "wk1", "wv1", "wo1", "wq2", "wo2", "wpo")}
    for n in ("wk2", "wv2"):
        maps[n] = dict(dims=(cc, c), strides_bytes=(2 * cc,), box=box80)
    maps["w1"] = dict(dims=(c, 2 * inner_ff), strides_bytes=(2 * c,), box=box_lg)
    maps["w2"] = dict(dims=(inner_ff, c), strides_bytes=(2 * inner_ff,), box=box80)
    maps["ctx"] = dict(dims=(cc, r * kv_len), strides_bytes=(2 * cc,), box=(64, 64))
    for n, tokens in (("k1", s), ("v1", s), ("k2", kv_len), ("v2", kv_len)):
        maps[n] = dict(dims=(D_HEAD, heads, tokens, r),
                       strides_bytes=(2 * D_HEAD, 2 * c, 2 * tokens * c), box=(64, 1, 128, 1))
    return maps


def spatial_params(module, vector_dtype: Optional[torch.dtype] = None
                   ) -> Dict[str, torch.Tensor]:
    """The tensors of a depth-1 ``SpatialTransformer`` module by the names of
    ``PARAM_NAMES``. ``vector_dtype`` casts the norm scales and the biases
    (the kernel takes them in fp32 beside bf16 matrices)."""
    tb = module.transformer_blocks[0]
    p = {
        "gn_s": module.norm.weight, "gn_b": module.norm.bias,
        "win": module.proj_in.weight, "bin": module.proj_in.bias,
        "w1": tb.ff.net[0].proj.weight, "b1": tb.ff.net[0].proj.bias,
        "w2": tb.ff.net[2].weight, "b2": tb.ff.net[2].bias,
        "wpo": module.proj_out.weight, "bpo": module.proj_out.bias,
    }
    for i, (norm, attn) in enumerate(((tb.norm1, tb.attn1), (tb.norm2, tb.attn2),
                                      (tb.norm3, None)), start=1):
        p[f"ln{i}_s"], p[f"ln{i}_b"] = norm.weight, norm.bias
        if attn is not None:
            p[f"wq{i}"], p[f"wk{i}"], p[f"wv{i}"] = (attn.to_q.weight, attn.to_k.weight,
                                                      attn.to_v.weight)
            p[f"wo{i}"], p[f"bo{i}"] = attn.to_out[0].weight, attn.to_out[0].bias
    if vector_dtype is not None:
        p = {k: (v if k in _MATRICES else v.to(vector_dtype)) for k, v in p.items()}
    return p


def kernel_params(module) -> Dict[str, torch.Tensor]:
    """``spatial_params(module, torch.float32)`` without a cast per call: the
    fp32 copies of the norm scales and biases are kept on the module and made
    again only when a parameter's storage or version changes
    (``load_state_dict``, an optimizer step, ``.to()``); the matrices are the
    module's own tensors."""
    p = spatial_params(module)
    key = tuple((p[n].data_ptr(), p[n]._version, p[n].dtype, p[n].device) for n in _VECTORS)
    kept = module.__dict__.get("_fused_spatial_vectors")
    if kept is None or kept[0] != key:
        kept = (key, {n: p[n].detach().to(torch.float32) for n in _VECTORS})
        module.__dict__["_fused_spatial_vectors"] = kept
    p.update(kept[1])
    return p


def spatial_block_reference(x: torch.Tensor, ctx: torch.Tensor, params: Dict[str, torch.Tensor],
                            n_heads: int) -> torch.Tensor:
    """Plain twin: the fp32 mirror of the module composition (the JAX
    ``spatial_block_reference``): GroupNorm(32, eps 1e-6) over tokens × C/32
    channels, LayerNorm eps 1e-5, head_dim 64, exact-erf GEGLU, all in fp32
    whatever the inputs' dtype, ``x + y`` cast to ``x.dtype``."""
    p = {k: v.float() for k, v in params.items()}
    r, s, c = x.shape
    xf = x.float()

    def ln(v, i):
        return F.layer_norm(v, (v.shape[-1],), p[f"ln{i}_s"], p[f"ln{i}_b"], eps=1e-5)

    def attn(q_in, kv_in, i):
        q = (q_in @ p[f"wq{i}"].t()).reshape(r, -1, n_heads, D_HEAD).transpose(1, 2)
        k = (kv_in @ p[f"wk{i}"].t()).reshape(r, -1, n_heads, D_HEAD).transpose(1, 2)
        v = (kv_in @ p[f"wv{i}"].t()).reshape(r, -1, n_heads, D_HEAD).transpose(1, 2)
        probs = torch.softmax((q @ k.transpose(-1, -2)) * D_HEAD ** -0.5, dim=-1)
        o = (probs @ v).transpose(1, 2).reshape(r, -1, n_heads * D_HEAD)
        return o @ p[f"wo{i}"].t() + p[f"bo{i}"]

    g = xf.reshape(r, s, GROUPS, c // GROUPS)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), keepdim=True, unbiased=False)
    h = ((g - mean) * torch.rsqrt(var + 1e-6)).reshape(r, s, c) * p["gn_s"] + p["gn_b"]
    r0 = h @ p["win"].t() + p["bin"]
    t1 = ln(r0, 1)
    r1 = r0 + attn(t1, t1, 1)
    r2 = r1 + attn(ln(r1, 2), ctx.float(), 2)
    lin, gate = (ln(r2, 3) @ p["w1"].t() + p["b1"]).chunk(2, dim=-1)
    r3 = r2 + ((lin * F.gelu(gate)) @ p["w2"].t() + p["b2"])
    y = r3 @ p["wpo"].t() + p["bpo"]
    return (xf + y).to(x.dtype)


def enabled() -> bool:
    """Whether ``VIDEOMV_ENABLE_FUSED_SPATIAL`` is set."""
    return bool(os.environ.get(ENV_FLAG))


def spatial_fused_eligible(s: int, c: int, inner: int, n_heads: int, cc: int,
                           dtype: torch.dtype, is_cuda: bool) -> bool:
    """The kernel gate of the JAX package (opt-in through
    ``VIDEOMV_ENABLE_FUSED_SPATIAL``; ``inner == C == heads·64 <= 384``,
    ``C % 32 == 0``, ``S % 512 == 0``) with its TPU-backend test replaced by
    ``is_cuda`` and bf16, and held to the shape the kernel takes: C = 320 and
    a context ``cc`` = 1024 wide."""
    if not enabled() or not is_cuda or dtype != torch.bfloat16:
        return False
    jax_rule = (inner == c and c == n_heads * D_HEAD and c <= 384 and c % 32 == 0
                and s % 512 == 0)
    return jax_rule and c == WGMMA_C and cc == WGMMA_CC


def _check_cuda_inputs(x, ctx, params, n_heads) -> None:
    what = "fused_spatial_transformer"
    dev = x.device
    tensors = [("x", x, torch.bfloat16), ("ctx", ctx, torch.bfloat16)] + [
        (n, params[n], torch.bfloat16 if n in _MATRICES else torch.float32) for n in PARAM_NAMES]
    for name, t, dt in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: {name} must be on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if x.dim() != 3 or ctx.dim() != 3 or ctx.shape[0] != x.shape[0]:
        raise ValueError(f"{what}: x must be [R, S, C] and ctx [R, L, Cc], got "
                         f"{tuple(x.shape)} and {tuple(ctx.shape)}")
    r, s, c = x.shape
    cc = ctx.shape[2]
    if (c != WGMMA_C or n_heads != WGMMA_C // D_HEAD or cc != WGMMA_CC or s % 64 != 0
            or ctx.shape[1] < 1):
        raise ValueError(f"{what}: the kernel takes C = {WGMMA_C} with {WGMMA_C // D_HEAD} "
                         f"heads, Cc = {WGMMA_CC} and S % 64 == 0; got C={c}, heads={n_heads}, "
                         f"Cc={cc}, S={s}")
    iff = params["w2"].shape[1] if params["w2"].dim() == 2 else -1
    if iff < 64 or iff % 64 != 0:
        raise ValueError(f"{what}: the feed-forward's inner width must be a multiple of 64, "
                         f"got {iff}")
    shapes = {"gn_s": (c,), "gn_b": (c,), "win": (c, c), "bin": (c,), "wpo": (c, c),
              "bpo": (c,), "w1": (2 * iff, c), "b1": (2 * iff,), "w2": (c, iff), "b2": (c,),
              "wk2": (c, cc), "wv2": (c, cc)}
    for i in (1, 2, 3):
        shapes[f"ln{i}_s"] = shapes[f"ln{i}_b"] = (c,)
    for n in ("wq1", "wk1", "wv1", "wo1", "wq2", "wo2"):
        shapes[n] = (c, c)
    shapes["bo1"] = shapes["bo2"] = (c,)
    bad = {n: tuple(params[n].shape) for n, want in shapes.items()
           if tuple(params[n].shape) != want}
    if bad:
        raise ValueError(f"{what}: parameter shapes do not fit C={c}, Cc={cc}, inner={iff}: {bad}")


def _check_names(params) -> None:
    if set(params) != set(PARAM_NAMES):
        raise ValueError(
            f"fused_spatial_transformer: params must hold exactly {PARAM_NAMES}; "
            f"missing {sorted(set(PARAM_NAMES) - set(params))}, "
            f"unexpected {sorted(set(params) - set(PARAM_NAMES))}")


def _launch(x, ctx, params, n_heads):
    _check_names(params)
    _check_cuda_inputs(x, ctx, params, n_heads)
    r, s, c = x.shape
    kv_len, cc = ctx.shape[1], ctx.shape[2]
    iff = params["w2"].shape[1]
    dev = x.device
    out = torch.empty_like(x)
    # scratch of the phase split: GroupNorm moments, self-attention K/V of
    # every row, cross-attention K/V of every context row
    stats = torch.empty((r, GROUPS, 2), dtype=torch.float32, device=dev)
    k1, v1 = torch.empty_like(x), torch.empty_like(x)
    k2 = torch.empty((r * kv_len, c), dtype=torch.bfloat16, device=dev)
    v2 = torch.empty_like(k2)
    tensors = [x, ctx, out, stats, k1, v1, k2, v2] + [params[n] for n in PARAM_NAMES]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    lib = _build.load_library()
    err = lib.vmv_fused_spatial_fwd(ptrs, r, s, c, kv_len, cc, n_heads, iff,
                                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "vmv_fused_spatial_fwd")
    profiling.count("launch.fused_spatial", shape=(r, s, c, kv_len))
    return out


class _FusedSpatial(torch.autograd.Function):
    """Forward: the kernel; backward: autograd through the plain twin on the
    saved inputs."""

    @staticmethod
    def forward(fctx, n_heads, x, ctx, *tensors):
        fctx.n_heads = n_heads
        fctx.save_for_backward(x, ctx, *tensors)
        return _launch(x, ctx, dict(zip(PARAM_NAMES, tensors)), n_heads)

    @staticmethod
    def backward(fctx, grad):
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in fctx.saved_tensors]
            out = spatial_block_reference(args[0], args[1], dict(zip(PARAM_NAMES, args[2:])),
                                          fctx.n_heads)
        return (None, *torch.autograd.grad(out, args, grad.to(out.dtype), allow_unused=True))


def fused_spatial_transformer(x: torch.Tensor, ctx: torch.Tensor,
                              params: Dict[str, torch.Tensor], n_heads: int) -> torch.Tensor:
    """x [R, S, C], ctx [R, L, Cc] → [R, S, C]: the CUDA kernel on a CUDA
    tensor (differentiable: the backward recomputes through the plain twin),
    the plain twin on a CPU tensor."""
    if not x.is_cuda:
        return spatial_block_reference(x, ctx, params, n_heads)
    _check_names(params)
    tensors = [params[n] for n in PARAM_NAMES]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, ctx, *tensors)):
        return _FusedSpatial.apply(n_heads, x, ctx, *tensors)
    return _launch(x, ctx, params, n_heads)
