"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain PyTorch twin.

Port of ``videomv_tpu/ops/flash_attention.py``. ``flash_attention(q, k, v)``
takes ``[B, S, H, D]`` tensors (the JAX package's layout). On a CUDA tensor
it launches the hand-written kernel, or raises if the kernel does not take
the input (bf16 only, self-attention, S % 64 == 0, D in {64, 128}; the
fp32 sampling mode therefore never reaches it). On a CPU tensor it runs
``attention_reference``, the plain twin.

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel; ``LAUNCHES_BY_SHAPE`` holds the
same count split by the ``(B, S, H, D)`` of each launch.

Under grad ``flash_attention`` is a ``torch.autograd.Function`` like the JAX
package's ``custom_vjp``: the forward is the kernel, the backward
differentiates ``attention_reference`` on the saved q, k, v (the JAX package
has no backward kernel either; it recomputes through its plain reference).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

__all__ = ["LAUNCHES", "LAUNCHES_BY_SHAPE", "VARIANT_MMA", "VARIANT_NAMES", "VARIANT_WGMMA",
           "attention_reference", "attention_tensor_map", "attention_variant", "flash_attention"]

LAUNCHES = 0
LAUNCHES_BY_SHAPE: dict = {}

# The two hand-written kernels behind ``vmv_flash_attn_fwd``
# (csrc/flash_attention.cu): the wgmma kernel (128 query rows a block, K/V
# tiles of 128 keys staged by TMA) takes head_dim 64 and S % 128 == 0; the
# mma.sync kernel (64 query rows a block) takes every shape the wrapper
# accepts. The choice is by shape, made here and checked again by the C entry
# point. A grid of fewer than WGMMA_MIN_BLOCKS blocks (the LGM's 16² calls:
# 32) stays with the mma.sync kernel: it is launch-bound, twice as many
# smaller blocks fill more of the card, and no tensor maps are encoded per
# launch (timed in turns on an H100 the mma.sync kernel is 4-7 % faster there,
# the wgmma kernel 1-9 % faster at 128 blocks and 1.4x at the UNet's shapes).
VARIANT_MMA, VARIANT_WGMMA = 0, 1
VARIANT_NAMES = {VARIANT_MMA: "mma.sync", VARIANT_WGMMA: "wgmma"}


# the wgmma kernel's block: 128 query rows, K/V tiles of 128 keys, 3 stages
WGMMA_Q_ROWS, WGMMA_KEYS, WGMMA_STAGES = 128, 128, 3
WGMMA_SMEM_BYTES = 1024 + 128 * 128 * (1 + 2 * WGMMA_STAGES) + 1024
WGMMA_MIN_BLOCKS = 64


def attention_variant(b: int, s: int, h: int, d: int) -> int:
    """Which kernel serves ``[b, s, h, d]``."""
    if d != 64 or s % WGMMA_KEYS != 0:
        return VARIANT_MMA
    blocks = b * h * (s // WGMMA_Q_ROWS)
    return VARIANT_WGMMA if blocks >= WGMMA_MIN_BLOCKS else VARIANT_MMA


def attention_tensor_map(b: int, s: int, h: int, d: int) -> dict:
    """The TMA tensor map the wgmma kernel reads q, k and v through, in place
    in ``[B, S, H, D]``: dimensions innermost first (D, H, S, B), the byte
    strides of the outer three, and the box of one load (one head's 128
    tokens x 64 channels = a 128-byte-swizzled tile of 16 KB)."""
    return dict(dims=(d, h, s, b), strides_bytes=(2 * d, 2 * h * d, 2 * s * h * d),
                box=(64, 1, WGMMA_KEYS, 1))


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q·kᵀ·d^-½ [+ bias] [masked]) · v over ``[B, S, H, D]``.

    Mirrors the JAX package's plain path (``ops/attention.py``
    ``_reference_attention`` and ``flash_attention._reference``): fp32
    softmax, probabilities cast to ``v.dtype`` before the PV product. For
    bf16 inputs PyTorch's bf16 product rounds the logits to bf16 before the
    fp32 softmax; the kernel keeps them in fp32."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _check_cuda_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_attention: {name} must be bfloat16, got {t.dtype}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(
                f"flash_attention: self-attention only, q/k/v of one [B,S,H,D] "
                f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"flash_attention: {name} must be 16-byte aligned")
    b, s, h, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"flash_attention: head_dim {d} not in (64, 128)")
    if s % 64 != 0:
        raise ValueError(f"flash_attention: sequence {s} is not a multiple of 64")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            variant: Optional[int] = None) -> torch.Tensor:
    """One kernel launch; ``variant`` (for measurements that time both
    kernels on one input) overrides the choice by shape and must take it."""
    global LAUNCHES
    _check_cuda_inputs(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.vmv_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, d, float(d ** -0.5),
        attention_variant(b, s, h, d) if variant is None else variant,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "vmv_flash_attn_fwd")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(b, s, h, d)] = LAUNCHES_BY_SHAPE.get((b, s, h, d), 0) + 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel; backward: autograd through the plain twin on the
    saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = attention_reference(q, k, v)
        return torch.autograd.grad(out, (q, k, v), grad.to(out.dtype))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over ``[B, S, H, D]``: the CUDA kernel on a CUDA
    tensor (differentiable: the backward recomputes through the plain twin),
    the plain twin on a CPU tensor."""
    if not q.is_cuda:
        return attention_reference(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return _launch(q, k, v)
