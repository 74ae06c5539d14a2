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

__all__ = ["LAUNCHES", "LAUNCHES_BY_SHAPE", "attention_reference", "flash_attention"]

LAUNCHES = 0
LAUNCHES_BY_SHAPE: dict = {}


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
    b, s, h, d = q.shape
    if d not in (64, 128):
        raise ValueError(f"flash_attention: head_dim {d} not in (64, 128)")
    if s % 64 != 0:
        raise ValueError(f"flash_attention: sequence {s} is not a multiple of 64")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    _check_cuda_inputs(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lib = _build.load_library()
    err = lib.vmv_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, d, float(d ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
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
