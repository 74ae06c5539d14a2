"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain PyTorch twin.

Port of ``videomv_tpu/ops/flash_attention.py``. ``flash_attention(q, k, v)``
takes ``[B, S, H, D]`` tensors (the JAX package's layout). On a CUDA tensor
it launches the hand-written kernel, or raises if the kernel does not take
the input (bf16 only, self-attention, S % 64 == 0, D in {64, 128}; the
fp32 sampling mode therefore never reaches it). On a CPU tensor it runs
``attention_reference``, the plain twin.

The counter ``launch.flash_attention`` of ``utils.profiling`` counts kernel
launches (and nothing else), so a run can show that its main path went
through the kernel, by the ``(B, S, H, D)`` of each launch too;
``launch.flash_attention_bwd`` counts the backward's (one a call of
``csrc/flash_attention_bwd.cu``'s entry, which runs its three kernels).

Under grad ``flash_attention`` is a ``torch.autograd.Function`` like the JAX
package's ``custom_vjp``: the forward is the kernel, which also writes each
row's log-sum-exp; the backward is the hand-written backward kernel, which
recomputes the probabilities from it without any [B, H, S, S] tensor (the
JAX package's ``_bwd`` differentiates its plain reference instead).
``attention_lse_reference`` and ``attention_backward_reference`` are the two
kernels' plain twins, the same blockwise algorithm in fp32.

Every plain site forms its logits with ``fp32_logits``: from bf16 operands
with an fp32 result, as the JAX package's ``preferred_element_type=float32``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import profiling
from . import _build

__all__ = ["VARIANT_MMA", "VARIANT_NAMES", "VARIANT_WGMMA", "attention_backward_reference",
           "attention_lse_reference", "attention_reference", "attention_tensor_map",
           "attention_variant", "flash_attention", "fp32_logits"]

# keys a tile of the plain twins' blockwise loop (the kernels' tile)
TWIN_BLOCK = 64

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


def fp32_logits(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, a, b)`` with fp32 accumulation and an fp32
    result, as ``jnp.einsum(..., preferred_element_type=jnp.float32)``: the
    operands are upcast (a product of two bf16 values is exact in fp32) and
    autocast is held off, which would round them back. (``torch.bmm``'s
    ``out_dtype`` overload would keep bf16 operands on CUDA, but it has no
    derivative, and the plain sites are differentiated in training.)"""
    with torch.autocast(a.device.type, enabled=False):
        return torch.einsum(equation, a.float(), b.float())


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
    logits and softmax, probabilities cast to ``v.dtype`` before the PV
    product."""
    scale = q.shape[-1] ** -0.5
    logits = fp32_logits("bqhd,bkhd->bhqk", q, k) * scale
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The forward kernel's plain twin under grad: ``(o, lse)`` of
    self-attention over ``[B, S, H, D]``, with ``lse`` [B, H, S] fp32 each
    query row's log-sum-exp of its scaled logits (natural log).

    The kernels' algorithm in fp32: an online softmax over key tiles of
    TWIN_BLOCK (running max and sum), the probabilities rounded to
    ``v.dtype`` before the PV product, o divided by the row sum at the end
    and rounded to ``q.dtype``."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    m = torch.full(qf.shape[:-1], float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(qf)
    for j in range(0, kf.shape[2], TWIN_BLOCK):
        s = qf @ kf[:, :, j:j + TWIN_BLOCK].transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + p.to(v.dtype).float() @ vf[:, :, j:j + TWIN_BLOCK]
        m = m_new
    out = (o / l[..., None]).transpose(1, 2).to(q.dtype)
    return out, m + torch.log(l)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 o: torch.Tensor, lse: torch.Tensor, grad: torch.Tensor):
    """The backward kernel's plain twin: ``(dq, dk, dv)`` in ``q.dtype`` of
    self-attention over ``[B, S, H, D]`` from the forward's ``o`` and
    ``lse`` and the upstream gradient.

    The kernels' algorithm in fp32, over key tiles of TWIN_BLOCK: P =
    exp(S·scale − lse) recomputed; Δ = rowsum(dO ∘ O); dV = Pᵀ dO, dS =
    P ∘ (dO Vᵀ − Δ), dK = scale · dSᵀ Q, dQ = scale · dS K, with P and dS
    rounded to ``q.dtype`` before they enter a product (no-ops in fp32)."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, gf = (t.float().transpose(1, 2) for t in (q, k, v, o, grad))

    def rounded(t):
        return t.to(q.dtype).float()

    delta = (gf * of).sum(-1, keepdim=True)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(0, kf.shape[2], TWIN_BLOCK):
        kj, vj = kf[:, :, j:j + TWIN_BLOCK], vf[:, :, j:j + TWIN_BLOCK]
        p = torch.exp(qf @ kj.transpose(-1, -2) * scale - lse[..., None])
        dvs.append(rounded(p).transpose(-1, -2) @ gf)
        ds = rounded(p * (gf @ vj.transpose(-1, -2) - delta))
        dks.append(ds.transpose(-1, -2) @ qf * scale)
        dq = dq + ds @ kj
    return tuple(t.transpose(1, 2).to(q.dtype)
                 for t in (dq * scale, torch.cat(dks, 2), torch.cat(dvs, 2)))


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
            variant: Optional[int] = None, with_lse: bool = False):
    """One kernel launch; ``variant`` (for measurements that time both
    kernels on one input) overrides the choice by shape and must take it.
    Returns o, or ``(o, lse)`` with ``with_lse``."""
    _check_cuda_inputs(q, k, v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _build.load_library()
    err = lib.vmv_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, s, h, d, float(d ** -0.5),
        attention_variant(b, s, h, d) if variant is None else variant,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "vmv_flash_attn_fwd")
    profiling.count("launch.flash_attention", shape=(b, s, h, d))
    return (out, lse) if with_lse else out


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                lse: torch.Tensor, grad: torch.Tensor):
    """One call of the backward kernels: ``(dq, dk, dv)``."""
    _check_cuda_inputs(q, k, v)
    _check_cuda_inputs(q, o, grad)
    b, s, h, d = q.shape
    if (lse.dtype != torch.float32 or lse.shape != (b, h, s) or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError(f"flash_attention backward: lse must be fp32 [{b}, {h}, {s}] on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse)
    lib = _build.load_library()
    err = lib.vmv_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        grad.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, s, h, d, float(d ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "vmv_flash_attn_bwd")
    profiling.count("launch.flash_attention_bwd", shape=(b, s, h, d))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel, with each row's log-sum-exp; backward: the
    backward kernels on the saved q, k, v, o and lse (under checkpointing,
    those of the recomputation)."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = _launch(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        # under autocast the upstream gradient may come fp32 or strided
        return _launch_bwd(q, k, v, out, lse, grad.to(q.dtype).contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Self-attention over ``[B, S, H, D]``: the CUDA kernel on a CUDA
    tensor (differentiable through the backward kernel), the plain twin on a
    CPU tensor."""
    if not q.is_cuda:
        return attention_reference(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v)
    return _launch(q, k, v)
