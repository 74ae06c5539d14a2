"""Multi-head attention entry point for the UNet transformers.

Port of ``videomv_tpu/ops/attention.py``: ``dot_product_attention`` takes
``[B, S, H, D]`` tensors and dispatches to the CUDA flash-attention kernel
where the JAX package would take its Pallas kernel, and to the plain
fp32-softmax path otherwise. The gate is the JAX one with its backend test
(``jax.default_backend() == "tpu"``) replaced by ``q.is_cuda``, plus bf16
(the kernel's only dtype in this port; fp32 sampling takes the plain path),
and it admits exactly the shapes a kernel variant serves
(``flash_attention.kernel_refuses``).

The always-on counter ``attn.plain`` of ``utils.profiling`` counts each call
that takes the plain path, by its ``(B, S_q, S_kv, H, D)``; with the kernel's
``launch.flash_attention`` it tells which share of a program's attention
the kernel served.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils import profiling
from .flash_attention import attention_reference, flash_attention, kernel_refuses

__all__ = ["attention_eligible", "dot_product_attention"]


def attention_eligible(q_shape: Sequence[int], k_shape: Sequence[int],
                       dtype: torch.dtype, is_cuda: bool, grad: bool = False) -> bool:
    """The kernel gate: long self-attention only (q_seq == k_seq >= 256),
    head_dim 64 or 128, bf16 on a CUDA device, and a shape the kernels take
    (``grad``: under autograd, where the backward kernel needs q_seq % 64 ==
    0). Cross-attention (77 tokens), temporal attention (F tokens) and the
    8² level (64 tokens) stay plain, as in the JAX package."""
    if not is_cuda or dtype != torch.bfloat16:
        return False
    q_seq, k_seq = q_shape[1], k_shape[1]
    return (q_seq >= 256 and q_seq == k_seq
            and not kernel_refuses(q_seq, q_shape[-1], grad))


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over ``[B, S, H, D]`` tensors."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    if (bias is None and mask is None
            and attention_eligible(q.shape, k.shape, q.dtype, q.is_cuda, grad)):
        return flash_attention(q, k, v)
    b, s_q, h, d = q.shape
    profiling.count("attn.plain", shape=(b, s_q, k.shape[1], h, d))
    return attention_reference(q, k, v, bias=bias, mask=mask)
