"""Fused GEGLU feed-forward: the CUDA kernel ``csrc/fused_ffn.cu`` and its
plain PyTorch twin.

Port of ``videomv_tpu/ops/fused_ffn.py``. ``geglu_ffn(x, w1, b1, w2, b2)``
computes ``(x·W1a + b1a) · gelu_erf(x·W1b + b1b) · W2 + b2`` for ``x [T, C]``
with the weights in ``nn.Linear`` layout (``w1 [2I, C]``, ``w2 [C, I]``,
the transposes of the JAX package's ``[C, 2I]`` / ``[I, C]``). On a CUDA
tensor it launches the hand-written kernel (bf16 x and weights, fp32
biases) or raises; on a CPU tensor it runs ``geglu_ffn_reference``. The
fp32 sampling mode never reaches the kernel (``ffn_eligible`` is bf16-only).

``LAUNCHES`` counts kernel launches (and nothing else);
``LAUNCHES_BY_SHAPE`` holds the same count split by the ``(T, C, I)`` of
each launch.

Under grad ``geglu_ffn`` is a ``torch.autograd.Function`` like the JAX
package's ``custom_vjp``: the forward is the kernel, the backward
differentiates ``geglu_ffn_reference`` on the saved inputs. The module gate
(``models.blocks.FeedForward``) still keeps training mode, where dropout
sits between the two products, on the plain path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["LAUNCHES", "LAUNCHES_BY_SHAPE", "ffn_eligible", "geglu_ffn", "geglu_ffn_reference"]

LAUNCHES = 0
LAUNCHES_BY_SHAPE: dict = {}


def geglu_ffn_reference(x, w1, b1, w2, b2):
    """Plain twin: GEGLU(x·w1ᵀ + b1)·w2ᵀ + b2 with the exact-erf gelu gate
    (mirrors the JAX ``geglu_ffn_reference``: gate math in fp32, g cast to
    the weights' dtype, output in x's dtype plus b2 in x's dtype). In bf16,
    PyTorch's product rounds x·w1ᵀ to bf16 before the fp32 gate math; the
    kernel keeps it in fp32."""
    h = F.linear(x, w1).float() + b1.float()
    lin, gate = h.chunk(2, dim=-1)
    g = lin * F.gelu(gate)
    return F.linear(g.to(w2.dtype), w2).to(x.dtype) + b2.to(x.dtype)


def ffn_eligible(t: int, c: int, inner: int, dtype: torch.dtype, is_cuda: bool) -> bool:
    """The kernel gate of the JAX package (bf16, C <= 640, T >= 4096,
    inner % 256 == 0) with its TPU-backend test replaced by ``is_cuda``.
    The C = 1280 levels are not eligible."""
    if not is_cuda or dtype != torch.bfloat16:
        return False
    return c <= 640 and t >= 4 * 1024 and inner % 256 == 0


def _check_cuda_inputs(x, w1, b1, w2, b2) -> None:
    dev = x.device
    for name, t, dt in (("x", x, torch.bfloat16), ("w1", w1, torch.bfloat16),
                        ("w2", w2, torch.bfloat16), ("b1", b1, torch.float32),
                        ("b2", b2, torch.float32)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"geglu_ffn: {name} must be on {dev}")
        if t.dtype != dt:
            raise ValueError(f"geglu_ffn: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"geglu_ffn: {name} must be contiguous")
    if x.dim() != 2:
        raise ValueError(f"geglu_ffn: x must be [T, C], got {tuple(x.shape)}")
    t, c = x.shape
    inner = w2.shape[1] if w2.dim() == 2 else -1
    if (tuple(w1.shape) != (2 * inner, c) or tuple(w2.shape) != (c, inner)
            or tuple(b1.shape) != (2 * inner,) or tuple(b2.shape) != (c,)):
        raise ValueError(
            f"geglu_ffn: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"b1 {tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} "
            f"do not fit w1 [2I, C], w2 [C, I]")
    if c % 16 != 0 or c > 1024 or inner % 64 != 0:
        raise ValueError(
            f"geglu_ffn: the kernel takes C % 16 == 0, C <= 1024, I % 64 == 0; "
            f"got C={c}, I={inner}")
    if x.data_ptr() % 16 != 0:
        raise ValueError("geglu_ffn: x must be 16-byte aligned")


def _launch(x, w1, b1, w2, b2):
    global LAUNCHES
    _check_cuda_inputs(x, w1, b1, w2, b2)
    t, c = x.shape
    inner = w2.shape[1]
    out = torch.empty_like(x)
    lib = _build.load_library()
    err = lib.vmv_geglu_ffn_fwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), t, c, inner, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "vmv_geglu_ffn_fwd")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(t, c, inner)] = LAUNCHES_BY_SHAPE.get((t, c, inner), 0) + 1
    return out


class _GegluFFN(torch.autograd.Function):
    """Forward: the kernel; backward: autograd through the plain twin on the
    saved inputs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _launch(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            args = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = geglu_ffn_reference(*args)
        return torch.autograd.grad(out, args, grad.to(out.dtype))


def geglu_ffn(x, w1, b1, w2, b2):
    """x [T, C] → [T, C]: the CUDA kernel on a CUDA tensor (differentiable:
    the backward recomputes through the plain twin), the plain twin on a CPU
    tensor."""
    if not x.is_cuda:
        return geglu_ffn_reference(x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _GegluFFN.apply(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)
