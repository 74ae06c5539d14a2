"""Fused GEGLU feed-forward: the CUDA kernel ``csrc/fused_ffn.cu`` and its
plain PyTorch twin.

Port of ``videomv_tpu/ops/fused_ffn.py``. ``geglu_ffn(x, w1, b1, w2, b2)``
computes ``(x·W1a + b1a) · gelu_erf(x·W1b + b1b) · W2 + b2`` for ``x [T, C]``
with the weights in ``nn.Linear`` layout (``w1 [2I, C]``, ``w2 [C, I]``,
the transposes of the JAX package's ``[C, 2I]`` / ``[I, C]``). On a CUDA
tensor it launches the hand-written wgmma kernel (bf16 x and weights, fp32
biases) or raises; on a CPU tensor it runs ``geglu_ffn_reference``. The
kernel takes the UNets' widths C in ``WGMMA_WIDTHS`` (320, 512, 640);
``ffn_eligible`` sends every other width, and the fp32 sampling mode, to the
plain path.

The counter ``launch.geglu_ffn`` of ``utils.profiling`` counts kernel
launches (and nothing else), by the ``(T, C, I)`` of each launch too.

Under grad ``geglu_ffn`` is a ``torch.autograd.Function`` like the JAX
package's ``custom_vjp``: the forward is the kernel, the backward
differentiates ``geglu_ffn_reference`` on the saved inputs. The module gate
(``models.blocks.FeedForward``) still keeps training mode, where dropout
sits between the two products, on the plain path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import _build

__all__ = ["WGMMA_WIDTHS", "ffn_eligible", "ffn_plan", "ffn_tensor_maps", "geglu_ffn",
           "geglu_ffn_reference"]


# the widths ``vmv_geglu_ffn_fwd`` (csrc/fused_ffn.cu) instantiates its kernel for
WGMMA_WIDTHS = (320, 512, 640)
MAX_DYNAMIC_SMEM = 232448  # bytes one block may ask for on sm_90


def ffn_plan(c: int) -> dict:
    """The wgmma kernel's tiling at width ``c``, as ``FfnWg<C>`` of
    csrc/fused_ffn.cu lays it out (sizes in bytes): 64 token rows a block, two
    consumer warpgroups that split the columns, x as ``c / 64`` swizzled
    tiles, two g tiles, and a ring of weight stages that takes the rest of
    the shared memory."""
    if c not in WGMMA_WIDTHS:
        raise ValueError(f"the wgmma kernel is built for C in {WGMMA_WIDTHS}, got {c}")
    lin_cols = 32                              # of a chunk, per warpgroup (as many gate)
    w2_rows = 80 if c % 160 == 0 else 64       # per warpgroup and W2 stage
    w1_stage = 2 * 2 * lin_cols * 128          # one K block of 64 columns of x
    w2_stage = 2 * w2_rows * 128
    stage = max(w1_stage, w2_stage)
    fixed = (c // 64) * 8192 + 2 * 8192
    stages = min(8, (MAX_DYNAMIC_SMEM - 1024 - fixed - 1024) // stage)
    producer = c <= 320
    return dict(rows=64, chunk=64, lin_cols=lin_cols, w1_stages=c // 64, w2_rows=w2_rows,
                w2_stages=c // 2 // w2_rows, accumulator_registers=c // 4 + lin_cols,
                stage_bytes=stage, stages=stages,
                smem_bytes=1024 + fixed + stages * stage + 1024,
                producer_warpgroup=producer, threads=256 + (128 if producer else 0))


def ffn_tensor_maps(t: int, c: int, inner: int) -> dict:
    """The three TMA tensor maps of one wgmma launch, innermost dimension
    first (elements; strides in bytes of the outer dimensions; the box is one
    TMA load): every box is 64 bf16 = one 128-byte swizzle row wide."""
    plan = ffn_plan(c)
    return {
        "x": dict(dims=(c, t), strides_bytes=(2 * c,), box=(64, plan["rows"])),
        "w1": dict(dims=(c, 2 * inner), strides_bytes=(2 * c,),
                   box=(64, plan["lin_cols"])),
        "w2": dict(dims=(inner, c), strides_bytes=(2 * inner,), box=(64, plan["w2_rows"])),
    }


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
    inner % 256 == 0) with its TPU-backend test replaced by ``is_cuda``, and
    C one of the kernel's widths. The C = 1280 levels are not eligible."""
    if not is_cuda or dtype != torch.bfloat16:
        return False
    return c <= 640 and t >= 4 * 1024 and inner % 256 == 0 and c in WGMMA_WIDTHS


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
    if c not in WGMMA_WIDTHS or inner % 64 != 0:
        raise ValueError(
            f"geglu_ffn: the kernel takes C in {WGMMA_WIDTHS} and I % 64 == 0; "
            f"got C={c}, I={inner}")
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"geglu_ffn: {name} must be 16-byte aligned")


def _launch(x, w1, b1, w2, b2):
    _check_cuda_inputs(x, w1, b1, w2, b2)
    t, c = x.shape
    inner = w2.shape[1]
    out = torch.empty_like(x)
    lib = _build.load_library()
    err = lib.vmv_geglu_ffn_fwd(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), t, c, inner, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "vmv_geglu_ffn_fwd")
    profiling.count("launch.geglu_ffn", shape=(t, c, inner))
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
