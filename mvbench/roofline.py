"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit) and the least time a kernel's work can take on it.

The bounds are frozen copies of the port's smoke script's
(``chip_smoke.py::_bound``, ``_attn_bound``, ``_attn_bwd_bound``,
``_ffn_bound``): each input byte counted once, each output byte once,
operations from the shapes. ``KERNEL_CLASSES`` is its classifier of device
kernel names (first match wins)."""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12


def bound_ms(n_bytes: float, ops: float, peak_ops: float = PEAK_BF16_FLOPS) -> float:
    """The larger of the bytes over the bandwidth and the operations over
    the peak, in ms."""
    return 1e3 * max(n_bytes / PEAK_BYTES_S, ops / peak_ops)


def attn_bound_ms(b: int, s: int, h: int, d: int) -> float:
    """Self-attention forward: q, k, v read and o written in bf16; QKᵀ and PV."""
    return bound_ms(4 * b * s * h * d * 2, 4 * b * h * s * s * d)


def attn_bwd_bound_ms(b: int, s: int, h: int, d: int) -> float:
    """Its backward: q, k, v, o, dO read and dQ, dK, dV written in bf16, the
    lse read in fp32; five products of 2·S²·D each per (batch, head)."""
    return bound_ms(8 * b * s * h * d * 2 + 4 * b * h * s, 10 * b * h * s * s * d)


def ffn_bound_ms(t: int, c: int, inner: int) -> float:
    """GEGLU feed-forward over T tokens of width C: x read and out written in
    bf16, W1 [2I, C] and W2 [C, I] in bf16, biases in fp32; 6·T·C·I operations."""
    return bound_ms(2 * (2 * t * c + 3 * c * inner) + 4 * (2 * inner + c), 6 * t * c * inner)


SPATIAL_WGMMA_KERNELS = ("spatial_ctx_kv_wgmma_kernel", "spatial_front_kv_wgmma_kernel",
                         "spatial_block_wgmma_kernel")
KERNEL_CLASSES = (
    ("fused_spatial (ours)", SPATIAL_WGMMA_KERNELS + (
        "spatial_block_kernel", "spatial_kv_kernel", "ctx_kv_kernel", "gn_stats_kernel")),
    ("flash_attention (ours)", ("flash_attn_fwd_kernel", "flash_attn_wgmma_kernel")),
    ("flash_attention_bwd (ours)", ("flash_attn_bwd", "attn_bwd")),
    ("geglu_ffn (ours)", ("geglu_ffn_kernel", "geglu_ffn_wgmma_kernel")),
    ("splat_composite (ours)", ("splat_composite",)),
    ("convolution", ("conv", "fprop", "dgrad", "implicit")),
    ("matmul", ("gemm", "nvjet", "cutlass", "cublas", "matmul")),
    ("normalisation", ("norm", "moments")),
    ("softmax", ("softmax",)),
    ("copy / layout", ("copy", "cat", "transpose", "index")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "reduce")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    return next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)), "other")
