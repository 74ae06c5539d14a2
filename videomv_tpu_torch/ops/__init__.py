"""Attention, feed-forward and splat-composite ops, each a hand-written CUDA
kernel beside its plain PyTorch twin (modules ``flash_attention``,
``fused_ffn`` and ``splat``, the last with a forward and a backward
kernel), and the Gaussian-splat geometry around them."""

from . import flash_attention, fused_ffn, splat
from .attention import attention_eligible, dot_product_attention
from .fused_ffn import ffn_eligible, geglu_ffn, geglu_ffn_reference

__all__ = [
    "attention_eligible",
    "dot_product_attention",
    "ffn_eligible",
    "flash_attention",
    "fused_ffn",
    "geglu_ffn",
    "geglu_ffn_reference",
    "launch_counts",
    "launch_counts_by_shape",
    "reset_launch_counts",
    "splat",
]


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    return {"flash_attention": flash_attention.LAUNCHES, "geglu_ffn": fused_ffn.LAUNCHES,
            "splat_composite": splat.LAUNCHES, "splat_composite_bwd": splat.BWD_LAUNCHES}


def launch_counts_by_shape() -> dict:
    """The attention and FFN kernels' launches since the last reset, split by
    the shape of each launch: ``(B, S, H, D)`` and ``(T, C, I)``."""
    return {"flash_attention": dict(flash_attention.LAUNCHES_BY_SHAPE),
            "geglu_ffn": dict(fused_ffn.LAUNCHES_BY_SHAPE)}


def reset_launch_counts() -> None:
    flash_attention.LAUNCHES = 0
    flash_attention.LAUNCHES_BY_SHAPE.clear()
    fused_ffn.LAUNCHES = 0
    fused_ffn.LAUNCHES_BY_SHAPE.clear()
    splat.LAUNCHES = 0
    splat.BWD_LAUNCHES = 0
