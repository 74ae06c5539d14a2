"""Attention, feed-forward and splat-composite ops, each a hand-written CUDA
kernel beside its plain PyTorch twin (modules ``flash_attention``,
``fused_ffn`` and ``splat``), and the Gaussian-splat geometry around them."""

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
    "reset_launch_counts",
    "splat",
]


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    return {"flash_attention": flash_attention.LAUNCHES, "geglu_ffn": fused_ffn.LAUNCHES,
            "splat_composite": splat.LAUNCHES}


def reset_launch_counts() -> None:
    flash_attention.LAUNCHES = 0
    fused_ffn.LAUNCHES = 0
    splat.LAUNCHES = 0
