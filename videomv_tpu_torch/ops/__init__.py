"""Attention, feed-forward, fused spatial-block and splat-composite ops, each
a hand-written CUDA kernel beside its plain PyTorch twin (modules
``flash_attention``, ``fused_ffn``, ``fused_spatial`` and ``splat``, the
first and the last with a forward and a backward kernel), and the
Gaussian-splat geometry around them."""

from ..utils import profiling
from . import flash_attention, fused_ffn, fused_spatial, splat
from .attention import attention_eligible, dot_product_attention
from .fused_ffn import ffn_eligible, geglu_ffn, geglu_ffn_reference
from .gaussian_splat import project_gaussians, rasterize_dense, render_gaussians
from .ply_io import load_ply, save_ply

__all__ = [
    "attention_eligible",
    "dot_product_attention",
    "ffn_eligible",
    "flash_attention",
    "fused_ffn",
    "fused_spatial",
    "geglu_ffn",
    "geglu_ffn_reference",
    "launch_counts",
    "launch_counts_by_shape",
    "load_ply",
    "project_gaussians",
    "rasterize_dense",
    "render_gaussians",
    "reset_launch_counts",
    "save_ply",
    "splat",
]


# the kernels' launch counters in ``utils.profiling``'s registry
_KERNELS = ("flash_attention", "flash_attention_bwd", "geglu_ffn", "splat_composite",
            "splat_composite_bwd", "fused_spatial")
_BY_SHAPE = ("flash_attention", "flash_attention_bwd", "geglu_ffn", "fused_spatial")


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    counts = profiling.counts()
    return {k: counts.get(f"launch.{k}", 0) for k in _KERNELS}


def launch_counts_by_shape() -> dict:
    """The attention (forward and backward), FFN and fused spatial-block
    kernels' launches since the last reset, split by the shape of each
    launch: ``(B, S, H, D)``, ``(T, C, I)`` and ``(R, S, C, L)``."""
    return {k: profiling.counts_by_shape(f"launch.{k}") for k in _BY_SHAPE}


def reset_launch_counts() -> None:
    profiling.reset_counts(f"launch.{k}" for k in _KERNELS)
