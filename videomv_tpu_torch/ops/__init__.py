"""Attention, feed-forward, fused spatial-block and splat-composite ops, each
a hand-written CUDA kernel beside its plain PyTorch twin (modules
``flash_attention``, ``fused_ffn``, ``fused_spatial`` and ``splat``, the
first and the last with a forward and a backward kernel), and the
Gaussian-splat geometry around them."""

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


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    return {"flash_attention": flash_attention.LAUNCHES,
            "flash_attention_bwd": flash_attention.BWD_LAUNCHES, "geglu_ffn": fused_ffn.LAUNCHES,
            "splat_composite": splat.LAUNCHES, "splat_composite_bwd": splat.BWD_LAUNCHES,
            "fused_spatial": fused_spatial.LAUNCHES}


def launch_counts_by_shape() -> dict:
    """The attention (forward and backward), FFN and fused spatial-block
    kernels' launches since the last reset, split by the shape of each
    launch: ``(B, S, H, D)``, ``(T, C, I)`` and ``(R, S, C, L)``."""
    return {"flash_attention": dict(flash_attention.LAUNCHES_BY_SHAPE),
            "flash_attention_bwd": dict(flash_attention.BWD_LAUNCHES_BY_SHAPE),
            "geglu_ffn": dict(fused_ffn.LAUNCHES_BY_SHAPE),
            "fused_spatial": dict(fused_spatial.LAUNCHES_BY_SHAPE)}


def reset_launch_counts() -> None:
    flash_attention.LAUNCHES = 0
    flash_attention.LAUNCHES_BY_SHAPE.clear()
    flash_attention.BWD_LAUNCHES = 0
    flash_attention.BWD_LAUNCHES_BY_SHAPE.clear()
    fused_ffn.LAUNCHES = 0
    fused_ffn.LAUNCHES_BY_SHAPE.clear()
    splat.LAUNCHES = 0
    splat.BWD_LAUNCHES = 0
    fused_spatial.LAUNCHES = 0
    fused_spatial.LAUNCHES_BY_SHAPE.clear()
