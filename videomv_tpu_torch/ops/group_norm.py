"""GroupNorm with an optional SiLU: the CUDA kernel ``csrc/group_norm.cu``
(kernel 6) and its plain PyTorch twin.

``group_norm(x, weight, bias, groups, eps, silu)`` computes
``silu?((x - mean_g) · rstd_g · weight_c + bias_c)`` over ``x [N, C, ...]``
with fp32 statistics and one rounding to x's dtype, and returns it
contiguous. On a CUDA tensor it launches the kernel (bf16 x, weight and
bias) or raises; on a CPU tensor it runs ``group_norm_reference``. The
kernel reads x where it lies when x is contiguous or is a frame-major view
``[N, C, F, *S]`` of a contiguous ``[N·F, C, *S]`` (the UNets' temporal
norms): no copy precedes it (``kernel_layout``). Any other layout (the
channels-last sums after the UNets' spatial transformers) is made
contiguous first, as PyTorch's own GroupNorm does.

How a call is cut over the card (``group_norm_plan``) follows from the
shape alone: each (sample, group) is one thread-block cluster of 1 to 16
CTAs. Each CTA holds its slice of the group in shared memory (one read of
device memory) where the slice is small; of a larger slice it holds the
first ``HELD_BYTES`` and streams the rest (read twice). Whether the card can
place a cluster is asked of it once a plan (``vmv_group_norm_max_clusters``).

The models reach it through ``models.blocks.GroupNorm``, whose gate is
``group_norm_eligible``. The counter ``launch.group_norm`` of
``utils.profiling`` counts each launch by ``(N, C, F·H·W, silu)``;
``gn.plain`` counts, by the same key, each bf16 call that a gate sent to the
plain path (``count_plain``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import _build

__all__ = ["Layout", "Plan", "count_plain", "group_norm", "group_norm_eligible",
           "group_norm_plan", "group_norm_reference", "kernel_layout", "on_card", "shape_takes"]

VEC = 8  # bf16 values in one 16-byte load
CLUSTER_SIZES = (1, 2, 4, 8, 16)
SLICE_BYTES = 32768  # the slice a plan aims at
HELD_BYTES = 65536  # what a CTA of a larger slice holds (csrc: at most kMaxHeldBytes)
MAX_GROUP_CHANNELS = 256


class Layout(NamedTuple):
    """Where a group of x lies: ``runs`` runs of ``(C/G)·per_channel``
    contiguous elements, ``run_stride`` apart (elements), ``sample_stride``
    from one sample to the next."""
    runs: int
    per_channel: int
    sample_stride: int
    run_stride: int


class Plan(NamedTuple):
    cluster: int      # CTAs of one (sample, group)
    slice_vecs: int   # 16-byte vectors one CTA takes
    res_vecs: int     # of them, those it holds in shared memory (the rest: read twice)
    threads: int


def shape_takes(shape, groups: int) -> bool:
    """Whether the kernel normalises a tensor of ``shape`` in ``groups``
    groups (laid out contiguously): C/G channels of whole 16-byte vectors."""
    if len(shape) < 3 or shape[1] % groups or shape[1] // groups > MAX_GROUP_CHANNELS:
        return False
    per_group = shape[1] // groups * math.prod(shape[2:])
    return per_group % VEC == 0 and per_group < 2 ** 31


def kernel_layout(x: torch.Tensor, groups: int) -> Optional[Layout]:
    """The layout the kernel reads ``x`` in where it lies, or None where it
    does not (``x`` must be made contiguous first)."""
    if not shape_takes(x.shape, groups):
        return None
    n, c = x.shape[:2]
    if x.is_contiguous():
        p = math.prod(x.shape[2:])
        layout = Layout(1, p, c * p, 0)
    elif x.dim() >= 4:
        f, space = x.shape[2], x.shape[3:]
        s = math.prod(space)
        inner = tuple(math.prod(space[i + 1:]) for i in range(len(space)))
        if (tuple(x.stride()[3:]) != inner or x.stride(1) != s or x.stride(2) != c * s):
            return None
        layout = Layout(f, s, x.stride(0) if n > 1 else f * c * s, c * s)
    else:
        return None
    if (layout.per_channel * (c // groups) % VEC or layout.sample_stride % VEC
            or layout.run_stride % VEC or x.data_ptr() % 16):
        return None
    return layout


def _threads(slice_vecs: int) -> int:
    """Up to 16 vectors a thread (the best of 128, 256 and 512 threads at
    the served shapes on the H100)."""
    return 128 if slice_vecs <= 512 else 256 if slice_vecs <= 4096 else 512


def group_norm_plan(n: int, c: int, groups: int, layout: Layout, sms: int,
                    max_clusters: Callable[[int, int, int], int]) -> Plan:
    """How one call is cut: the fewest CTAs a group (a power of two up to
    16) whose slices, held in shared memory, are at most ``SLICE_BYTES`` and
    give the card at least two CTAs an SM; else 16 CTAs (fewer for a group of
    fewer vectors, or where the card cannot place 16), each holding at most
    ``HELD_BYTES`` of its slice. Small slices let several CTAs share an SM,
    so that one's loads overlap another's reductions and stores (measured on
    the H100 over the plans of the served shapes). ``max_clusters(cluster,
    res_vecs, threads)`` is how many such clusters the card runs at once: 0
    rules a plan out."""
    vecs = (c // groups) * layout.per_channel * layout.runs // VEC
    blocks, fill = n * groups, 2 * sms
    for cs in CLUSTER_SIZES:
        sv = -(-vecs // cs)
        if (cs <= vecs and sv * 16 <= SLICE_BYTES and blocks * cs >= fill
                and max_clusters(cs, sv, _threads(sv)) > 0):
            return Plan(cs, sv, sv, _threads(sv))
    for cs in reversed([cs for cs in CLUSTER_SIZES if cs <= max(1, vecs)]):
        sv = -(-vecs // cs)
        res = min(sv, HELD_BYTES // 16)
        while True:
            if max_clusters(cs, res, _threads(sv)) > 0:
                return Plan(cs, sv, res, _threads(sv))
            if res == 0:
                break
            res //= 2
    raise RuntimeError(f"the card places no cluster of the GroupNorm kernel for {vecs} vectors")


@functools.lru_cache(maxsize=None)
def _device_max_clusters(device: int, cs: int, res_vecs: int, threads: int) -> int:
    with torch.cuda.device(device):
        got = _build.load_library().vmv_group_norm_max_clusters(cs, res_vecs, threads)
    if got < 0:
        raise RuntimeError(f"vmv_group_norm_max_clusters failed: cudaError_t {-got}")
    return got


@functools.lru_cache(maxsize=1024)
def _plan(device: int, n: int, c: int, groups: int, layout: Layout) -> Plan:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return group_norm_plan(n, c, groups, layout, sms,
                           functools.partial(_device_max_clusters, device))


def group_norm_reference(x, weight, bias, groups: int, eps: float, silu: bool = False):
    """Plain twin: the norm and the SiLU in fp32, one rounding to x's dtype,
    contiguous."""
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype).contiguous()


def _shape_key(x: torch.Tensor, silu: bool) -> tuple:
    return (x.shape[0], x.shape[1], math.prod(x.shape[2:]), bool(silu))


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies where the kernel runs (a CUDA device); the CPU
    tests of the gate substitute it."""
    return x.is_cuda


def group_norm_eligible(x: torch.Tensor, weight: Optional[torch.Tensor],
                        bias: Optional[torch.Tensor], groups: int) -> bool:
    """The kernel gate of an eval-mode module: bf16 input and affine
    parameters on a CUDA device, no autograd recording, and a shape the
    kernel takes (``shape_takes``)."""
    if (not on_card(x) or x.dtype != torch.bfloat16 or weight is None or bias is None
            or weight.dtype != torch.bfloat16 or bias.dtype != torch.bfloat16):
        return False
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return False
    return shape_takes(x.shape, groups)


def count_plain(x: torch.Tensor, silu: bool = False) -> None:
    """Count a call sent to the plain path (bf16 calls only, the kernel's
    dtype) in ``gn.plain``."""
    if x.dtype == torch.bfloat16:
        profiling.count("gn.plain", shape=_shape_key(x, silu))


def _launch(x, weight, bias, groups: int, eps: float, silu: bool):
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if not t.is_cuda or t.device != x.device or t.dtype != torch.bfloat16:
            raise ValueError(f"group_norm: {name} must be bf16 on {x.device}")
    c = x.shape[1]
    if tuple(weight.shape) != (c,) or tuple(bias.shape) != (c,) or not (
            weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"group_norm: weight and bias must be contiguous [{c}]")
    if not shape_takes(x.shape, groups):
        raise ValueError(f"group_norm: the kernel does not take x {tuple(x.shape)} in "
                         f"{groups} groups")
    layout = kernel_layout(x, groups)
    if layout is None:
        x = x.contiguous()
        layout = kernel_layout(x, groups)
    n = x.shape[0]
    plan = _plan(x.device.index, n, c, groups, layout)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    err = _build.load_library().vmv_group_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        layout.sample_stride, layout.run_stride, n, c, groups, layout.runs,
        layout.per_channel, float(eps), int(silu), plan.cluster, plan.slice_vecs,
        plan.res_vecs, plan.threads, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "vmv_group_norm_fwd")
    profiling.count("launch.group_norm", shape=_shape_key(x, silu))
    return out


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
               eps: float, silu: bool = False) -> torch.Tensor:
    """x [N, C, ...] → the same shape, contiguous: the CUDA kernel on a CUDA
    tensor (raises where it does not take the shape or the dtypes), the
    plain twin on a CPU tensor. No gradient: the gate keeps autograd on the
    plain path."""
    if not x.is_cuda:
        return group_norm_reference(x, weight, bias, groups, eps, silu)
    return _launch(x, weight, bias, groups, eps, silu)
