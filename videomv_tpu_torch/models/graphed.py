"""The served denoiser's forward, replayed as CUDA graphs.

A pipeline that serves requests (``T2VPipeline``, ``I2VPipeline``) gives its
UNet a ``GraphedForward`` (``unet.graphs``) each time it places the UNet's
weights. The UNet's ``forward`` goes through ``run_forward``, which hands
the eager body to it where a graph can engage: CUDA tensors, no autograd,
the module in eval mode, no frame shard (``parallel.infer``), no autocast.
Everywhere else (training, the frozen denoiser of the LGM-refine step,
frame-parallel and tensor-parallel serving, the CPU) the body runs eagerly,
as it is.

Each input signature (the shape, dtype and device of every tensor the
forward takes, which inputs are None, and the process settings that choose
the forward's kernels) is run once eagerly on a side stream, which builds
the kernels at first use and lets cuDNN and the allocator settle; its next
call is captured on that stream, and every later call replays the graph:
exactly the kernels the eager forward launched, with no host work between
them. The call's inputs are copied into the graph's static buffers, and the
result is a fresh copy of its static output, which the next replay
overwrites. One UNet's graphs share one memory pool: they replay one after
another on one stream, and each output is copied before another runs.
Nothing is captured while a ``torch.profiler`` records; a replay is.

A replay does not run the forward's host code, so what that code counted
(``utils.profiling``: the kernels' ``launch.<kernel>`` counters, by shape)
is taken at capture and added at each replay. ``unet.forwards`` counts every
forward, ``unet.graph_captures`` each capture and ``unet.graph_replays``
each forward a graph served.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..ops import fused_spatial
from ..parallel.infer import current_frame_shard
from ..utils import profiling

__all__ = ["CudaGraph", "GraphedForward", "run_forward"]

_profiler_enabled = torch._C._autograd._profiler_enabled


class CudaGraph:
    """A ``torch.cuda.CUDAGraph`` behind the calls that ``GraphedForward``
    makes (a test hands it a stand-in with the same methods)."""

    @staticmethod
    def takes(x: torch.Tensor) -> bool:
        return x.is_cuda

    @staticmethod
    def side_stream(device: torch.device) -> torch.cuda.Stream:
        return torch.cuda.Stream(device)

    @staticmethod
    def warm_up(fn: Callable[[], torch.Tensor], stream: torch.cuda.Stream) -> torch.Tensor:
        """``fn()`` on ``stream``, after the current stream's work and before
        its next."""
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn()
        current.wait_stream(stream)
        return out

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()
        self.pool, self.device = None, None

    def capture(self, fn: Callable[[], torch.Tensor], pool, stream: torch.cuda.Stream):
        """``fn()`` captured on ``stream`` into ``pool`` (None: a new one,
        then ``self.pool``); returns the static output."""
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
        self.pool, self.device = self.graph.pool(), stream.device
        return out

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()


def _signature(args: Dict[str, Optional[torch.Tensor]]) -> Optional[tuple]:
    """The key of one graph: each input's shape, dtype and device, or None,
    and the settings the eager forward reads to choose its kernels (the
    fused spatial block's switch, TF32 for fp32 products and convolutions).
    None where an input is neither a tensor nor None."""
    key = []
    for name, v in args.items():
        if v is None:
            key.append((name, None))
        elif isinstance(v, torch.Tensor):
            key.append((name, tuple(v.shape), v.dtype, v.device))
        else:
            return None
    key.append((fused_spatial.enabled(), torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32))
    return tuple(key)


class GraphedForward:
    """One UNet's CUDA graphs, one an input signature (module docstring).
    ``graph_cls`` makes each graph (``CudaGraph``)."""

    def __init__(self, graph_cls=CudaGraph):
        self._graph_cls = graph_cls
        self._warm: set = set()  # signatures run once eagerly
        self._graphs: Dict[tuple, tuple] = {}  # signature -> (graph, inputs, output, counts)
        self._pool = None
        self._stream = None

    def engages(self, module: torch.nn.Module, x: torch.Tensor) -> bool:
        """Whether ``module``'s forward of ``x`` may be served by a graph."""
        return (not module.training and not torch.is_grad_enabled()
                and self._graph_cls.takes(x) and current_frame_shard() is None
                and not torch.is_autocast_enabled(x.device.type))

    def __call__(self, fn: Callable[..., torch.Tensor],
                 args: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """``fn(**args)``: warmed up, captured or replayed by its signature."""
        key = _signature(args)
        if key is None:
            return fn(**args)
        entry = self._graphs.get(key)
        if entry is not None:
            graph, static, out, counted = entry
            for name, v in args.items():
                if v is not None:
                    static[name].copy_(v)
            graph.replay()
            profiling.add_counts(counted)
            profiling.count("unet.graph_replays")
            return out.clone()
        if self._stream is None:
            self._stream = self._graph_cls.side_stream(args["x"].device)
        if key not in self._warm:
            out = self._graph_cls.warm_up(lambda: fn(**args), self._stream)
            self._warm.add(key)
            return out
        if _profiler_enabled():
            return fn(**args)
        static = {name: None if v is None else v.clone() for name, v in args.items()}
        graph = self._graph_cls()
        before = profiling.snapshot()
        out = graph.capture(lambda: fn(**static), self._pool, self._stream)
        # the capture ran the host code once: its counts stand for the replay below
        counted = profiling.counts_since(before)
        self._pool = graph.pool
        self._graphs[key] = (graph, static, out, counted)
        profiling.count("unet.graph_captures")
        graph.replay()
        profiling.count("unet.graph_replays")
        return out.clone()


def run_forward(module: torch.nn.Module, fn: Callable[..., torch.Tensor],
                **args: Optional[torch.Tensor]) -> torch.Tensor:
    """``fn(**args)``, the eager body of ``module.forward``, served by
    ``module.graphs`` where a graph engages. Counts ``unet.forwards``."""
    profiling.count("unet.forwards")
    graphs = module.graphs
    if graphs is not None and graphs.engages(module, args["x"]):
        return graphs(fn, args)
    return fn(**args)
