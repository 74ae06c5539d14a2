"""The served UNet's forward replayed as CUDA graphs (``models/graphed.py``).

On the CPU the graphs are ``RerunGraph``, a stand-in for ``CudaGraph``
handed to ``GraphedForward``'s constructor: its replay runs the captured
forward again on the static input buffers and writes the static output, as
a CUDA graph does, so an input that is not copied in or an output that is
handed out without a copy changes the results. The tests hold tiny T2V and
I2V samples (plain and refined) through the graphs equal to the eager ones,
and check the eager fallbacks, one capture a signature, fresh outputs, the
UNet's hooks, the launch counters by kernel and shape, the new counters and
the benchmark's reader of them. The ``gpu`` test does the same with real
CUDA graphs on the card; from the repository root there (the test tree's
conftest imports JAX, which the card machine does not have):

    python -m pytest tests/test_torch_unet_graph.py -m gpu --noconftest -q
"""

import contextlib
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.distributed.device_mesh

from videomv_tpu_torch import ops
from videomv_tpu_torch.config import load_inference_config
from videomv_tpu_torch.models import graphed
from videomv_tpu_torch.models.blocks import SpatialTransformer, TemporalTransformer
from videomv_tpu_torch.models.graphed import CudaGraph, GraphedForward
from videomv_tpu_torch.training.checkpoints import init_models
from videomv_tpu_torch.utils import profiling

torch.set_num_threads(2)  # the suite runs under several workers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T2V_CFG = os.path.join(REPO, "configs", "t2v_infer_tiny.yaml")
I2V_CFG = os.path.join(REPO, "configs", "i2vgen_xl_infer_tiny.yaml")
IMAGE = os.path.join(REPO, "data", "images", "test_obj.png")
STEPS = 4
# 32², 8 views, the refine at loop index 2, small towers (context width 64)
OPTS = ["sampling_dtype", "float32", "resolution", "[32, 32]", "UNet.context_dim", "64",
        "UNet.use_lgm_refine", "True", "gs_refine_uncond", "shared", "gs_refine_steps", "[2]",
        "gs_refine_views", "[0, 2, 4, 6]", "gs_input_size", "32", "gs_render_size", "32"]
SMALL_TEXT = dict(width=64, heads=2, layers=3)
SMALL_VISION = dict(image_size=224, patch_size=14, width=64, heads=2, layers=2, embed_dim=1024)
SMALL_VAE = dict(ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=1)
SMALL_LGM = dict(input_size=32, down_channels=(32, 64), down_attention=(False, True),
                 mid_attention=True, up_channels=(64, 32), up_attention=(True, False),
                 splat_size=32, output_size=32, num_views=8, num_input_views=4)
COUNTERS = ("unet.forwards", "unet.graph_captures", "unet.graph_replays")


class RerunGraph:
    """``CudaGraph``'s stand-in on the CPU (module docstring). A replay runs
    no host code of the forward, so the counts of the rerun are taken back."""

    pools = []  # the pool each capture was handed

    @staticmethod
    def takes(x):
        return True

    @staticmethod
    def side_stream(device):
        return None

    @staticmethod
    def warm_up(fn, stream):
        return fn()

    def capture(self, fn, pool, stream):
        RerunGraph.pools.append(pool)
        self.fn, self.pool = fn, pool if pool is not None else object()
        self.out = fn()
        return self.out

    def replay(self):
        before = profiling.snapshot()
        new = self.fn()
        profiling.add_counts({k: -n for k, n in profiling.counts_since(before).items()})
        self.out.copy_(new)


@contextlib.contextmanager
def small_models(lgm_size):
    """The pipeline modules build small towers, VAE and LGM."""
    from videomv_tpu_torch.inference import i2v as ti2v
    from videomv_tpu_torch.inference import pipeline
    from videomv_tpu_torch.models import (AutoencoderKL, CLIPTextTower, CLIPVisionTower,
                                          OpenCLIPTextVisual)
    from videomv_tpu_torch.models.lgm import LGM, LGMOptions

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "CLIPTextTower", functools.partial(CLIPTextTower, **SMALL_TEXT))
        mp.setattr(pipeline, "AutoencoderKL", functools.partial(AutoencoderKL, **SMALL_VAE))
        lgm = dict(SMALL_LGM, **{k: lgm_size for k in ("input_size", "splat_size",
                                                       "output_size")})
        mp.setattr(pipeline, "LGM", lambda opt: LGM(LGMOptions(**lgm)))
        mp.setattr(ti2v, "OpenCLIPTextVisual", lambda: OpenCLIPTextVisual(
            visual=CLIPVisionTower(**SMALL_VISION), embed_dim=64, **SMALL_TEXT))
        yield


def _pipeline(i2v, device="cpu", opts=OPTS, lgm_size=32):
    from videomv_tpu_torch.inference import I2VPipeline, T2VPipeline

    with small_models(lgm_size):
        cls = I2VPipeline if i2v else T2VPipeline
        pipe = cls(load_inference_config(I2V_CFG if i2v else T2V_CFG, opts=opts), device=device)
    # no zero-init layer: the output convolution would zero every eps
    init_models([(m, 60 + i) for i, m in enumerate(pipe.models.values())], zero_init=False,
                device=pipe.device)
    pipe._finalize()
    return pipe


@pytest.fixture(scope="module")
def t2v():
    return _pipeline(False)


@pytest.fixture(scope="module")
def i2v():
    return _pipeline(True)


def _request(pipe, refine, seed=3):
    if hasattr(pipe, "generate_from_image"):
        return pipe.generate_from_image(IMAGE, steps=STEPS, use_gs_refine=refine, seed=seed)
    return pipe.generate("a wooden chair", steps=STEPS, use_gs_refine=refine, seed=seed)


def _counters():
    c = profiling.counts()
    return {k: c.get(k, 0) for k in COUNTERS}


def _inputs(unet, rows=2, seed=0):
    """A CFG-shaped call of the tiny T2V UNet: ``(x, t)`` and its keywords."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, 4, 8, 4, 4), generator=gen)
    t = torch.full((rows,), 500 + seed, dtype=torch.long)
    kw = dict(y=torch.randn((rows, 77, unet.context_dim), generator=gen),
              camera_data=torch.randn((rows, 8, 16), generator=gen))
    return x, t, kw


@pytest.fixture()
def unet(t2v):
    """The T2V pipeline's UNet with the stand-in graphs; restored after."""
    saved = t2v.unet.graphs
    t2v.unet.graphs = GraphedForward(RerunGraph)
    yield t2v.unet
    t2v.unet.graphs = saved
    t2v.unet.eval()


@contextlib.contextmanager
def _shard(mp):
    mp.setattr(graphed, "current_frame_shard", lambda: object())
    yield


@pytest.mark.parametrize("case", ["cpu_tensors", "grad", "train_mode", "frame_shard",
                                  "autocast"])
def test_eager_fallbacks(unet, case, monkeypatch):
    x, t, kw = _inputs(unet)
    want = unet._forward(x, t, fps=None, zero_y=None, video_mask=None, focus_present_mask=None,
                         **kw)
    if case == "cpu_tensors":  # the real graphs take CUDA tensors only
        unet.graphs = GraphedForward()
    ctx = {"grad": torch.enable_grad, "autocast": lambda: torch.autocast("cpu"),
           "frame_shard": lambda: _shard(monkeypatch)}.get(case, contextlib.nullcontext)
    if case == "train_mode":
        unet.train()
    before = _counters()
    with ctx(), contextlib.ExitStack() as stack:
        if case != "grad":
            stack.enter_context(torch.no_grad())
        outs = [unet(x, t, **kw) for _ in range(3)]
    after = _counters()
    assert after["unet.forwards"] - before["unet.forwards"] == 3
    assert after["unet.graph_captures"] == before["unet.graph_captures"]
    assert after["unet.graph_replays"] == before["unet.graph_replays"]
    assert unet.graphs._graphs == {} and unet.graphs._warm == set()
    if case not in ("train_mode", "autocast"):  # dropout; bf16 products
        for out in outs:
            torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_one_capture_per_signature_and_a_new_graph_for_new_rows(unet):
    RerunGraph.pools.clear()
    before = _counters()
    with torch.no_grad():
        for rows, seeds in ((2, (0, 1, 2, 3)), (1, (4, 5, 6))):
            for seed in seeds:
                x, t, kw = _inputs(unet, rows, seed)
                want = unet._forward(x, t, fps=None, zero_y=None, video_mask=None,
                                     focus_present_mask=None, **kw)
                torch.testing.assert_close(unet(x, t, **kw), want, rtol=0, atol=0)
    got = {k: v - before[k] for k, v in _counters().items()}
    # per signature: a warm-up, a capture (replayed at once), then replays
    assert got == {"unet.forwards": 7, "unet.graph_captures": 2, "unet.graph_replays": 5}
    assert len(unet.graphs._graphs) == 2
    first, second = RerunGraph.pools
    assert first is None and second is not None  # the second shares the first's pool
    assert second is next(iter(unet.graphs._graphs.values()))[0].pool


def test_each_call_returns_a_fresh_tensor(unet):
    with torch.no_grad():
        for seed in (0, 1):  # warm-up, capture
            x, t, kw = _inputs(unet, seed=seed)
            unet(x, t, **kw)
        x, t, kw = _inputs(unet, seed=2)
        a = unet(x, t, **kw)
        a_copy = a.clone()
        x2, t2, kw2 = _inputs(unet, seed=3)
        b = unet(x2, t2, **kw2)
    assert a.data_ptr() != b.data_ptr()
    static_out = next(iter(unet.graphs._graphs.values()))[2]
    assert static_out.data_ptr() not in (a.data_ptr(), b.data_ptr())
    torch.testing.assert_close(a, a_copy, rtol=0, atol=0)
    assert not torch.equal(a, b)


def test_hooks_fire_once_per_call_with_the_callers_x_and_t(unet):
    seen = []
    hooks = [unet.register_forward_pre_hook(
                 lambda m, args, kw: seen.append(("pre", args[0], args[1])), with_kwargs=True),
             unet.register_forward_hook(
                 lambda m, args, kw, out: seen.append(("post", args[0], out)), with_kwargs=True)]
    calls = []
    try:
        with torch.no_grad():
            for seed in range(4):
                x, t, kw = _inputs(unet, seed=seed)
                calls.append((x, t, unet(x, t, **kw)))
    finally:
        for h in hooks:
            h.remove()
    assert [s[0] for s in seen] == ["pre", "post"] * 4
    for i, (x, t, out) in enumerate(calls):
        assert seen[2 * i][1] is x and seen[2 * i][2] is t
        assert seen[2 * i + 1][1] is x and seen[2 * i + 1][2] is out


def _count_launches(unet):
    """Forward hooks on the UNet's transformers that count as the kernels'
    wrappers do on the card (by kernel and shape): on the CPU no kernel runs."""
    def spatial(m, args, out):
        profiling.count("launch.flash_attention", shape=tuple(out.shape))

    def temporal(m, args, out):
        profiling.count("launch.geglu_ffn", shape=tuple(out.shape[:2]))
    return ([m.register_forward_hook(spatial) for m in unet.modules()
             if isinstance(m, SpatialTransformer)]
            + [m.register_forward_hook(temporal) for m in unet.modules()
               if isinstance(m, TemporalTransformer)])


@pytest.mark.parametrize("kind", ["t2v", "i2v"])
@pytest.mark.parametrize("refine", [False, True], ids=["plain", "refined"])
def test_tiny_sample_through_the_graphs_equals_the_eager_one(kind, refine, request):
    """A request replayed from the graphs gives the eager request's latents
    and frames, its launch counts by kernel and by shape, and a forward
    count that the graphs served wholly."""
    pipe = request.getfixturevalue(kind)
    saved = pipe.unet.graphs
    hooks = _count_launches(pipe.unet)
    try:
        pipe.unet.graphs = None
        ops.reset_launch_counts()
        eager = _request(pipe, refine)
        eager_counts = (ops.launch_counts(), ops.launch_counts_by_shape())
        pipe.unet.graphs = GraphedForward(RerunGraph)
        for seed in (8, 9):  # warm up and capture each signature (one refine a request)
            _request(pipe, refine, seed=seed)
        assert len(pipe.unet.graphs._graphs) == (2 if refine else 1)
        ops.reset_launch_counts()
        before = _counters()
        graphs = _request(pipe, refine)
        got = {k: v - before[k] for k, v in _counters().items()}
        graphed_counts = (ops.launch_counts(), ops.launch_counts_by_shape())
    finally:
        for h in hooks:
            h.remove()
        pipe.unet.graphs = saved
    np.testing.assert_array_equal(graphs["latents"], eager["latents"])
    np.testing.assert_array_equal(graphs["frames"], eager["frames"])
    assert graphed_counts == eager_counts and sum(eager_counts[0].values()) > 0
    assert got == {"unet.forwards": STEPS, "unet.graph_captures": 0,
                   "unet.graph_replays": STEPS}


def test_counts_since_and_add_counts_replay_what_was_counted():
    profiling.reset_counts(["t.a", "t.b"])
    before = profiling.snapshot()
    profiling.count("t.a", 2, shape=(1, 2))
    profiling.count("t.a", shape=(3,))
    profiling.count("t.b")
    delta = profiling.counts_since(before)
    assert delta == {("t.a", None): 3, ("t.a", (1, 2)): 2, ("t.a", (3,)): 1, ("t.b", None): 1}
    profiling.add_counts(delta)
    profiling.add_counts(delta)
    assert profiling.counts()["t.a"] == 9 and profiling.counts()["t.b"] == 3
    assert profiling.counts_by_shape("t.a") == {(1, 2): 6, (3,): 3}
    profiling.reset_counts(["t.a", "t.b"])


def test_a_serving_pipeline_gives_its_unet_fresh_graphs(t2v, monkeypatch):
    first = t2v.unet.graphs
    assert isinstance(first, GraphedForward) and first._graph_cls is CudaGraph
    t2v._finalize()
    assert isinstance(t2v.unet.graphs, GraphedForward) and t2v.unet.graphs is not first
    from videomv_tpu_torch.inference import pipeline

    # a pipeline whose serving_tp cut the UNet's heads drops them
    monkeypatch.setattr(pipeline, "place_params_tp", lambda mesh, unet, head_dim: 1)
    monkeypatch.setattr(pipeline, "in_mesh", lambda mesh: True)
    monkeypatch.setattr(pipeline, "world_size", lambda: 2)
    monkeypatch.setattr(torch.distributed.device_mesh, "DeviceMesh", lambda *a, **k: object())
    saved = t2v.unet.graphs
    t2v.cfg.serving_tp = 2
    try:
        t2v._sp_mesh, t2v._sp_tried = None, False
        t2v._serving_mesh()
        assert t2v._tp_cut and t2v.unet.graphs is None
    finally:
        t2v.cfg.serving_tp = 1
        t2v._sp_mesh, t2v._sp_tried, t2v._tp_cut = None, False, False
        t2v.unet.graphs = saved


def _reader(name):
    path = os.path.join(REPO, "mvbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_benchmarks_replay_share_reads_the_first_request(t2v, monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    read = _reader("sampler.graph_replay_pct.serve")
    saved = t2v.unet.graphs
    profiling.clear()
    try:
        t2v.unet.graphs = GraphedForward(RerunGraph)
        profiling.enable()
        _request(t2v, True)  # the first request recorded: a warm-up and a capture a signature
        _request(t2v, True)
    finally:
        profiling.enable(False)
        t2v.unet.graphs = saved
    # 4 forwards: the CFG signature's warm-up, capture, replay and the refine's warm-up
    assert read({}) == pytest.approx(100.0 * 2 / STEPS)
    profiling.clear()
    assert read({}) is None  # nothing recorded: no reading, no error
    profiling.enable()
    try:
        _request(t2v, False)
    finally:
        profiling.enable(False)
    assert read({}) == 0.0  # the pipeline's own graphs take CUDA tensors only
    profiling.clear()


@pytest.mark.gpu
def test_graphs_on_the_card_replay_the_eager_sample_bit_for_bit():
    """Real CUDA graphs at a tiny size that reaches kernels 1 and 2 (head
    size 64, bf16): latents bit-equal to the eager loop's, and the launches
    by shape equal, plain and refined."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # 128²: 256 tokens at the top level (kernel 1), 4096 FFN rows (kernel 2)
    opts = OPTS + ["UNet.head_dim", "64", "UNet.dim", "128", "resolution", "[128, 128]",
                   "gs_input_size", "128", "gs_render_size", "128"]
    opts[opts.index("sampling_dtype") + 1] = "bfloat16"
    pipe = _pipeline(False, device="cuda", opts=opts, lgm_size=128)
    for refine in (False, True):
        pipe.unet.graphs = None
        ops.reset_launch_counts()
        eager = _request(pipe, refine)
        eager_counts = ops.launch_counts_by_shape()
        pipe.unet.graphs = GraphedForward()
        for seed in (8, 9):
            _request(pipe, refine, seed=seed)
        ops.reset_launch_counts()
        before = _counters()
        graphs = _request(pipe, refine)
        got = {k: v - before[k] for k, v in _counters().items()}
        assert ops.launch_counts_by_shape() == eager_counts
        assert sum(ops.launch_counts().values()) > 0
        assert got["unet.graph_replays"] == got["unet.forwards"] == STEPS
        np.testing.assert_array_equal(graphs["latents"], eager["latents"])
