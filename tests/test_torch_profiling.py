"""The port's spans and counters (``videomv_tpu_torch/utils/profiling.py``):
a tiny refined T2V request on the CPU records nothing while tracing is off,
and under a CPU ``torch.profiler`` records the span tree of the request (the
encodes, every DDIM step and its CFG forward, the refine's five stages, the
decode, the copies to the host) with one request id; the render's pair
counters; ``idle_by_span`` on a synthetic event list; the bound of the
deque; the CLI's ``--trace``; and the benchmark's eight readers of these
spans (``mvbench/metrics/*_dev_ms.serve.py``), loaded by path."""

import contextlib
import functools
import importlib.util
import json
import logging
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import set_torch_threads
from videomv_tpu_torch.config import load_inference_config
from videomv_tpu_torch.utils import profiling

set_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "t2v_infer_tiny.yaml")
STEPS, REFINE_AT = 4, (2,)
# the tiny config at 32² with the refine, a small text tower, VAE and LGM
OPTS = ["sampling_dtype", "float32", "resolution", "[32, 32]", "UNet.context_dim", "64",
        "UNet.use_lgm_refine", "True", "gs_refine_uncond", "shared",
        "gs_refine_steps", str(list(REFINE_AT)), "gs_refine_views", "[0, 2, 4, 6]",
        "gs_input_size", "32", "gs_render_size", "32"]
SMALL_CLIP = dict(width=64, heads=2, layers=3)
SMALL_VAE = dict(ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=1)
SMALL_LGM = dict(input_size=32, down_channels=(32, 64), down_attention=(False, True),
                 mid_attention=True, up_channels=(64, 32), up_attention=(True, False),
                 splat_size=32, output_size=32, num_views=8, num_input_views=4)
REFINE_STAGES = ["refine.unet", "refine.decode_views", "refine.lgm", "refine.render",
                 "refine.encode"]
READERS = ["pipeline.encode_dev_ms.serve", "pipeline.decode_dev_ms.serve",
           "sampler.forward_dev_ms.serve", "sampler.step_dev_ms.serve",
           "refine.unet_dev_ms.serve", "refine.lgm_dev_ms.serve", "refine.render_dev_ms.serve",
           "refine.encode_dev_ms.serve"]


@contextlib.contextmanager
def small_models():
    """The pipeline module builds the small text tower, VAE and LGM."""
    from videomv_tpu_torch.inference import pipeline
    from videomv_tpu_torch.models import AutoencoderKL, CLIPTextTower
    from videomv_tpu_torch.models.lgm import LGM, LGMOptions

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "CLIPTextTower", functools.partial(CLIPTextTower, **SMALL_CLIP))
        mp.setattr(pipeline, "AutoencoderKL", functools.partial(AutoencoderKL, **SMALL_VAE))
        mp.setattr(pipeline, "LGM", lambda opt: LGM(LGMOptions(**SMALL_LGM)))
        yield


@pytest.fixture(autouse=True)
def fresh_records():
    profiling.enable(False)
    profiling.clear()
    yield
    profiling.enable(False)
    profiling.clear()


@pytest.fixture(scope="module")
def pipe():
    from videomv_tpu_torch.inference import T2VPipeline

    with small_models():
        p = T2VPipeline(load_inference_config(TINY_CFG, opts=OPTS), device="cpu")
    p.init_params(load=False)
    return p


def _request(pipe, seed=3):
    return pipe.generate("a wooden chair", steps=STEPS, use_gs_refine=True, seed=seed)


@pytest.fixture(scope="module")
def traced(pipe):
    """One refined request under a CPU profiler: its record and the run."""
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _request(pipe)
    (record,) = profiling.requests()
    return record, profiling._events(prof)


def test_tracing_off_makes_no_event_range_or_record(pipe, monkeypatch):
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name, *a: made.append(name))
    monkeypatch.setattr(profiling, "_event", lambda: made.append("event"))
    before = profiling.counts().get("requests", 0)
    assert not profiling.active()
    out = _request(pipe)
    assert made == [] and profiling.requests() == []
    assert profiling.counts()["requests"] == before + 1  # host counters stay on
    assert out["frames"].shape == (8, 32, 32, 3) and np.isfinite(out["latents"]).all()


def test_span_tree_under_the_cpu_profiler(traced):
    record, _ = traced
    spans = record["spans"]
    names = [s["name"] for s in spans]
    assert spans[0]["name"] == "pipeline.request" and spans[0]["parent"] == -1
    assert all(s["request"] == record["id"] for s in spans)
    top = [s["name"] for s in spans if s["parent"] == 0]
    assert top[0] == "pipeline.encode.text"
    assert top[-2:] == ["pipeline.decode", "pipeline.to_host"]
    steps = [i for i, s in enumerate(spans) if s["name"] == "sampler.step"]
    assert [spans[i]["attrs"] for i in steps] == [
        {"index": i, "refine": i in REFINE_AT} for i in range(STEPS)]
    assert all(spans[i]["parent"] == 0 for i in steps)
    for i in steps:
        kids = [s["name"] for s in spans if s["parent"] == i]
        assert kids == (["refine"] if spans[i]["attrs"]["refine"] else ["sampler.forward"])
    refines = [i for i, n in enumerate(names) if n == "refine"]
    assert len(refines) == len(REFINE_AT)
    for i in refines:
        assert [s["name"] for s in spans if s["parent"] == i] == REFINE_STAGES
    for s in spans:  # on the CPU a span's device time is its host time
        assert s["end_ns"] >= s["start_ns"] and s["dev_ms"] == s["host_ms"] >= 0
    c = record["counts"]
    assert (c["requests"], c["sampler.steps"], c["sampler.forwards"], c["refine.calls"]) == (
        1, STEPS, STEPS - len(REFINE_AT), len(REFINE_AT))
    assert profiling.summarize(record)["sampler.step"]["n"] == STEPS


def test_span_names_sit_on_the_profilers_clock_inside_the_request(traced):
    record, events = traced
    ranges = [e for e in events if e.annotation and not e.on_device]
    (root,) = [e for e in ranges if e.name == "pipeline.request"]
    inside = {e.name for e in ranges if root.start_us <= e.start_us <= e.end_us <= root.end_us}
    assert {s["name"] for s in record["spans"]} <= inside | {"pipeline.request"}


def test_pair_counters_are_read_with_the_request():
    from videomv_tpu_torch.data.cameras import GSCameraSettings, orbit_c2w_opengl, \
        prepare_gs_training
    from videomv_tpu_torch.ops import splat

    gen = torch.Generator().manual_seed(0)
    n = 512
    gauss = torch.cat([torch.rand((1, n, 3), generator=gen) - 0.5,
                       torch.full((1, n, 1), 0.8),
                       torch.full((1, n, 3), 0.05), torch.tensor([1.0, 0, 0, 0]).expand(1, n, 4),
                       torch.rand((1, n, 3), generator=gen)], dim=-1)
    gs = prepare_gs_training(orbit_c2w_opengl(3, 15.0, 2.0),
                             GSCameraSettings(input_size=32, output_size=32), ray_size=32)
    cv, cvp = (torch.as_tensor(gs[k]) for k in ("cam_view", "cam_view_proj"))
    cap = 600

    def render():
        return splat.rasterize_binned_batch(gauss, cv, cvp, 32, 0.36, torch.full((3,), 0.5),
                                            max_pairs=cap, packed=True)

    render()  # off: not counted
    profiling.enable()
    with profiling.request("test.request"):
        render()
    counts = profiling.requests()[0]["counts"]
    proj = splat.project_prepared({k: v[:, None] for k, v in
                                   splat.prepare_gaussians(gauss).items()}, cv, cvp, 32, 0.36)
    pairs = splat.bin_pairs(*[p.reshape(3, *p.shape[2:]) for p in proj], img_size=32,
                            max_pairs=cap)[3]
    assert counts["splat.pairs_demanded"] == int(pairs.sum()) > 3 * cap  # some dropped
    assert counts["splat.pairs_kept"] == int(pairs.clamp(max=cap).sum())
    assert "launch.splat_composite" not in counts  # the twin ran, no kernel


def test_idle_by_span_charges_each_gap_to_the_launching_span():
    E = profiling.Event
    events = [
        E("pipeline.request", 0, 100, False, True, 0),
        E("a", 10, 40, False, True, 0), E("a.inner", 10, 20, False, True, 0),
        E("b", 50, 90, False, True, 0),
        E("not a span", 41, 45, False, True, 0),
        E("cudaLaunchKernel", 2, 3, False, False, 1),
        E("cudaLaunchKernel", 25, 26, False, False, 2),
        E("cudaMemcpyAsync", 12, 13, False, False, 4),
        E("aten::mm", 45, 46, False, False, 3),  # not a launch: its id is no CUDA id
        E("early", -20, -10, True, False, 9),      # before the window
        E("k1", 5, 20, True, False, 1), E("k2", 30, 35, True, False, 2),
        E("k2b", 32, 36, True, False, 0),          # overlaps k2
        E("k4", 37, 38, True, False, 4),
        E("k3", 60, 70, True, False, 3),           # launch not found: the gap's end
        E("a.inner", 60, 61, True, True, 0),       # a range drawn on the device's row
    ]
    idle = profiling.idle_by_span(events, names={"pipeline.request", "a", "a.inner", "b"})
    us = {k: round(v * 1e6, 6) for k, v in idle.items()}
    # [0, 5) launched at 2 (the request); [20, 30) at 25 (a); [36, 37) at 12
    # (a.inner: the innermost of a and a.inner, which began together);
    # [38, 60) at 60 (b); [70, 100) at the window's end (the request)
    assert us == {"pipeline.request": 35.0, "b": 22.0, "a": 10.0, "a.inner": 1.0}
    assert list(idle) == ["pipeline.request", "b", "a", "a.inner"]
    assert profiling.idle_by_span([E("x", 0, 1, False, True, 0)], names={"x"}) == {}


def test_the_deque_keeps_the_last_requests():
    profiling.enable()
    ids = []
    for _ in range(profiling.KEEP + 6):
        with profiling.request("test.request"):
            with profiling.span("test.span", k=1):
                pass
        ids.append(profiling._REQUESTS[-1].id)
    recs = profiling.requests()
    assert len(recs) == profiling.KEEP and [r["id"] for r in recs] == ids[-profiling.KEEP:]
    assert [s["name"] for s in recs[0]["spans"]] == ["test.request", "test.span"]
    assert recs[0]["spans"][1]["parent"] == 0 and recs[0]["spans"][1]["attrs"] == {"k": 1}
    with profiling.request("outer"):
        with profiling.request("inner"):  # inside a request: a plain span
            pass
    assert [s["name"] for s in profiling.requests()[-1]["spans"]] == ["outer", "inner"]


def test_counts_from_many_threads_lose_no_update():
    import sys
    import threading

    profiling.reset_counts(["test.threads"])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [profiling.count("test.threads", shape=(1,))
                                                    for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counts()["test.threads"] == 16 * 2000
    assert profiling.counts_by_shape("test.threads") == {(1,): 16 * 2000}
    profiling.reset_counts(["test.threads"])


def _reader(name):
    path = os.path.join(REPO, "mvbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"mvbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_the_benchmarks_span_readers_read_the_first_request(pipe, monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    profiling.enable()
    _request(pipe, seed=5)
    _request(pipe, seed=6)  # a later request: not read
    first = profiling.requests()[0]
    ms = {}
    for s in first["spans"]:
        ms.setdefault(s["name"], []).append(s["dev_ms"])
    plain = [s["dev_ms"] for s in first["spans"]
             if s["name"] == "sampler.step" and not s["attrs"]["refine"]]
    want = {"pipeline.encode_dev_ms.serve": sum(ms["pipeline.encode.text"]),
            "pipeline.decode_dev_ms.serve": sum(ms["pipeline.decode"]),
            "sampler.forward_dev_ms.serve": np.mean(ms["sampler.forward"]),
            "sampler.step_dev_ms.serve": np.mean(plain),
            "refine.unet_dev_ms.serve": np.mean(ms["refine.unet"]),
            "refine.lgm_dev_ms.serve": np.mean(ms["refine.lgm"]),
            "refine.render_dev_ms.serve": np.mean(ms["refine.render"]),
            "refine.encode_dev_ms.serve": np.mean(ms["refine.encode"])}
    for name in READERS:
        got = _reader(name)({})
        assert got is not None and got > 0, name
        assert got == pytest.approx(want[name], rel=1e-12), name
    profiling.clear()  # a program that recorded nothing: no reading, no error
    assert all(_reader(name)({}) is None for name in READERS)
    names = [m["name"] for m in json.load(open(os.path.join(REPO, "BENCHMARK.json")))["per_layer"]]
    assert set(READERS) <= set(names)


def test_cli_trace_logs_each_request_and_writes_the_first_items_trace(tmp_path, monkeypatch,
                                                                      caplog):
    from videomv_tpu_torch.inference.__main__ import main

    monkeypatch.chdir(REPO)
    with small_models(), caplog.at_level(logging.INFO):
        written = main(["--cfg", TINY_CFG, "--debug", "--device", "cpu",
                        "--trace", str(tmp_path / "trace"), *OPTS, "ddim_timesteps", str(STEPS),
                        "log_dir", str(tmp_path / "out")])
    assert len(written) == 2
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    lines = [r.getMessage() for r in caplog.records]
    per_request = [ln for ln in lines if ln.startswith("request ")]
    assert len(per_request) == 2 and f"sampler.forward x{STEPS}" in per_request[0]
    assert "refine x1" in per_request[1] and "no render" in per_request[1]  # dense on the CPU
    assert any(ln.startswith("trace of the first item") and "idle device seconds" in ln
               for ln in lines)
