"""Stable Video 3D (``sv3d_p``) in the port against the plain fp32 reference
``tests/reference_sv3d.py`` on the CPU at tiny sizes, with seeded non-zero
weights: the VideoUNet's forward, a 3-step Euler sample under the triangle
guidance, the camera vector, the tiny YAML through the CLI entry against the
reference's frames; the benchmark's copy of the reference
(``mvbench/reference/sv3d.py``) equal to this one; and kernel 1's gate, which
may admit no shape that the kernel's input check refuses. A ``gpu`` test
holds one graphed Euler step of the full-width model bit-equal to the eager
one."""

import os

import numpy as np
import pytest
import torch

import reference_sv3d as ref
from torch_port_helpers import set_torch_threads
from videomv_tpu_torch.config import load_inference_config
from videomv_tpu_torch.diffusion.edm import (GuidedDenoiser, edm_sigmas, euler_sample_loop,
                                             triangle_scale)
from videomv_tpu_torch.inference import sv3d
from videomv_tpu_torch.models.unet_sv3d import VideoUNet
from videomv_tpu_torch.ops import flash_attention as fa
from videomv_tpu_torch.ops.attention import attention_eligible

set_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "videomv_tpu_torch", "configs", "sv3d_p_infer_tiny.yaml")
IMAGE = os.path.join(REPO, "data", "images", "test_obj.png")
TINY = dict(in_channels=8, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(1, 2), channel_mult=(1, 2), num_head_channels=16,
            context_dim=24, adm_in_channels=1280, num_frames=5)
# both sides fp32 on the CPU, the same operations in other orders and
# groupings (exp vs pow frequencies, 5-D vs 4-D blends): a forward agrees to
# ~1e-6 of its largest entry; 1e-4 leaves room for the reductions' order
FWD_TOL = 1e-4
# three Euler steps from σ = 700: each step's D enters the next step's state,
# and the last step returns D itself (σ_min → 0), so per-step differences
# compound once per step; still far below a one-step or guidance fault (≥ 0.1)
SAMPLE_TOL = 1e-3


def _seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Non-zero weights for every parameter (zero-init layers too), as the
    benchmark seeds them: fan-in scaled normals, norm scales 1 + 0.1·n."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            n = torch.randn(p.shape, generator=gen)
            if p.dim() >= 2:
                p.copy_(n * np.prod(p.shape[1:]) ** -0.5)
            elif name.endswith("weight"):
                p.copy_(1 + 0.1 * n)
            else:
                p.copy_(0.1 * n)
    return module.eval()


def _rel(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.fixture(scope="module")
def tiny_unet():
    return _seeded(VideoUNet(**TINY), 0)


def _inputs(seed: int, t: int = 5, hw: int = 16, ctx: int = 24):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(2 * t, 8, hw, hw, generator=gen), torch.randn(2 * t, generator=gen),
            torch.randn(2 * t, 1, ctx, generator=gen), torch.randn(2 * t, 1280, generator=gen))


def test_video_unet_matches_the_reference(tiny_unet):
    x, t, ctx, y = _inputs(1)
    with torch.no_grad():
        got = tiny_unet(x, t, ctx, y)
    want = ref.unet(tiny_unet.state_dict(), x, t, ctx, y, frames=5, head=16)
    assert got.shape == (10, 4, 16, 16)
    assert _rel(got, want) <= FWD_TOL


def test_euler_sample_with_triangle_guidance_matches_the_reference(tiny_unet):
    gen = torch.Generator().manual_seed(2)
    noise = torch.randn(5, 4, 16, 16, generator=gen)
    token, latent = torch.randn(1, 1, 24, generator=gen), torch.randn(1, 4, 16, 16, generator=gen)
    vector = sv3d.camera_vector(1e-5, *sv3d.orbit_angles(5, [5.0, 9.0, 12.0, 7.0, 3.0]))
    sig = edm_sigmas(3)
    scale = triangle_scale(5, 2.5)
    den = GuidedDenoiser(tiny_unet, scale)
    t = 5
    context = torch.cat([token.expand(t, -1, -1), torch.zeros_like(token).expand(t, -1, -1)])
    concat = torch.cat([latent.expand(t, -1, -1, -1), torch.zeros_like(latent).expand(t, -1, -1, -1)])
    with torch.no_grad():
        got = euler_sample_loop(lambda x, s: den(x, s, context=context, concat=concat,
                                                 y=torch.cat([vector, vector])), noise, sig)
    want = ref.euler(tiny_unet.state_dict(), noise, ref.sigmas(3), token, latent, vector,
                     ref.triangle(5), head=16)
    assert _rel(got, want) <= SAMPLE_TOL


def test_schedule_guidance_and_camera_vector():
    assert np.allclose(edm_sigmas(50), ref.sigmas(50), rtol=1e-12)
    assert edm_sigmas(50)[0] == pytest.approx(700.0) and edm_sigmas(50)[-2] == pytest.approx(0.002)
    s = triangle_scale(21, 2.5)
    assert torch.allclose(s, ref.triangle(21))
    assert s[0] == s[-1] == 1.0 and s[10] == 2.5 and float(s.max()) == 2.5
    elev = [10.0 + 5 * np.sin(2 * np.pi * f / 21 + 0.3) for f in range(21)]
    pol, az = sv3d.orbit_angles(21, elev)
    assert az[-1] == 0.0 and np.allclose(np.diff(az[:-1]), 2 * np.pi / 21)
    assert np.allclose(pol, np.deg2rad(90.0 - np.asarray(elev)))
    got = sv3d.camera_vector(1e-5, pol, az)
    want = ref.camera_vector(1e-5, elev, 21)
    assert got.shape == (21, 1280)
    # the port's frequencies are 10000^(-i/half), the source's exp(-ln 10000·i/half)
    assert _rel(got, want) <= 1e-5


def test_the_benchmarks_reference_copy_equals_this_one(tiny_unet, monkeypatch):
    from mvbench.reference import sv3d as bench_ref

    m = bench_ref.VideoUNet(**TINY)
    m.load_state_dict(tiny_unet.state_dict(), strict=True)
    x, t, ctx, y = _inputs(3)
    with torch.no_grad():
        got = m.eval()(x, t, ctx, y)
    want = ref.unet(tiny_unet.state_dict(), x, t, ctx, y, frames=5, head=16)
    assert _rel(got, want) <= FWD_TOL
    assert bench_ref.sigmas(50, 0.002, 700.0, 7.0) == pytest.approx(ref.sigmas(50), rel=1e-12)
    assert torch.allclose(bench_ref.triangle(21, 2.5), ref.triangle(21))
    elev = [4.0 + f for f in range(21)]
    pol, az = bench_ref.orbit(21, elev)
    assert _rel(bench_ref.camera_vector(1e-5, pol, az, "cpu"),
                ref.camera_vector(1e-5, elev, 21)) <= 1e-6
    # the blocked attention (here 4 of the 6 (batch, head) rows a block) is one softmax
    monkeypatch.setattr(bench_ref, "ATTN_BLOCK_ROWS", 4)
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(3, 300, 2, 16, generator=gen) for _ in range(3))
    full = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.25, -1)
    assert _rel(bench_ref.attention(q, k, v), torch.einsum("bhqk,bkhd->bqhd", full, v)) <= 1e-5


def test_cli_serves_the_tiny_yaml_as_the_reference_does(tmp_path, monkeypatch):
    """``inference_sv3d_entrance`` on the tiny YAML, with non-zero seeded
    weights: the views it returns are the reference's sample and decode of
    the same image, noise and conditioning, and it writes them."""
    from mvbench.reference import nets
    from videomv_tpu_torch.inference.__main__ import main

    pipes, outs = [], []

    class Recorded(sv3d.SV3DPipeline):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            pipes.append(self)

        def init_params(self):
            for i, m in enumerate(self.models.values()):
                m.to_empty(device=self.device)
                _seeded(m, 10 + i)
            self._finalize()

        def generate_from_image(self, *a, **kw):
            outs.append(super().generate_from_image(*a, **kw))
            return outs[-1]

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sv3d, "SV3DPipeline", Recorded)
    written = main(["--cfg", TINY_CFG, "--debug", "--device", "cpu", "log_dir", str(tmp_path)])
    assert len(written) == 1 and os.path.exists(written[0])
    pipe, out = pipes[0], outs[0]
    assert out["frames"].shape == (5, 128, 128, 3) and out["frames"].dtype == np.uint8
    cfg = load_inference_config(TINY_CFG)
    # the reference: conditioning from the same file and draws, sample, decode
    sds = {n: m.state_dict() for n, m in pipe.models.items()}
    vae = nets.VAE(**cfg.models.vae)
    vae.load_state_dict(sds["vae"])
    clip = nets.CLIPVisual(**cfg.models.clip_visual)
    clip.load_state_dict(sds["clip"])
    image = pipe.load_image(IMAGE)
    noise, aug = pipe.draws(int(cfg.seed))
    with torch.no_grad():
        x224 = torch.nn.functional.interpolate((image + 1) / 2, size=(224, 224), mode="bilinear",
                                               antialias=True, align_corners=False)
        mean = torch.tensor(sv3d.VIT_MEAN).reshape(1, 3, 1, 1)
        std = torch.tensor(sv3d.VIT_STD).reshape(1, 3, 1, 1)
        token = clip((x224 - mean) / std)[:, None]
        latent = vae.encode_mode(image + 1e-5 * aug)
        vector = ref.camera_vector(1e-5, [10.0] * 5, 5)
        lat = ref.euler(sds["unet"], noise, ref.sigmas(3), token, latent, vector,
                        ref.triangle(5), head=16)
        frames = vae.decode(lat / 0.18215)
    want = torch.round((frames * 0.5 + 0.5).clamp(0, 1) * 255).permute(0, 2, 3, 1).numpy()
    assert _rel(out["latents"], lat) <= SAMPLE_TOL
    # uint8 views: a rounding boundary may fall between the two by one level
    diff = np.abs(out["frames"].astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("d", [32, 64, 128])
def test_the_attention_gate_admits_only_what_the_kernel_takes(d):
    """Over S = 256 … 1,400, with and without grad: every shape the gate
    admits passes the kernel's input check, runs on a variant that takes
    it; and at head_dim 64 outside grad every S is admitted (SV3D's 5,184,
    1,296 and 324 tokens among them)."""
    for grad in (False, True):
        for s in list(range(256, 1401)) + [5184, 1296, 324]:
            shape = (42, s, 5, d)
            admitted = attention_eligible(shape, shape, torch.bfloat16, True, grad)
            refused = fa.kernel_refuses(s, d, grad)
            assert admitted == (not refused), (shape, grad, refused)
            if admitted:
                assert fa.variant_takes(fa.attention_variant(*shape), s, d), (shape, grad)
            if d == 64 and not grad:
                assert admitted, shape
            if grad or d == 128:
                assert admitted == (d != 32 and s % 64 == 0), (shape, grad)
    # SV3D's shapes take the wgmma kernel; the 9² level (81 tokens) stays plain
    for shape in ((42, 5184, 5, 64), (42, 1296, 10, 64), (42, 324, 20, 64)):
        assert fa.attention_variant(*shape) == fa.VARIANT_WGMMA
    assert not attention_eligible((42, 81, 20, 64), (42, 81, 20, 64), torch.bfloat16, True)


@pytest.mark.parametrize("s,d,grad,takes", [
    (64, 64, False, True), (64, 128, False, True), (192, 128, False, True),   # S % 64 == 0
    (100, 64, False, False),   # ragged and shorter than one 128-key tile
    (192 + 8, 64, False, True), (200, 64, True, False), (200, 128, False, False),
    (128, 32, False, False)])
def test_the_kernels_input_rule_below_the_gate(s, d, grad, takes):
    """The rule the input check applies, which direct callers (the LGM, the
    tests) reach below the gate's 256 tokens: every S % 64 == 0 the kernels
    took before, and a ragged S only at head_dim 64 outside grad."""
    assert (not fa.kernel_refuses(s, d, grad)) == takes


@pytest.mark.gpu
def test_graphed_euler_step_is_bit_equal_to_eager():
    """One Euler step of the full-width ``sv3d_p`` model at 72² (42 CFG rows,
    bf16), served from its CUDA graph (captured at the second call, replayed
    at the third), bit-equal to the same step eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from videomv_tpu_torch import ops
    from videomv_tpu_torch.models.graphed import GraphedForward
    from videomv_tpu_torch.utils import profiling

    dev = torch.device("cuda", 0)
    unet = VideoUNet().to(dev, torch.bfloat16)
    _seeded(unet, 5).requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(21, 4, 72, 72, generator=gen, device=dev) * 50
    token = torch.randn(1, 1, 1024, generator=gen, device=dev).to(torch.bfloat16)
    latent = torch.randn(1, 4, 72, 72, generator=gen, device=dev)
    vector = sv3d.camera_vector(1e-5, *sv3d.orbit_angles(21, 10.0), dev)
    context = torch.cat([token.expand(21, -1, -1), torch.zeros_like(token).expand(21, -1, -1)])
    concat = torch.cat([latent.expand(21, -1, -1, -1),
                        torch.zeros_like(latent).expand(21, -1, -1, -1)])
    y = torch.cat([vector, vector]).to(torch.bfloat16)
    den = GuidedDenoiser(unet, triangle_scale(21, 2.5).to(dev))
    sig = edm_sigmas(50)

    def step():
        return euler_sample_loop(lambda z, s: den(z, s, context=context, concat=concat, y=y),
                                 x / (1 + sig[0] ** 2) ** 0.5, sig[:2])

    with torch.no_grad():
        unet.graphs = None
        ops.reset_launch_counts()
        eager = step()
        launches = ops.launch_counts_by_shape()
        unet.graphs = GraphedForward()
        step()
        step()  # captured
        before = profiling.counts().get("unet.graph_replays", 0)
        ops.reset_launch_counts()
        graphed = step()
        torch.cuda.synchronize()
    assert profiling.counts()["unet.graph_replays"] == before + 1
    assert ops.launch_counts_by_shape() == launches
    assert launches["flash_attention"] == {(42, 5184, 5, 64): 5, (42, 1296, 10, 64): 5,
                                           (42, 324, 20, 64): 5}
    assert torch.equal(graphed, eager)
