"""Kernel 6 (GroupNorm + SiLU, ``ops/group_norm.py``) on the CPU: its plain
twin against ``nn.GroupNorm`` and ``F.silu`` on contiguous and permuted
inputs; the layouts the kernel reads and the plans that cut the served
shapes; the gate of ``models.blocks.GroupNorm`` (the kernel only for eval
mode, no autograd recording, bf16 on the card; ``gn.plain`` counting the
rest); and the UNets' and the VAE's ``state_dict`` keys, the same as with
``nn.GroupNorm`` and ``nn.Sequential``. The kernel itself is held to the
twin on the card (``tests/test_torch_gpu_kernels.py``)."""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from videomv_tpu_torch.models import autoencoder, blocks, unet_sv3d, unet_t2v
from videomv_tpu_torch.models.autoencoder import AutoencoderKL
from videomv_tpu_torch.models.unet_i2v import UNetSD_I2VGen
from videomv_tpu_torch.models.unet_sv3d import VideoUNet
from videomv_tpu_torch.models.unet_t2v import UNetSD_T2VBase
from videomv_tpu_torch.ops import group_norm as gn
from videomv_tpu_torch.parallel import collectives
from videomv_tpu_torch.utils import profiling


def _input(n, c, f, hw, permuted, dtype=torch.float32, seed=0):
    """x [n, c, f, hw, hw]: contiguous, the UNets' temporal view (a permuted
    [n·f, c, hw, hw]) or, for ``permuted="channels_last"``, channels
    innermost; a mean away from 0, so the variance is not its second
    moment."""
    g = torch.Generator().manual_seed(seed)
    if permuted == "channels_last":
        x = torch.randn(n, f, hw, hw, c, generator=g) * 1.7 + 0.6
        x = x.permute(0, 4, 1, 2, 3)
    elif permuted:
        x = torch.randn(n * f, c, hw, hw, generator=g) * 1.7 + 0.6
        x = x.reshape(n, f, c, hw, hw).permute(0, 2, 1, 3, 4)
    else:
        x = torch.randn(n, c, f, hw, hw, generator=g) * 1.7 + 0.6
    return x.to(dtype)


def _affine(c, seed=1):
    g = torch.Generator().manual_seed(seed)
    return 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("n", [1, 2, 6])
def test_twin_matches_module(n, permuted, eps, silu):
    c, groups = 64, 32
    x = _input(n, c, 3, 8, permuted)
    w, b = _affine(c)
    norm = nn.GroupNorm(groups, c, eps=eps)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
        want = norm(x)
        want = F.silu(want) if silu else want
    got = gn.group_norm_reference(x, w, b, groups, eps, silu)
    assert got.is_contiguous() and got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the op takes the twin for a CPU tensor
    assert torch.equal(gn.group_norm(x, w, b, groups, eps, silu), got)


def test_kernel_layout():
    c, f, hw = 64, 4, 8
    s = hw * hw
    lay = gn.kernel_layout(_input(2, c, f, hw, False), 32)
    assert lay == gn.Layout(1, f * s, c * f * s, 0)
    # the temporal view: F runs of (C/G)·H·W elements, C·H·W apart, read in place
    assert gn.kernel_layout(_input(2, c, f, hw, True), 32) == gn.Layout(f, s, f * c * s, c * s)
    # the temporal transformers' [B, C, F, S] view of it, and one sample
    assert (gn.kernel_layout(_input(2, c, f, hw, True).reshape(2, c, f, s), 32)
            == gn.Layout(f, s, f * c * s, c * s))
    assert gn.kernel_layout(_input(1, c, f, hw, True), 32) == gn.Layout(f, s, f * c * s, c * s)
    # spatial [N, C, H, W]
    assert gn.kernel_layout(torch.zeros(3, c, hw, hw), 32) == gn.Layout(1, s, c * s, 0)
    # what it does not read in place (made contiguous first): channels-last,
    # a spatial transpose
    for x in (torch.zeros(2, hw, hw, c).permute(0, 3, 1, 2),
              _input(2, c, f, hw, False).transpose(3, 4)):
        assert gn.kernel_layout(x, 32) is None and gn.shape_takes(x.shape, 32)
    # what it does not take: groups that do not divide C, a group of a
    # length that is not whole vectors
    for shape in ((2, 48, 4, 4), (2, 64, 3, 1)):
        assert gn.kernel_layout(torch.zeros(shape), 32) is None
        assert not gn.shape_takes(shape, 32)


def _layout(n, c, f, hw, permuted):
    s = hw * hw
    return gn.Layout(f, s, f * c * s, c * s) if permuted else gn.Layout(1, f * s, c * f * s, 0)


def _all(cs, res, threads):
    return 1


def _no_16(cs, res, threads):
    return 0 if cs == 16 else 1


# the served shapes: (N, C, F, H·W side, permuted) -> (cluster, the slice held whole)
SERVED_PLANS = [
    ((48, 320, 1, 32, False), _all, (1, True)),      # T2V spatial, 20 KB groups
    ((2, 320, 24, 32, True), _all, (16, True)),      # T2V temporal: 64 groups of 480 KB
    ((1, 320, 24, 32, True), _all, (16, True)),      # the refine's 24-row forward
    ((2, 1280, 24, 4, True), _all, (8, True)),       # T2V's 4² temporal
    ((42, 320, 1, 72, False), _all, (4, True)),      # SV3D spatial, 104 KB groups
    ((2, 320, 21, 72, True), _all, (16, False)),     # SV3D temporal: 2.2 MB a group
    ((2, 320, 21, 72, True), _no_16, (8, False)),    # ... where the card cannot place 16
    ((2, 1280, 21, 9, True), _all, (8, True)),       # SV3D's 9² temporal (P % 8 != 0)
    ((24, 128, 1, 256, False), _all, (16, True)),    # the VAE decoder at 256², C 128
    ((24, 256, 1, 256, False), _all, (16, True)),    # ... C 256: 1 MB, 64 KB a CTA
    ((14, 128, 1, 576, False), _all, (16, False)),   # ... at 576², C 128: 2.65 MB
    ((14, 256, 1, 576, False), _all, (16, False)),   # ... C 256: 5.3 MB
]


@pytest.mark.parametrize("shape,fits,want", SERVED_PLANS)
def test_plan_of_the_served_shapes(shape, fits, want):
    n, c, f, hw, permuted = shape
    layout = _layout(n, c, f, hw, permuted)
    plan = gn.group_norm_plan(n, c, 32, layout, 132, fits)
    assert (plan.cluster, plan.res_vecs == plan.slice_vecs) == want
    vecs = (c // 32) * f * hw * hw // gn.VEC
    # the cluster's slices cover the group, none is empty
    assert plan.cluster * plan.slice_vecs >= vecs > (plan.cluster - 1) * plan.slice_vecs
    assert plan.res_vecs * 16 <= max(gn.SLICE_BYTES, gn.HELD_BYTES)
    assert plan.threads in (128, 256, 512)


@pytest.fixture()
def counts():
    profiling.reset_counts(["gn.plain", "launch.group_norm"])
    yield lambda: profiling.counts_by_shape("gn.plain")
    profiling.reset_counts(["gn.plain", "launch.group_norm"])


@pytest.fixture()
def card(monkeypatch):
    """The gate as on the card, for CPU tensors: ``on_card`` holds and the
    op records its calls and runs the twin."""
    calls = []

    def op(x, weight, bias, groups, eps, silu=False):
        calls.append((tuple(x.shape), silu))
        return gn.group_norm_reference(x, weight, bias, groups, eps, silu)

    monkeypatch.setattr(gn, "on_card", lambda x: True)
    monkeypatch.setattr(blocks, "group_norm_op", op)
    return calls


def _norm(dtype=torch.bfloat16, c=64):
    norm = blocks.GroupNorm(32, c, eps=1e-6).to(dtype).eval()
    w, b = _affine(c)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    return norm


@pytest.mark.parametrize("permuted", [False, True, "channels_last"])
@pytest.mark.parametrize("silu", [False, True])
def test_gate_sends_eval_bf16_to_the_kernel(card, counts, silu, permuted):
    norm = _norm()
    x = _input(2, 64, 3, 8, permuted, torch.bfloat16)
    with torch.no_grad():
        out = norm(x, silu=silu)
    assert card == [((2, 64, 3, 8, 8), silu)] and counts() == {}
    assert torch.equal(out, gn.group_norm_reference(x, norm.weight, norm.bias, 32, 1e-6, silu))


def _plain_cases():
    def training(norm, x):
        return norm.train()(x, silu=True)

    def grad_recording(norm, x):
        return norm(x.requires_grad_(), silu=True)

    def weights_recording(norm, x):
        norm.requires_grad_(True)
        return norm(x, silu=True)

    return {"training": training, "grad_recording": grad_recording,
            "weights_recording": weights_recording}


@pytest.mark.parametrize("case", sorted(_plain_cases()))
def test_gate_sends_training_and_grad_to_the_plain_path(card, counts, case):
    norm = _norm().requires_grad_(False)
    x = _input(2, 64, 3, 8, True, torch.bfloat16)
    with torch.enable_grad():
        out = _plain_cases()[case](norm, x)
    assert card == []
    assert counts() == {(2, 64, 192, True): 1}
    ref = F.silu(F.group_norm(x.detach(), 32, norm.weight.detach(), norm.bias.detach(), 1e-6))
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)


def test_gate_sends_shapes_the_kernel_does_not_take_to_the_plain_path(card, counts):
    norm = blocks.GroupNorm(16, 48, eps=1e-6).to(torch.bfloat16).eval()
    x = torch.randn(2, 48, 3, 1).to(torch.bfloat16)  # 3 channels x 3 elements a group
    with torch.no_grad():
        out = norm(x)
    assert card == [] and counts() == {(2, 48, 3, False): 1}
    assert torch.equal(out, F.group_norm(x, 16, norm.weight, norm.bias, 1e-6))


def test_gate_sends_fp32_to_the_plain_path_uncounted(card, counts):
    norm = _norm(torch.float32)
    x = _input(2, 64, 3, 8, True)
    with torch.no_grad():
        out = norm(x, silu=True)
    assert card == [] and counts() == {}
    torch.testing.assert_close(out, F.silu(F.group_norm(x, 32, norm.weight, norm.bias, 1e-6)),
                               rtol=0, atol=0)


def test_gate_sends_cpu_bf16_to_the_plain_path(counts):
    norm = _norm()
    x = _input(2, 64, 3, 8, False, torch.bfloat16)
    with torch.no_grad():
        out = norm(x)
    assert counts() == {(2, 64, 192, False): 1}
    assert torch.equal(out, F.group_norm(x, 32, norm.weight, norm.bias, 1e-6))


def test_gate_sends_frame_sharded_to_the_plain_path(card, counts, monkeypatch):
    # one rank of a frame-sharded norm: the statistics' all-reduce over a
    # group of one is the identity
    monkeypatch.setattr(collectives, "all_reduce", lambda t, group=None: t)
    norm = _norm()
    x = _input(2, 64, 3, 8, False, torch.bfloat16).reshape(2, 64, 3, 64)
    with torch.no_grad():
        out = collectives.group_norm(norm, x, group=object())
    assert card == [] and counts() == {(2, 64, 192, False): 1}
    torch.testing.assert_close(out.float(), gn.group_norm_reference(
        x, norm.weight, norm.bias, 32, 1e-6).float(), rtol=0, atol=2e-2)


def test_norm_silu_runs_the_rest_after_the_fused_norm(card, counts):
    seq = blocks.NormSiLU(_norm(), nn.SiLU(), nn.Dropout(0.5), nn.Identity()).eval()
    x = _input(2, 64, 3, 8, True, torch.bfloat16)
    with torch.no_grad():
        out = seq(x)
    assert card == [((2, 64, 3, 8, 8), True)]
    assert torch.equal(out, gn.group_norm_reference(x, seq[0].weight, seq[0].bias, 32, 1e-6,
                                                     True))


T2V = dict(dim=64, y_dim=32, context_dim=32, dim_mult=(1, 2), num_heads=2, head_dim=32,
           num_res_blocks=1, dropout=0.0)
SV3D = dict(in_channels=8, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(1, 2), channel_mult=(1, 2), num_head_channels=16,
            context_dim=24, adm_in_channels=1280, num_frames=5)
MODELS = {"t2v": lambda: UNetSD_T2VBase(**T2V), "i2v": lambda: UNetSD_I2VGen(**T2V),
          "sv3d": lambda: VideoUNet(**SV3D),
          "vae": lambda: AutoencoderKL(ch=32, ch_mult=(1, 2), num_res_blocks=1)}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_state_dict_keys_as_with_torch_norms(name, monkeypatch):
    model = MODELS[name]()
    ours = blocks.GroupNorm
    norms = [m for m in model.modules() if isinstance(m, nn.GroupNorm)]
    assert norms and all(isinstance(m, ours) for m in norms)
    # the same model built from nn.GroupNorm and nn.Sequential
    for mod in (blocks, unet_t2v, unet_sv3d, autoencoder):
        for cls, torch_cls in (("GroupNorm", nn.GroupNorm), ("NormSiLU", nn.Sequential)):
            if hasattr(mod, cls):
                monkeypatch.setattr(mod, cls, torch_cls)
    plain = MODELS[name]()
    assert not any(isinstance(m, ours) for m in plain.modules())
    want = {k: tuple(v.shape) for k, v in plain.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    model.load_state_dict(plain.state_dict(), strict=True)


@pytest.mark.parametrize("on_kernel", [True, False])
def test_residual_keeps_nchw_on_the_kernel_path(card, on_kernel):
    norm = _norm()
    x = torch.randn(2, 64, 8, 8).to(torch.bfloat16)
    h = torch.randn(2, 8, 8, 64).to(torch.bfloat16).permute(0, 3, 1, 2)
    if not on_kernel:
        norm.train()
    with torch.no_grad():
        out = blocks.residual(x, h, norm)
    assert torch.equal(out, x + h)
    # the kernel path keeps x's NCHW layout (read in place by the next
    # norm); the plain path keeps h's, as before
    assert out.is_contiguous() == on_kernel
    assert out.is_contiguous(memory_format=torch.channels_last) == (not on_kernel)
