"""GPU-only checks of the port's CUDA kernels beyond the main path's shapes
(head_dim 128, single-tile and odd-tile sequences, token counts that are not
a tile multiple, the widest and narrowest C; the splat composite with both
payloads and an overflowing pair capacity; its backward kernel against its
twin and against autograd of the forward twin), the wrappers' input checks,
the backward of the attention and FFN wrappers, and the module dispatch. Each test needs a CUDA device and skips without
one. On the card, from the repository root (the test tree's conftest
imports JAX, which the card machine does not have):

    python -m pytest tests/test_torch_gpu_kernels.py -m gpu --noconftest -q
"""

import pytest
import torch

from videomv_tpu_torch import ops
from videomv_tpu_torch.ops.flash_attention import attention_reference, flash_attention
from videomv_tpu_torch.ops.fused_ffn import geglu_ffn, geglu_ffn_reference

pytestmark = pytest.mark.gpu

# a kernel's error against an fp32 computation may not exceed twice its
# plain twin's (both bf16) plus this
EPS = 2e-3


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(gen, dev, *shape, scale=1.0, dtype=torch.bfloat16):
    return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)


def _within_bound(kern, twin, ref32):
    k_err = (kern.float() - ref32).abs().max().item()
    t_err = (twin.float() - ref32).abs().max().item()
    return k_err <= 2 * t_err + EPS, (k_err, t_err)


@pytest.mark.parametrize("shape", [(3, 64, 2, 64), (2, 192, 3, 64), (2, 512, 4, 128),
                                   (1, 1024, 1, 128)])
def test_flash_attention_matches_fp32(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (_randn(gen, cuda, *shape) for _ in range(3))
    ops.reset_launch_counts()
    kern = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts_by_shape()["flash_attention"] == {shape: 1}
    ok, errs = _within_bound(kern, attention_reference(q, k, v),
                             attention_reference(q.float(), k.float(), v.float()))
    assert ok, errs


def test_flash_attention_rejects_what_it_cannot_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, cuda, 2, 128, 2, 64)
    with pytest.raises(ValueError):
        flash_attention(q.float(), q.float(), q.float())  # fp32
    with pytest.raises(ValueError):
        flash_attention(q[:, :100].contiguous(), q[:, :100].contiguous(),
                        q[:, :100].contiguous())  # S % 64 != 0
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :64].contiguous(), q[:, :64].contiguous())  # cross
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError):
        g = _randn(gen, cuda, 2, 128, 2, 32)
        flash_attention(g, g, g)  # head_dim 32


@pytest.mark.parametrize("t,c,inner", [(4100, 64, 256), (333, 640, 2560), (4096, 1024, 512),
                                       (97, 320, 1280)])
def test_geglu_ffn_matches_fp32(cuda, t, c, inner):
    gen = torch.Generator(device=cuda).manual_seed(t + c)
    x = _randn(gen, cuda, t, c)
    w1 = _randn(gen, cuda, 2 * inner, c, scale=c ** -0.5)
    w2 = _randn(gen, cuda, c, inner, scale=inner ** -0.5)
    b1 = _randn(gen, cuda, 2 * inner, scale=0.1, dtype=torch.float32)
    b2 = _randn(gen, cuda, c, scale=0.1, dtype=torch.float32)
    ops.reset_launch_counts()
    kern = geglu_ffn(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert ops.launch_counts()["geglu_ffn"] == 1
    assert ops.launch_counts_by_shape()["geglu_ffn"] == {(t, c, inner): 1}
    ok, errs = _within_bound(kern, geglu_ffn_reference(x, w1, b1, w2, b2),
                             geglu_ffn_reference(x.float(), w1.float(), b1, w2.float(), b2))
    assert ok, errs


def test_geglu_ffn_rejects_what_it_cannot_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = _randn(gen, cuda, 64, 96)
    w1, w2 = _randn(gen, cuda, 512, 96), _randn(gen, cuda, 96, 256)
    b1 = torch.zeros(512, device=cuda)
    b2 = torch.zeros(96, device=cuda)
    geglu_ffn(x, w1, b1, w2, b2)  # C = 96 is fine
    with pytest.raises(ValueError):
        geglu_ffn(x, w1, b1.bfloat16(), w2, b2)  # bias dtype
    with pytest.raises(ValueError):
        geglu_ffn(x[:, :90].contiguous(), w1[:, :90].contiguous(), b1,
                  w2[:90].contiguous(), b2[:90].contiguous())  # C % 16 != 0
    with pytest.raises(ValueError):
        geglu_ffn(x, w1, b1, w2[:, :200].contiguous(), b2)  # shapes disagree
    with pytest.raises(ValueError):
        geglu_ffn(x.t().contiguous().t(), w1, b1, w2, b2)  # not contiguous


def _splat_bins(dev, packed, max_pairs, n=4096, views=4, size=64):
    """A seeded scene binned for ``views`` orbit cameras at ``size``²."""
    import numpy as np

    from videomv_tpu_torch.data.cameras import (
        GSCameraSettings, orbit_c2w_opengl, prepare_gs_training)
    from videomv_tpu_torch.ops import gaussian_splat as tgs
    from videomv_tpu_torch.ops import splat

    rs = np.random.default_rng(n + views)
    quat = rs.normal(size=(n, 4))
    g = np.concatenate([rs.uniform(-0.5, 0.5, (n, 3)), rs.uniform(0.05, 1.0, (n, 1)),
                        rs.uniform(0.005, 0.03, (n, 3)),
                        quat / np.linalg.norm(quat, axis=1, keepdims=True),
                        rs.uniform(0, 1, (n, 3))], axis=1).astype(np.float32)
    st = GSCameraSettings(input_size=size, output_size=size)
    cams = prepare_gs_training(orbit_c2w_opengl(views, 15.0, 2.0), st, ray_size=8)
    prep = {k: v[None] for k, v in tgs.prepare_gaussians(torch.from_numpy(g).to(dev)).items()}
    proj = tgs.project_prepared(prep, torch.from_numpy(cams["cam_view"][0]).to(dev),
                                torch.from_numpy(cams["cam_view_proj"][0]).to(dev), size,
                                st.tan_half_fov)
    return splat.bin_pairs(*proj, img_size=size, max_pairs=max_pairs, packed=packed)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("max_pairs", [1 << 15, 2048])  # 2048 overflows
def test_splat_composite_matches_its_twin(cuda, packed, max_pairs):
    from videomv_tpu_torch.ops import splat

    payload, ts, tc, pairs = _splat_bins(cuda, packed, max_pairs)
    assert (pairs > max_pairs).all() == (max_pairs == 2048), pairs
    ops.reset_launch_counts()
    kern = splat.composite(payload, ts, tc, 4)
    torch.cuda.synchronize()
    assert ops.launch_counts()["splat_composite"] == 1
    twin = splat.composite_reference(payload, ts, tc, 4)
    assert twin[:, :, 3].max() > 0.5  # the views are covered
    # fp32 both; a running product against exp of a cumulative log sum
    assert (kern - twin).abs().max().item() <= 2e-4


def test_splat_composite_rejects_what_it_cannot_take(cuda):
    from videomv_tpu_torch.ops import splat

    payload, ts, tc, _ = _splat_bins(cuda, True, 1 << 15, views=2)
    with pytest.raises(ValueError):
        splat.composite(payload.double(), ts, tc, 4)  # not fp32
    with pytest.raises(ValueError):
        splat.composite(payload[:, :6].contiguous(), ts, tc, 4)  # 6 rows
    with pytest.raises(ValueError):
        splat.composite(payload, ts.long(), tc, 4)  # int64 starts
    with pytest.raises(ValueError):
        splat.composite(payload, ts, tc, 8)  # tile grid disagrees
    with pytest.raises(ValueError):
        splat.composite(payload, ts.cpu(), tc, 4)  # another device
    with pytest.raises(ValueError, match="packed"):
        splat.composite(payload.requires_grad_(), ts, tc, 4)  # 8 rows under grad


@pytest.mark.parametrize("max_pairs", [1 << 15, 2048])  # 2048 overflows
def test_splat_composite_backward_matches_its_twin(cuda, max_pairs):
    from videomv_tpu_torch.ops import splat

    payload, ts, tc, _ = _splat_bins(cuda, False, max_pairs)
    saved = splat.composite(payload, ts, tc, 4)
    gen = torch.Generator(device=cuda).manual_seed(7)
    grad = torch.randn(saved.shape, generator=gen, device=cuda)
    ops.reset_launch_counts()
    kern = splat.composite_backward(payload, ts, tc, saved, grad, 4)
    torch.cuda.synchronize()
    assert ops.launch_counts()["splat_composite_bwd"] == 1
    twin = splat.composite_backward_reference(payload, ts, tc, saved, grad, 4)
    scale = twin.abs().max().item()
    assert scale > 1.0
    # fp32 both; the 256-pixel sums in another order
    assert (kern - twin).abs().max().item() <= 2e-4 * scale
    assert kern[:, 10:].abs().max().item() == 0.0
    live = int(tc[0].sum())
    if live < payload.shape[-1]:  # beyond the last segment (none when the capacity is full)
        assert kern[0, :, live:].abs().max().item() == 0.0
    # two launches give the same bits (one writer per pair, no atomics)
    again = splat.composite_backward(payload, ts, tc, saved, grad, 4)
    assert torch.equal(kern, again)
    # the autograd.Function: kernel forward and kernel backward
    p = payload.clone().requires_grad_()
    ops.reset_launch_counts()
    (auto,) = torch.autograd.grad(splat.composite(p, ts, tc, 4), p, grad)
    assert ops.launch_counts()["splat_composite"] == 1
    assert ops.launch_counts()["splat_composite_bwd"] == 1
    assert torch.equal(auto, kern)
    # and autograd through the forward twin agrees
    p = payload.clone().requires_grad_()
    (ref,) = torch.autograd.grad(splat.composite_reference(p, ts, tc, 4), p, grad)
    assert (kern - ref).abs().max().item() <= 2e-4 * scale


def test_splat_composite_backward_rejects_what_it_cannot_take(cuda):
    from videomv_tpu_torch.ops import splat

    payload, ts, tc, _ = _splat_bins(cuda, False, 1 << 15, views=2)
    saved = splat.composite(payload, ts, tc, 4)
    grad = torch.ones_like(saved)
    with pytest.raises(ValueError):
        splat.composite_backward(payload, ts, tc, saved[:, :, :4].contiguous(), grad, 4)
    with pytest.raises(ValueError):
        splat.composite_backward(payload, ts, tc, saved, grad.double(), 4)
    with pytest.raises(ValueError):
        splat.composite_backward(payload, ts, tc, saved, grad.cpu(), 4)
    with pytest.raises(ValueError):
        splat.composite_backward(payload[:, :8].contiguous(), ts, tc, saved, grad, 4)


def test_render_gradient_through_the_kernels_matches_the_dense_oracle(cuda):
    """d loss / d Gaussians through projection, binning and kernels 3 + 4
    against autograd through the dense oracle, one 32² view."""
    import numpy as np

    from videomv_tpu_torch.data.cameras import (
        GSCameraSettings, orbit_c2w_opengl, prepare_gs_training)
    from videomv_tpu_torch.ops import gaussian_splat as tgs

    rs = np.random.default_rng(3)
    n = 96
    quat = rs.normal(size=(n, 4))
    g = np.concatenate([rs.uniform(-0.5, 0.5, (n, 3)), rs.uniform(0.2, 1.0, (n, 1)),
                        rs.uniform(0.02, 0.08, (n, 3)),
                        quat / np.linalg.norm(quat, axis=1, keepdims=True),
                        rs.uniform(0, 1, (n, 3))], axis=1).astype(np.float32)
    cams = prepare_gs_training(orbit_c2w_opengl(1, 10.0, 1.5),
                               GSCameraSettings(input_size=32, output_size=32), ray_size=8)
    cv = torch.from_numpy(cams["cam_view"]).to(cuda)
    cvp = torch.from_numpy(cams["cam_view_proj"]).to(cuda)
    bg = torch.zeros(3, device=cuda)
    grads = {}
    for backend in ("binned", "dense"):
        x = torch.from_numpy(g).to(cuda)[None].requires_grad_()
        ops.reset_launch_counts()
        out = tgs.render_gaussians(x, cv, cvp, bg_color=bg, img_size=32, backend=backend)
        loss = (out["image"] ** 2).sum() + out["alpha"].sum() + 0.3 * (out["depth"] ** 2).sum()
        (grads[backend],) = torch.autograd.grad(loss, x)
        want = 1 if backend == "binned" else 0
        assert ops.launch_counts()["splat_composite"] == want
        assert ops.launch_counts()["splat_composite_bwd"] == want
    # the tolerance of the CPU test against the JAX dense gradient
    torch.testing.assert_close(grads["binned"], grads["dense"], rtol=1e-3, atol=1e-4)


def _rel_max(got, want):
    return max(((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("shape", [(1, 1024, 16, 64), (2, 256, 4, 128)])
def test_flash_attention_backward_is_the_twins(cuda, shape):
    """Kernel forward; the backward recomputes through the plain twin, so it
    equals autograd through the twin alone."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (_randn(gen, cuda, *shape).requires_grad_() for _ in range(3))
    go = _randn(gen, cuda, *shape)
    ops.reset_launch_counts()
    out = flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 1 and out.requires_grad
    got = torch.autograd.grad(out, (q, k, v), go)
    assert ops.launch_counts()["flash_attention"] == 1  # the backward launches nothing
    want = torch.autograd.grad(attention_reference(q, k, v), (q, k, v), go)
    assert _rel_max(got, want) <= 1e-3
    with torch.no_grad():
        flash_attention(q, k, v)  # no graph, same kernel
    assert ops.launch_counts()["flash_attention"] == 2


def test_geglu_ffn_backward_is_the_twins(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    t, c, inner = 4100, 64, 256
    args = [_randn(gen, cuda, t, c), _randn(gen, cuda, 2 * inner, c, scale=c ** -0.5),
            _randn(gen, cuda, 2 * inner, scale=0.1, dtype=torch.float32),
            _randn(gen, cuda, c, inner, scale=inner ** -0.5),
            _randn(gen, cuda, c, scale=0.1, dtype=torch.float32)]
    args = [a.requires_grad_() for a in args]
    go = _randn(gen, cuda, t, c)
    ops.reset_launch_counts()
    got = torch.autograd.grad(geglu_ffn(*args), args, go)
    assert ops.launch_counts()["geglu_ffn"] == 1
    want = torch.autograd.grad(geglu_ffn_reference(*args), args, go)
    assert _rel_max(got, want) <= 1e-3


def test_module_dispatch_reaches_the_kernels(cuda):
    from videomv_tpu_torch.models.blocks import BasicTransformerBlock

    block = BasicTransformerBlock(320, 5, 64, context_dim=1024).to(cuda, torch.bfloat16).eval()
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = _randn(gen, cuda, 8, 1024, 320)
    ctx = _randn(gen, cuda, 8, 77, 1024)
    ops.reset_launch_counts()
    with torch.no_grad():
        block(x, ctx)
    # attn1 (self, 1024 tokens) and the FFN (8192 tokens) take the kernels;
    # attn2 (77 context tokens) stays plain
    assert ops.launch_counts() == {"flash_attention": 1, "geglu_ffn": 1, "splat_composite": 0,
                                   "splat_composite_bwd": 0}
    ops.reset_launch_counts()
    with torch.no_grad():
        block.train()(x, ctx)  # training mode: the FFN gate is closed
    assert ops.launch_counts() == {"flash_attention": 1, "geglu_ffn": 0, "splat_composite": 0,
                                   "splat_composite_bwd": 0}
    # under grad the attention goes through its autograd.Function
    ops.reset_launch_counts()
    block(x.clone().requires_grad_(), ctx).float().sum().backward()
    assert ops.launch_counts() == {"flash_attention": 1, "geglu_ffn": 0, "splat_composite": 0,
                                   "splat_composite_bwd": 0}
    assert all(p.grad is not None for p in block.parameters())
