"""GPU-only checks of the port's CUDA kernels beyond the main path's shapes
(head_dim 128, single-tile and odd-tile sequences, token counts that are not
a tile multiple, the widest and narrowest C; the splat composite with both
payloads and an overflowing pair capacity), the wrappers' input checks,
and the module dispatch. Each test needs a CUDA device and skips without
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
    with pytest.raises(NotImplementedError):
        splat.composite(payload.requires_grad_(), ts, tc, 4)  # forward only


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
    assert ops.launch_counts() == {"flash_attention": 1, "geglu_ffn": 1, "splat_composite": 0}
    ops.reset_launch_counts()
    with torch.no_grad():
        block.train()(x, ctx)  # training mode: the FFN gate is closed
    assert ops.launch_counts() == {"flash_attention": 1, "geglu_ffn": 0, "splat_composite": 0}
