"""GPU-only checks of the port's CUDA kernels beyond the main path's shapes
(head_dim 128, single-tile and odd-tile sequences, token counts that are not
a tile multiple, the widest and narrowest C; the splat composite with both
payloads and an overflowing pair capacity, bit-equal to the per-tile kernel,
and on a render whose pairs pile up in a few tiles; its two backward
kernels, culled and per-tile, against their twin and autograd of the forward
twin, on those renders, on degenerate pairs and on a NaN colour), the wrappers'
input checks, the backward of the attention and FFN wrappers, the module
dispatch, and the
fused spatial-transformer block (at its one width against its twin at ragged
contexts, one-tile and odd-tile sequences and at 1, 24 and 48 rows, with
large logits; its input checks, its backward, its dispatch under the
environment switch, and other widths and contexts on the module path), and the attention kernel inside a checkpointed block at
the UNet finetune's shape; the attention backward kernel against its twin
and an fp32 computation at the trained shapes, tile edges and head_dim 128,
bit-equal over two runs, the forward's log-sum-exp from both forward kernels
against its twin, and a checkpointed transformer block's gradient with the
kernels against the same block plain; kernel 6 (GroupNorm + SiLU) against
its twin and fp32 at every served shape class, on permuted inputs read in
place, bit-equal over two runs and in a replayed CUDA graph. Each test needs a CUDA device and skips without one. On the card, from the repository root (the test tree's conftest
imports JAX, which the card machine does not have):

    python -m pytest tests/test_torch_gpu_kernels.py -m gpu --noconftest -q
"""

import pytest
import torch
import torch.nn.functional as F

from videomv_tpu_torch import ops
from videomv_tpu_torch.ops import flash_attention as fa
from videomv_tpu_torch.ops.flash_attention import (
    VARIANT_MMA, VARIANT_WGMMA, attention_backward_reference, attention_lse_reference,
    attention_reference, attention_variant, flash_attention)
from videomv_tpu_torch.ops.fused_ffn import (
    WGMMA_WIDTHS, ffn_eligible, geglu_ffn, geglu_ffn_reference)

pytestmark = pytest.mark.gpu

# a kernel's error against an fp32 computation may not exceed twice its
# plain twin's (both bf16) plus this
EPS = 2e-3
# the forward kernels' log-sum-exp against its fp32 twin on the same bf16
# inputs: the same fp32 sums in another order (|lse| ~ 7 at S = 1024)
LSE_TOL = 1e-4


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


# the tile edges of both kernels at B·H = 1: one 64-key tile, one 128-key tile,
# one and a half, eight. The wrapper sends so small a grid to the mma.sync
# kernel; where the wgmma kernel takes the shape it is launched as well.
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [64, 128, 192, 1024])
def test_flash_attention_tile_edges(cuda, s, d):
    shape = (1, s, 1, d)
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    q, k, v = (_randn(gen, cuda, *shape) for _ in range(3))
    twin = attention_reference(q, k, v)
    ref32 = attention_reference(q.float(), k.float(), v.float())
    assert attention_variant(*shape) == VARIANT_MMA
    variants = [VARIANT_MMA] + ([VARIANT_WGMMA] if d == 64 and s >= 128 else [])
    for variant in variants:
        ops.reset_launch_counts()
        kern = fa._launch(q, k, v, variant=variant)
        torch.cuda.synchronize()
        assert ops.launch_counts()["flash_attention"] == 1
        ok, errs = _within_bound(kern, twin, ref32)
        assert ok, (variant, errs)
        assert torch.equal(fa._launch(q, k, v, variant=variant), kern)  # one writer per element
    if len(variants) == 1:  # the wgmma kernel does not take the shape: refused, not rerouted
        with pytest.raises(RuntimeError):
            fa._launch(q, k, v, variant=VARIANT_WGMMA)
    assert torch.equal(flash_attention(q, k, v), fa._launch(q, k, v, variant=VARIANT_MMA))


def _chunked_errors(kern, q, k, v, rows: int = 6):
    """The kernel's and the plain twin's largest errors against fp32 over
    batch chunks of ``rows`` (the plain paths
    hold [B, H, S, S] fp32 logits: 22 GiB at SV3D's [42, 5184, 5, 64])."""
    k_err = t_err = 0.0
    for i in range(0, q.shape[0], rows):
        sl = slice(i, i + rows)
        twin = attention_reference(q[sl], k[sl], v[sl]).float()
        ref32 = attention_reference(q[sl].float(), k[sl].float(), v[sl].float())
        k_err = max(k_err, (kern[sl].float() - ref32).abs().max().item())
        t_err = max(t_err, (twin - ref32).abs().max().item())
    return k_err, t_err


# S % 128 != 0 at head_dim 64: the wgmma kernel's masked last tile. SV3D's
# three levels (72², 36², 18² latents of 21 frames, CFG rows), which the
# dispatch sends to it, and two small ragged shapes launched on it directly,
# one with a 64-key tail (S = 320, a grid the dispatch leaves to the mma.sync
# kernel) and one with 104 (S = 1000).
@pytest.mark.parametrize("shape", [(42, 5184, 5, 64), (42, 1296, 10, 64), (42, 324, 20, 64),
                                   (4, 320, 5, 64), (2, 1000, 8, 64)])
def test_flash_attention_ragged_tail(cuda, shape):
    b, s, h, d = shape
    if b == 42:
        assert attention_variant(*shape) == VARIANT_WGMMA
    gen = torch.Generator(device=cuda).manual_seed(s + h)
    q, k, v = (_randn(gen, cuda, *shape) for _ in range(3))
    ops.reset_launch_counts()
    kern = fa._launch(q, k, v, variant=VARIANT_WGMMA)
    torch.cuda.synchronize()
    assert ops.launch_counts_by_shape()["flash_attention"] == {shape: 1}
    assert torch.isfinite(kern).all()
    # (keys past S that took a share of the softmax would dilute every row)
    k_err, t_err = _chunked_errors(kern, q, k, v)
    assert k_err <= 2 * t_err + EPS, (k_err, t_err)
    # rows >= S are never stored: the same launch into a buffer with a guard
    # band after the last batch's rows leaves the band as it was
    n = b * s * h * d
    buf = torch.full((n + 128 * h * d,), 7.0, dtype=torch.bfloat16, device=cuda)
    err = fa._build.load_library().vmv_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), None, b, s, h, d,
        float(d ** -0.5), VARIANT_WGMMA, torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(buf[:n].view(shape), kern)
    assert (buf[n:] == 7.0).all()


@pytest.mark.parametrize("shape", [(32, 256, 3, 64), (1, 192, 2, 64)])
def test_flash_attention_large_logits(cuda, shape):
    """|q·k|·scale of the order of 80: the online softmax must neither
    overflow nor lose the rows whose maximum arrives in a later tile."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (_randn(gen, cuda, *shape) for _ in range(3))
    q, k = q * 3.2, k * 3.2   # logits ~ N(0, 10.2² · 64) / 8: a few rows beyond 80
    q[:, 5], k[:, shape[1] - 3] = 9.0, 9.0   # a maximum of 81 · 64 / 8 = 648 in the last tile
    kern = flash_attention(q, k, v)
    ref32 = attention_reference(q.float(), k.float(), v.float())
    assert torch.isfinite(kern).all()
    ok, errs = _within_bound(kern, attention_reference(q, k, v), ref32)
    assert ok, errs


def test_flash_attention_rejects_what_it_cannot_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = _randn(gen, cuda, 2, 128, 2, 64)
    with pytest.raises(ValueError):
        flash_attention(q.float(), q.float(), q.float())  # fp32
    with pytest.raises(ValueError):
        flash_attention(q[:, :100].contiguous(), q[:, :100].contiguous(),
                        q[:, :100].contiguous())  # S < 128 (and S % 64 != 0)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :64].contiguous(), q[:, :64].contiguous())  # cross
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError):
        g = _randn(gen, cuda, 2, 128, 2, 32)
        flash_attention(g, g, g)  # head_dim 32


# (a ragged last tile, a short inner width, the last two: SV3D's row counts
# at its 72² and 36² levels, 21 frames × CFG)
@pytest.mark.parametrize("t,c,inner", [(4100, 512, 2048), (333, 640, 2560), (4096, 640, 512),
                                       (97, 320, 1280), (217728, 320, 1280),
                                       (54432, 640, 2560)])
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


# the tile edges of the wgmma kernel (64 token rows a block): fewer rows than
# a tile, one short of and one past two tiles, ragged last tiles
@pytest.mark.parametrize("c", [320, 512, 640])
@pytest.mark.parametrize("t", [1, 127, 129, 333, 4100])
def test_geglu_ffn_tile_edges(cuda, t, c):
    inner = 4 * c
    gen = torch.Generator(device=cuda).manual_seed(t + c)
    x = _randn(gen, cuda, t, c)
    w1 = _randn(gen, cuda, 2 * inner, c, scale=c ** -0.5)
    w2 = _randn(gen, cuda, c, inner, scale=inner ** -0.5)
    b1 = _randn(gen, cuda, 2 * inner, scale=0.1, dtype=torch.float32)
    b2 = _randn(gen, cuda, c, scale=0.1, dtype=torch.float32)
    assert c in WGMMA_WIDTHS
    kern = geglu_ffn(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    ok, errs = _within_bound(kern, geglu_ffn_reference(x, w1, b1, w2, b2),
                             geglu_ffn_reference(x.float(), w1.float(), b1, w2.float(), b2))
    assert ok, errs
    assert torch.equal(geglu_ffn(x, w1, b1, w2, b2), kern)  # one writer per element


def test_geglu_ffn_rejects_what_it_cannot_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = _randn(gen, cuda, 64, 320)
    w1, w2 = _randn(gen, cuda, 512, 320), _randn(gen, cuda, 320, 256)
    b1 = torch.zeros(512, device=cuda)
    b2 = torch.zeros(320, device=cuda)
    geglu_ffn(x, w1, b1, w2, b2)  # C = 320 is fine
    with pytest.raises(ValueError):
        geglu_ffn(x, w1, b1.bfloat16(), w2, b2)  # bias dtype
    for c in (96, 1024):  # a width the kernel is not built for: refused, never launched
        ops.reset_launch_counts()
        with pytest.raises(ValueError, match="320, 512, 640"):
            geglu_ffn(_randn(gen, cuda, 64, c), _randn(gen, cuda, 512, c), b1,
                      _randn(gen, cuda, c, 256), torch.zeros(c, device=cuda))
        assert ops.launch_counts()["geglu_ffn"] == 0
        assert not ffn_eligible(4096, c, 4 * c, torch.bfloat16, True)  # the module: plain
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
    # the served (culled) kernel gives the per-tile kernel's bits, run after run
    old = splat._composite_forward(payload, ts, tc, 4, variant=splat.VARIANT_PER_TILE)
    assert torch.equal(kern, old)
    assert torch.equal(splat.composite(payload, ts, tc, 4), kern)


@pytest.mark.parametrize("packed", [False, True])
def test_splat_composite_culled_keeps_degenerate_pairs(cuda, packed):
    """Pairs that the culling box cannot bound (a NaN opacity, a NaN or
    indefinite conic, a conic whose products overflow), planted in the
    busiest segment with their means far outside the tile, reach every block:
    the culled kernel gives the per-tile kernel's bits. A NaN opacity makes
    alpha 0.99 wherever power <= 0, so that pair covers the whole tile."""
    from videomv_tpu_torch.ops import splat

    payload, ts, tc, _ = _splat_bins(cuda, packed, 1 << 15, views=2)
    t = int(tc[0].argmax())
    assert int(tc[0, t]) > 12
    at = [int(ts[0, t]) + 3 * k for k in range(5)]
    payload[0, :2, at] = -1000.0                    # the means, far outside the tile
    payload[0, 2:5, at[1]] = float("nan")           # a NaN conic
    payload[0, 2, at[2]] = -1.0                     # a <= 0
    payload[0, 2:5, at[3]] = torch.tensor([1.0, 2.0, 1.0], device=cuda)  # det < 0
    payload[0, 2, at[4]] = payload[0, 4, at[4]] = 1e30  # a c overflows
    nan = torch.full((1,), float("nan"), device=cuda)
    if packed:
        payload[0, 6, at[0]] = splat._pack2(splat._unpack2(payload[0, 6, at[:1]])[0], nan)[0]
    else:
        payload[0, 8, at[0]] = nan[0]
    kern = splat.composite(payload, ts, tc, 4)
    old = splat._composite_forward(payload, ts, tc, 4, variant=splat.VARIANT_PER_TILE)
    torch.cuda.synchronize()
    assert torch.equal(kern, old)
    # the NaN-opacity and NaN-conic pairs cover the tile (alpha 0.99 each)
    assert kern[0, t, 3].min().item() > 0.999


def _heavy_bins(dev, packed):
    """A few tiles hold thousands of pairs and most hold none, over more
    (view, tile) items than a persistent grid has CTAs, with view 7 left
    empty: 40 views at 256² of a seeded scene whose Gaussians crowd three
    points. Returns the binned lists and the tiles per side."""
    import numpy as np

    from videomv_tpu_torch.data.cameras import (
        GSCameraSettings, orbit_c2w_opengl, prepare_gs_training)
    from videomv_tpu_torch.ops import gaussian_splat as tgs
    from videomv_tpu_torch.ops import splat

    n, views, size = 12288, 40, 256
    rs = np.random.default_rng(11)
    centres = rs.uniform(-0.3, 0.3, (3, 3))
    xyz = np.where(rs.uniform(size=(n, 1)) < 0.9,
                   centres[rs.integers(0, 3, n)] + rs.normal(0, 0.01, (n, 3)),
                   rs.uniform(-0.5, 0.5, (n, 3)))
    quat = rs.normal(size=(n, 4))
    g = np.concatenate([xyz, rs.uniform(0.05, 1.0, (n, 1)), rs.uniform(0.002, 0.01, (n, 3)),
                        quat / np.linalg.norm(quat, axis=1, keepdims=True),
                        rs.uniform(0, 1, (n, 3))], axis=1).astype(np.float32)
    st = GSCameraSettings(input_size=size, output_size=size)
    cams = prepare_gs_training(orbit_c2w_opengl(views, 15.0, 2.0), st, ray_size=8)
    prep = {k: v[None] for k, v in tgs.prepare_gaussians(torch.from_numpy(g).to(dev)).items()}
    proj = tgs.project_prepared(prep, torch.from_numpy(cams["cam_view"][0]).to(dev),
                                torch.from_numpy(cams["cam_view_proj"][0]).to(dev), size,
                                st.tan_half_fov)
    payload, ts, tc, _ = splat.bin_pairs(*proj, img_size=size, max_pairs=1 << 17, packed=packed)
    tc[7] = 0  # an empty view
    nts = size // 16
    # at most 8 CTAs of 256 threads fit an SM's 2,048 threads
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert views * nts * nts > 2 * 8 * sms
    counts = tc.flatten().sort(descending=True).values
    assert counts[0] >= 2000 and counts[len(counts) // 2] < 64, counts[:8]
    return payload, ts, tc, nts


@pytest.mark.parametrize("packed", [False, True])
def test_splat_composite_heavy_tiles(cuda, packed):
    """The heaviest-first schedule's tail, items with no pairs, and a view
    left empty (``_heavy_bins``)."""
    from videomv_tpu_torch.ops import splat

    payload, ts, tc, nts = _heavy_bins(cuda, packed)
    kern = splat.composite(payload, ts, tc, nts)
    old = splat._composite_forward(payload, ts, tc, nts, variant=splat.VARIANT_PER_TILE)
    torch.cuda.synchronize()
    assert torch.equal(kern, old)
    assert kern[7].abs().max().item() == 0.0
    twin = splat.composite_reference(payload, ts, tc, nts)
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


def _same_bits(a, b):
    """Bit for bit, NaNs included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _bwd_launches(payload, ts, tc, nts, variant, seed=7):
    """The backward kernel named by ``variant`` on the culled forward's output
    and a seeded gradient, with the checks every input gets: one launch
    counted; rows 10-15 and the columns past each view's last segment exactly
    zero; two launches bit-equal (one writer per pair, no atomics); the
    autograd path (kernel forward, served backward) bit-identical to the
    served kernel's direct call. Returns (kernel's dpayload, saved, grad)."""
    from videomv_tpu_torch.ops import splat

    saved = splat.composite(payload, ts, tc, nts)
    gen = torch.Generator(device=payload.device).manual_seed(seed)
    grad = torch.randn(saved.shape, generator=gen, device=payload.device)
    ops.reset_launch_counts()
    kern = splat.composite_backward(payload, ts, tc, saved, grad, nts, variant=variant)
    torch.cuda.synchronize()
    assert ops.launch_counts()["splat_composite_bwd"] == 1
    assert kern[:, 10:].abs().max().item() == 0.0
    for r, end in enumerate((ts[:, -1] + tc[:, -1]).tolist()):
        if tc[r].sum() == 0:
            assert kern[r].abs().max().item() == 0.0  # an empty view
        elif end < payload.shape[-1]:
            assert kern[r, :, end:].abs().max().item() == 0.0
    again = splat.composite_backward(payload, ts, tc, saved, grad, nts, variant=variant)
    assert _same_bits(kern, again)
    served = splat.composite_backward(payload, ts, tc, saved, grad, nts)
    p = payload.clone().requires_grad_()
    ops.reset_launch_counts()
    (auto,) = torch.autograd.grad(splat.composite(p, ts, tc, nts), p, grad)
    assert ops.launch_counts()["splat_composite"] == 1
    assert ops.launch_counts()["splat_composite_bwd"] == 1
    assert _same_bits(auto, served)
    return kern, saved, grad


BWD_VARIANTS = ["BWD_VARIANT_CULLED", "BWD_VARIANT_PER_TILE"]


@pytest.mark.parametrize("variant", BWD_VARIANTS)
@pytest.mark.parametrize("max_pairs", [1 << 15, 2048])  # 2048 overflows
def test_splat_composite_backward_matches_its_twin(cuda, max_pairs, variant):
    from videomv_tpu_torch.ops import splat

    payload, ts, tc, _ = _splat_bins(cuda, False, max_pairs)
    kern, saved, grad = _bwd_launches(payload, ts, tc, 4, getattr(splat, variant))
    twin = splat.composite_backward_reference(payload, ts, tc, saved, grad, 4)
    scale = twin.abs().max().item()
    assert scale > 1.0
    # fp32 both; the 256-pixel sums in another order
    assert (kern - twin).abs().max().item() <= 2e-4 * scale
    # and autograd through the forward twin agrees
    p = payload.clone().requires_grad_()
    (ref,) = torch.autograd.grad(splat.composite_reference(p, ts, tc, 4), p, grad)
    assert (kern - ref).abs().max().item() <= 2e-4 * scale


def _tile_columns(ts, tc, view, tile):
    """The columns of one tile's segment, as a slice."""
    start, count = int(ts[view, tile]), int(tc[view, tile])
    return slice(start, start + count)


@pytest.mark.parametrize("variant", BWD_VARIANTS)
def test_splat_composite_backward_keeps_degenerate_pairs(cuda, variant):
    """The forward's degenerate pairs (a NaN opacity, a NaN or indefinite
    conic, a conic whose products overflow, means far outside the tile) in
    the busiest segment reach every block in the culled backward too. The
    twin takes a NaN opacity as NaN where the kernels clamp it to 0.99, so
    the tile that holds them is held against the per-tile kernel (the same
    NaNs, the rest within 2e-4), every other column against the twin."""
    from videomv_tpu_torch.ops import splat

    payload, ts, tc, _ = _splat_bins(cuda, False, 1 << 15, views=2)
    t = int(tc[0].argmax())
    assert int(tc[0, t]) > 12
    at = [int(ts[0, t]) + 3 * k for k in range(5)]
    payload[0, :2, at] = -1000.0                    # the means, far outside the tile
    payload[0, 2:5, at[1]] = float("nan")           # a NaN conic
    payload[0, 2, at[2]] = -1.0                     # a <= 0
    payload[0, 2:5, at[3]] = torch.tensor([1.0, 2.0, 1.0], device=cuda)  # det < 0
    payload[0, 2, at[4]] = payload[0, 4, at[4]] = 1e30  # a c overflows
    payload[0, 8, at[0]] = float("nan")             # a NaN opacity
    kern, saved, grad = _bwd_launches(payload, ts, tc, 4, getattr(splat, variant))
    old = splat.composite_backward(payload, ts, tc, saved, grad, 4,
                                   variant=splat.BWD_VARIANT_PER_TILE)
    cols = _tile_columns(ts, tc, 0, t)
    k, o = kern[0, :10, cols], old[0, :10, cols]
    assert torch.equal(k.isnan(), o.isnan()) and k.isnan().any()
    fin = ~k.isnan()
    assert (k[fin] - o[fin]).abs().max().item() <= 2e-4 * o[fin].abs().max().item()
    twin = splat.composite_backward_reference(payload, ts, tc, saved, grad, 4)
    rest = torch.ones_like(kern, dtype=torch.bool)
    rest[0, :, cols] = False
    scale = twin[rest].abs().max().item()
    assert (kern[rest] - twin[rest]).abs().max().item() <= 2e-4 * scale


@pytest.mark.parametrize("variant", BWD_VARIANTS)
def test_splat_composite_backward_heavy_tiles(cuda, variant):
    """The backward on ``_heavy_bins``' 16-row payload: the schedule's tail,
    items with no pairs, an empty view (zero from its first column)."""
    from videomv_tpu_torch.ops import splat

    payload, ts, tc, nts = _heavy_bins(cuda, False)
    kern, saved, grad = _bwd_launches(payload, ts, tc, nts, getattr(splat, variant))
    twin = splat.composite_backward_reference(payload, ts, tc, saved, grad, nts)
    scale = twin.abs().max().item()
    assert scale > 1.0
    assert (kern - twin).abs().max().item() <= 2e-4 * scale


def test_splat_composite_backward_nan_colour(cuda):
    """A NaN colour on a small pair (its mask neither empty nor full): at a
    point where the pair is dead, g.c * w = NaN * 0 enters the prefix. The
    per-tile kernel lets it into the pixels of every two-row warp where the
    pair is alive at some lane, the culled kernel into the 8 x 4 blocks its
    mask keeps, which the culled forward's output already carries as NaN
    (it blends the pair there): so the culled kernel's NaNs are a subset of
    the per-tile kernel's, both agree within 2e-4 wherever both are finite,
    the pair's own colour gradient stays finite, and every other tile
    matches the twin."""
    from videomv_tpu_torch.ops import splat

    payload, ts, tc, _ = _splat_bins(cuda, False, 1 << 15, views=2)
    masks = splat.cull_masks(payload, ts, tc, 4)
    t = int(tc[0].argmax())
    cols = _tile_columns(ts, tc, 0, t)
    m = masks[0, cols].long()
    small = ((m != 0) & (m != 255) & (torch.arange(m.numel(), device=cuda) > 8)).nonzero()
    at = int(ts[0, t]) + int(small[0])
    payload[0, 6, at] = float("nan")                # its green
    kern, saved, grad = _bwd_launches(payload, ts, tc, 4, splat.BWD_VARIANT_CULLED)
    old = splat.composite_backward(payload, ts, tc, saved, grad, 4,
                                   variant=splat.BWD_VARIANT_PER_TILE)
    assert kern.isnan().any()
    assert not (kern.isnan() & ~old.isnan()).any()
    both = ~kern.isnan() & ~old.isnan()
    assert (kern[both] - old[both]).abs().max().item() <= 2e-4 * old[both].abs().max().item()
    assert torch.isfinite(kern[0, [5, 6, 7, 9], at]).all()
    rest = torch.ones_like(kern, dtype=torch.bool)
    rest[0, :, cols] = False
    assert not kern[rest].isnan().any()
    twin = splat.composite_backward_reference(payload, ts, tc, saved, grad, 4)
    scale = twin[rest].abs().max().item()
    assert (kern[rest] - twin[rest]).abs().max().item() <= 2e-4 * scale


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
    with pytest.raises(ValueError, match="variant"):
        splat.composite_backward(payload, ts, tc, saved, grad, 4, variant=7)
    with pytest.raises(ValueError, match="order"):
        splat.composite_backward(payload, ts, tc, saved, grad, 4, order=ts.flatten()[:5])


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


def _grads_within_bound(got, twin, ref32):
    """Each gradient's error against fp32, relative to its largest entry,
    within twice the twin's plus EPS."""
    for name, g, t, r in zip(("dq", "dk", "dv"), got, twin, ref32):
        k_err, t_err = _rel_max([g], [r]), _rel_max([t], [r])
        assert k_err <= 2 * t_err + EPS, (name, k_err, t_err)


def _fp32_grads(q, k, v, go):
    f32 = [t.detach().float().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(attention_reference(*f32), f32, go.float())


@pytest.mark.parametrize("shape", [(1, 1024, 16, 64), (2, 256, 4, 128)])
def test_flash_attention_backward_is_the_twins(cuda, shape):
    """Kernel forward with its log-sum-exp, the backward kernel on the saved
    tensors: within the bound of the backward twin fed the same o and lse."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (_randn(gen, cuda, *shape).requires_grad_() for _ in range(3))
    go = _randn(gen, cuda, *shape)
    ops.reset_launch_counts()
    out = flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 1 and out.requires_grad
    got = torch.autograd.grad(out, (q, k, v), go)
    assert ops.launch_counts()["flash_attention"] == 1
    assert ops.launch_counts_by_shape()["flash_attention_bwd"] == {shape: 1}
    _, lse = fa._launch(q.detach(), k.detach(), v.detach(), with_lse=True)
    twin = attention_backward_reference(q, k, v, out.detach(), lse, go)
    _grads_within_bound(got, twin, _fp32_grads(q, k, v, go))
    with torch.no_grad():
        flash_attention(q, k, v)  # no graph, same kernel, no backward
    assert ops.launch_counts()["flash_attention"] == 3
    assert ops.launch_counts()["flash_attention_bwd"] == 1


# the trained shapes (the UNet finetune's 32² and 16² at 48 rows, the LGM's),
# S = 64 x 3 and 64 x 5 (odd tile counts for both backward kernels), head_dim 128
@pytest.mark.parametrize("shape", [(48, 1024, 5, 64), (48, 256, 10, 64), (1, 1024, 16, 64),
                                   (2, 192, 3, 64), (1, 320, 2, 64), (2, 512, 4, 128),
                                   (1, 192, 2, 128)])
def test_flash_attention_backward_matches_fp32(cuda, shape):
    """The backward kernel alone on the forward kernel's o and lse: within
    twice its twin's error against autograd of the fp32 plain attention
    (relative to each gradient's largest entry) plus EPS, and bit-equal over
    two runs (no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v, go = (_randn(gen, cuda, *shape) for _ in range(4))
    o, lse = fa._launch(q, k, v, with_lse=True)
    ops.reset_launch_counts()
    got = fa._launch_bwd(q, k, v, o, lse, go)
    torch.cuda.synchronize()
    assert ops.launch_counts_by_shape()["flash_attention_bwd"] == {shape: 1}
    assert all(torch.equal(a, b) for a, b in zip(fa._launch_bwd(q, k, v, o, lse, go), got))
    twin = attention_backward_reference(q, k, v, o, lse, go)
    _grads_within_bound(got, twin, _fp32_grads(q, k, v, go))
    assert _rel_max(got, twin) <= 5e-2


@pytest.mark.parametrize("shape,variant", [
    ((48, 1024, 5, 64), VARIANT_WGMMA), ((48, 256, 10, 64), VARIANT_WGMMA),
    ((2, 512, 3, 64), VARIANT_WGMMA), ((48, 1024, 5, 64), VARIANT_MMA),
    ((1, 256, 16, 64), VARIANT_MMA), ((2, 192, 3, 64), VARIANT_MMA),
    ((2, 512, 4, 128), VARIANT_MMA)])
def test_flash_attention_lse_matches_its_twin(cuda, shape, variant):
    """Both forward kernels' log-sum-exp, row by row (a wrong row mapping
    passes an output-only check), and the output unchanged by writing it."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + variant)
    q, k, v = (_randn(gen, cuda, *shape) for _ in range(3))
    o, lse = fa._launch(q, k, v, variant=variant, with_lse=True)
    assert torch.equal(o, fa._launch(q, k, v, variant=variant))
    _, want = attention_lse_reference(q, k, v)
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert (lse - want).abs().max().item() <= LSE_TOL


def test_flash_attention_under_checkpoint(cuda):
    """Kernel 1 inside a block recomputed by ``torch.utils.checkpoint``, as the
    UNet finetune runs it at its 32² shape: the forward launches once, the
    backward's recomputation once more (the counter sees both) and the
    backward kernel once on the recomputation's o and lse; the gradient stays
    within the kernel bound of an fp32 computation."""
    from torch.utils.checkpoint import checkpoint

    shape = (48, 1024, 5, 64)
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (_randn(gen, cuda, *shape).requires_grad_() for _ in range(3))
    go = _randn(gen, cuda, *shape)
    ops.reset_launch_counts()
    out = checkpoint(flash_attention, q, k, v, use_reentrant=False)
    assert ops.launch_counts_by_shape()["flash_attention"] == {shape: 1}
    got = torch.autograd.grad(out, (q, k, v), go)
    assert ops.launch_counts_by_shape()["flash_attention"] == {shape: 2}
    assert ops.launch_counts_by_shape()["flash_attention_bwd"] == {shape: 1}
    o, lse = fa._launch(q.detach(), k.detach(), v.detach(), with_lse=True)
    twin = attention_backward_reference(q, k, v, o, lse, go)
    assert all(torch.equal(a, b) for a, b in zip(fa._launch_bwd(q, k, v, o, lse, go), got))
    _grads_within_bound(got, twin, _fp32_grads(q, k, v, go))
    with torch.no_grad():
        ok, errs = _within_bound(out, attention_reference(q, k, v),
                                 attention_reference(*(t.float() for t in (q, k, v))))
    assert ok, errs


def test_geglu_ffn_backward_is_the_twins(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    t, c, inner = 4100, 320, 1280
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
    zero = dict.fromkeys(ops.launch_counts(), 0)
    assert ops.launch_counts() == dict(zero, flash_attention=1, geglu_ffn=1)
    ops.reset_launch_counts()
    with torch.no_grad():
        block.train()(x, ctx)  # training mode: the FFN gate is closed
    assert ops.launch_counts() == dict(zero, flash_attention=1)
    # under grad the attention goes through its autograd.Function
    ops.reset_launch_counts()
    block(x.clone().requires_grad_(), ctx).float().sum().backward()
    assert ops.launch_counts() == dict(zero, flash_attention=1, flash_attention_bwd=1)
    assert all(p.grad is not None for p in block.parameters())


def test_checkpointed_block_gradient_kernels_vs_plain(cuda, monkeypatch):
    """A BasicTransformerBlock at the UNet's 32² width (fp32 weights, bf16
    autocast, recomputed under torch.utils.checkpoint, as the finetune runs
    it): the gradients of its input and parameters with kernel 1 forward and
    backward against the same block on the plain path, each relative to its
    largest entry, both against the block in fp32 (plain): the kernels' error
    within twice the plain path's plus EPS."""
    from torch.utils.checkpoint import checkpoint

    from videomv_tpu_torch.models.blocks import BasicTransformerBlock
    from videomv_tpu_torch.ops import attention as attn_mod
    from videomv_tpu_torch.training.checkpoints import init_weights

    block = init_weights(BasicTransformerBlock(320, 5, 64, context_dim=1024), seed=8,
                         zero_init=False).to(cuda).train()
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _randn(gen, cuda, 8, 1024, 320, dtype=torch.float32)
    ctx = _randn(gen, cuda, 8, 77, 1024, dtype=torch.float32)
    go = _randn(gen, cuda, 8, 1024, 320, dtype=torch.float32)

    def grads(autocast):
        xi = x.clone().requires_grad_()
        block.zero_grad()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            out = checkpoint(block, xi, ctx, use_reentrant=False)
        out.float().backward(go)
        return [xi.grad] + [p.grad.clone() for p in block.parameters()]

    ops.reset_launch_counts()
    kern = grads(True)
    assert ops.launch_counts() == dict(dict.fromkeys(ops.launch_counts(), 0),
                                       flash_attention=2, flash_attention_bwd=1)
    monkeypatch.setattr(attn_mod, "attention_eligible", lambda *a: False)
    ops.reset_launch_counts()
    plain = grads(True)
    ref = grads(False)
    assert not any(ops.launch_counts().values())
    for i, (g, p, r) in enumerate(zip(kern, plain, ref)):
        k_err, p_err = _rel_max([g], [r]), _rel_max([p], [r])
        assert k_err <= 2 * p_err + EPS, (i, k_err, p_err)


def _spatial_block(dev, c, heads, cc, seed=9):
    from videomv_tpu_torch.models.blocks import SpatialTransformer
    from videomv_tpu_torch.ops.fused_spatial import spatial_params
    from videomv_tpu_torch.training.checkpoints import init_weights

    mod = init_weights(SpatialTransformer(c, heads, 64, depth=1, context_dim=cc), seed=seed,
                       zero_init=False)
    mod = mod.to(device=dev, dtype=torch.bfloat16).eval().requires_grad_(False)
    return mod, spatial_params(mod, vector_dtype=torch.float32)


# (rows, tokens, C, heads, context tokens, context width) at the kernel's one
# width: the CPU tests' rows and context, one 64-token tile, the I2V context,
# a context of a single token, one key past a 128-key tile
@pytest.mark.parametrize("r,s,c,heads,kv_len,cc", [
    (2, 512, 320, 5, 7, 1024), (3, 64, 320, 5, 64, 1024), (1, 1024, 320, 5, 145, 1024),
    (2, 576, 320, 5, 1, 1024), (2, 1024, 320, 5, 129, 1024)])
def test_fused_spatial_matches_its_fp32_twin(cuda, r, s, c, heads, kv_len, cc):
    """Error against the fp32 twin within twice the bf16 module path's."""
    from videomv_tpu_torch.ops.fused_spatial import (
        fused_spatial_transformer, spatial_block_reference)

    mod, params = _spatial_block(cuda, c, heads, cc)
    gen = torch.Generator(device=cuda).manual_seed(r + s + c)
    x = _randn(gen, cuda, r, s, c)
    ctx = _randn(gen, cuda, r, kv_len, cc)
    ops.reset_launch_counts()
    with torch.no_grad():
        kern = fused_spatial_transformer(x, ctx, params, heads)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_spatial"] == 1
        assert ops.launch_counts_by_shape()["fused_spatial"] == {(r, s, c, kv_len): 1}
        twin = spatial_block_reference(x, ctx, params, heads).float()
        # the module composition on the same tokens as a [r, c, s, 1] image
        module = mod(x.transpose(1, 2).reshape(r, c, s, 1).contiguous(), ctx)
        module = module.reshape(r, c, s).transpose(1, 2)
    assert ops.launch_counts()["fused_spatial"] == 1  # no flag: the module path
    k_err = (kern.float() - twin).abs().max().item()
    m_err = (module.float() - twin).abs().max().item()
    assert torch.isfinite(kern.float()).all()
    assert k_err <= 2 * m_err + EPS, (k_err, m_err)


def _spatial_errors(mod, params, x, ctx, heads):
    """The kernel's and the bf16 module path's max error against the fp32
    twin, and the kernel's output."""
    from videomv_tpu_torch.ops import fused_spatial as fs

    r, s, c = x.shape
    with torch.no_grad():
        kern = fs._launch(x, ctx, params, heads)
        torch.cuda.synchronize()
        twin = fs.spatial_block_reference(x, ctx, params, heads).float()
        module = mod(x.transpose(1, 2).reshape(r, c, s, 1).contiguous(), ctx)
        module = module.reshape(r, c, s).transpose(1, 2)
    k_err = (kern.float() - twin).abs().max().item()
    m_err = (module.float() - twin).abs().max().item()
    return k_err, m_err, kern


# the wgmma kernel at the served width (C 320, 5 heads, Cc 1024): contexts of
# one key, under one 128-key tile, one tile exactly, one key past it, the I2V
# context; 1, 24 and 48 rows; a sequence of an odd number of 128-key tiles
@pytest.mark.parametrize("r,s,kv_len", [
    (1, 1024, 1), (1, 1024, 77), (1, 1024, 128), (1, 1024, 129), (1, 1024, 145),
    (24, 1024, 145), (48, 1024, 145), (2, 640, 77)])
def test_fused_spatial_wgmma_matches_its_fp32_twin(cuda, r, s, kv_len):
    from videomv_tpu_torch.ops import fused_spatial as fs

    mod, params = _spatial_block(cuda, 320, 5, 1024)
    gen = torch.Generator(device=cuda).manual_seed(r + s + kv_len)
    x = _randn(gen, cuda, r, s, 320)
    ctx = _randn(gen, cuda, r, kv_len, 1024)
    ops.reset_launch_counts()
    k_err, m_err, kern = _spatial_errors(mod, params, x, ctx, 5)
    assert ops.launch_counts()["fused_spatial"] == 1
    assert torch.isfinite(kern.float()).all()
    assert k_err <= 2 * m_err + EPS, (k_err, m_err)
    with torch.no_grad():  # one writer per element: two launches bit-equal
        assert torch.equal(fs._launch(x, ctx, params, 5), kern)


def test_fused_spatial_other_shapes_take_the_module_path(cuda, monkeypatch):
    """A width or context the kernel is not built for is refused by the
    wrapper, never launched; with the switch on, the module runs such a block
    on its own composition (kernels 1 and 2 and PyTorch ops)."""
    from videomv_tpu_torch.ops import fused_spatial as fs

    gen = torch.Generator(device=cuda).manual_seed(3)
    mod128, params128 = _spatial_block(cuda, 128, 2, 96)
    x128, ctx96 = _randn(gen, cuda, 2, 512, 128), _randn(gen, cuda, 2, 7, 96)
    _, params1536 = _spatial_block(cuda, 320, 5, 1536)
    x, ctx1536 = _randn(gen, cuda, 2, 1024, 320), _randn(gen, cuda, 2, 7, 1536)
    ops.reset_launch_counts()
    with torch.no_grad():
        for args in ((x128, ctx96, params128, 2), (x, ctx1536, params1536, 5)):
            with pytest.raises(ValueError, match="the kernel takes C = 320"):
                fs.fused_spatial_transformer(*args)
        assert ops.launch_counts()["fused_spatial"] == 0
        monkeypatch.setenv(fs.ENV_FLAG, "1")
        out = mod128(x128.transpose(1, 2).reshape(2, 128, 16, 32).contiguous(), ctx96)
    assert ops.launch_counts()["fused_spatial"] == 0
    assert ops.launch_counts()["flash_attention"] == 1 and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("kv_len", [145, 77])
def test_fused_spatial_wgmma_large_logits(cuda, kv_len):
    """Query and key rows scaled up so that logits reach the hundreds: the
    online softmax of both attentions and the merge of the split head must
    neither overflow nor lose a maximum that arrives in a later tile."""
    mod, params = _spatial_block(cuda, 320, 5, 1024)
    params = dict(params)
    for n in ("wq1", "wk1", "wq2", "wk2"):
        params[n] = (params[n].float() * 4).bfloat16()
    with torch.no_grad():  # the module path with the same weights
        attn1, attn2 = mod.transformer_blocks[0].attn1, mod.transformer_blocks[0].attn2
        for lin, n in ((attn1.to_q, "wq1"), (attn1.to_k, "wk1"), (attn2.to_q, "wq2"),
                       (attn2.to_k, "wk2")):
            lin.weight.copy_(params[n])
    gen = torch.Generator(device=cuda).manual_seed(kv_len)
    x = _randn(gen, cuda, 2, 1024, 320)
    ctx = _randn(gen, cuda, 2, kv_len, 1024)
    x[:, -3] *= 8   # a dominant key late in the self-attention's last tile
    ctx[:, -1] *= 8
    k_err, m_err, kern = _spatial_errors(mod, params, x, ctx, 5)
    assert torch.isfinite(kern.float()).all()
    assert k_err <= 2 * m_err + EPS, (k_err, m_err)


def test_fused_spatial_rejects_what_it_cannot_take(cuda):
    from videomv_tpu_torch.ops.fused_spatial import fused_spatial_transformer

    _, params = _spatial_block(cuda, 320, 5, 1024)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x, ctx = _randn(gen, cuda, 2, 128, 320), _randn(gen, cuda, 2, 7, 1024)
    fused_spatial_transformer(x, ctx, params, 5)  # fine
    with pytest.raises(ValueError):
        fused_spatial_transformer(x.float(), ctx, params, 5)  # fp32 x
    with pytest.raises(ValueError):
        fused_spatial_transformer(x[:, :100].contiguous(), ctx, params, 5)  # S % 64 != 0
    with pytest.raises(ValueError):
        fused_spatial_transformer(x, ctx, params, 4)  # C != heads·64
    with pytest.raises(ValueError):
        fused_spatial_transformer(x.transpose(0, 1).contiguous().transpose(0, 1), ctx, params, 5)
    with pytest.raises(ValueError):
        fused_spatial_transformer(x, ctx[:1], params, 5)  # rows disagree
    with pytest.raises(ValueError):
        fused_spatial_transformer(x, ctx, dict(params, bin=params["bin"].bfloat16()), 5)
    with pytest.raises(ValueError):
        fused_spatial_transformer(x, ctx, dict(params, wk2=params["wk1"]), 5)  # [C, Cc] wanted
    with pytest.raises(ValueError):
        fused_spatial_transformer(x, ctx, {k: v for k, v in params.items() if k != "b2"}, 5)
    with pytest.raises(ValueError):
        fused_spatial_transformer(x, ctx.cpu(), params, 5)  # another device


def test_fused_spatial_backward_is_the_twins(cuda):
    from videomv_tpu_torch.ops.fused_spatial import (
        fused_spatial_transformer, spatial_block_reference)

    _, params = _spatial_block(cuda, 320, 5, 1024)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = _randn(gen, cuda, 2, 256, 320).requires_grad_()
    ctx = _randn(gen, cuda, 2, 7, 1024).requires_grad_()
    pg = {k: v.clone().requires_grad_() for k, v in params.items()}
    go = _randn(gen, cuda, 2, 256, 320)
    ops.reset_launch_counts()
    out = fused_spatial_transformer(x, ctx, pg, 5)
    assert ops.launch_counts()["fused_spatial"] == 1 and out.requires_grad
    got = torch.autograd.grad(out, [x, ctx, *pg.values()], go)
    assert ops.launch_counts()["fused_spatial"] == 1  # the backward launches nothing
    want = torch.autograd.grad(spatial_block_reference(x, ctx, pg, 5), [x, ctx, *pg.values()], go)
    assert _rel_max(got, want) <= 1e-3


def test_spatial_transformer_dispatch_follows_the_flag(cuda, monkeypatch):
    """Flag off: kernels 1 and 2; flag on: kernel 5 alone, in eval mode, at
    the eligible stage only."""
    from videomv_tpu_torch.ops.fused_spatial import ENV_FLAG

    mod, _ = _spatial_block(cuda, 320, 5, 1024)
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _randn(gen, cuda, 4, 320, 32, 32)
    ctx = _randn(gen, cuda, 4, 145, 1024)
    zero = dict.fromkeys(ops.launch_counts(), 0)
    monkeypatch.delenv(ENV_FLAG, raising=False)
    with torch.no_grad():
        ops.reset_launch_counts()
        off = mod(x, ctx)
        assert ops.launch_counts() == dict(zero, flash_attention=1, geglu_ffn=1)
        monkeypatch.setenv(ENV_FLAG, "1")
        ops.reset_launch_counts()
        on = mod(x, ctx)
        assert ops.launch_counts() == dict(zero, fused_spatial=1)
        assert on.shape == off.shape and on.dtype == torch.bfloat16
        # both are bf16 roundings of one function
        assert (on.float() - off.float()).abs().max().item() <= 0.25
        ops.reset_launch_counts()
        mod(x[:, :, :16, :16].contiguous(), ctx)  # 256 tokens: not eligible
        # (4 x 256 tokens are also below the FFN kernel's gate)
        assert ops.launch_counts() == dict(zero, flash_attention=1)
        ops.reset_launch_counts()
        mod.train()(x, ctx)  # training mode: the module path, the FFN gate closed
        assert ops.launch_counts() == dict(zero, flash_attention=1)


# ----------------------------------------------------- kernel 6: GroupNorm

# (N, C, F, H·W side, permuted): T2V's temporal norms at 48 and 24 rows,
# its spatial ones, SV3D's temporal and spatial at 72², its 9² and 18²
# temporal (channels of 81 and 324 elements: element stores), the VAE decoder's largest
# groups at 256² and 576² (C 256 at 576² streams)
GN_SHAPES = [(2, 320, 24, 32, True), (1, 320, 24, 32, True), (48, 320, 1, 32, False),
             (2, 320, 21, 72, True), (42, 320, 1, 72, False), (2, 1280, 21, 9, True),
             (2, 1280, 21, 18, True),
             (2, 256, 1, 256, False), (2, 128, 1, 576, False), (1, 256, 1, 576, False),
             (2, 2560, 24, 4, True)]


def _gn_input(gen, dev, n, c, f, hw, permuted):
    """bf16 x [n, c, f, hw, hw] with a mean away from 0; ``permuted``: the
    UNets' temporal view of a contiguous [n·f, c, hw, hw]."""
    if permuted:
        x = _randn(gen, dev, n * f, c, hw, hw, scale=1.5)
        x = (x + 0.5).reshape(n, f, c, hw, hw).permute(0, 2, 1, 3, 4)
        assert not x.is_contiguous()
        return x
    return _randn(gen, dev, n, c, f, hw, hw, scale=1.5) + 0.5


def _gn_affine(gen, dev, c):
    return (_randn(gen, dev, c, scale=0.1) + 1.0, _randn(gen, dev, c, scale=0.1))


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", GN_SHAPES)
def test_group_norm_matches_fp32(cuda, shape, silu):
    from videomv_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device=cuda).manual_seed(5)
    n, c, f, hw, permuted = shape
    x = _gn_input(gen, cuda, n, c, f, hw, permuted)
    w, b = _gn_affine(gen, cuda, c)
    eps = 1e-6 if shape[0] != 48 else 1e-5
    ops.reset_launch_counts()
    kern = gn.group_norm(x, w, b, 32, eps, silu)
    torch.cuda.synchronize()
    assert ops.launch_counts_by_shape()["group_norm"] == {(n, c, f * hw * hw, silu): 1}
    assert kern.is_contiguous() and kern.shape == x.shape
    twin = gn.group_norm_reference(x, w, b, 32, eps, silu)
    ref32 = F.group_norm(x.float(), 32, w.float(), b.float(), eps)
    ref32 = F.silu(ref32) if silu else ref32
    ok, errs = _within_bound(kern, twin, ref32)
    assert ok, errs
    # one writer per element, sums in a fixed order: two runs bit-equal
    assert torch.equal(gn.group_norm(x, w, b, 32, eps, silu), kern)


@pytest.mark.parametrize("layout", ["channels_last", "transposed"])
def test_group_norm_copies_what_it_does_not_read_in_place(cuda, layout):
    from videomv_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _randn(gen, cuda, 6, 320, 32, 32, scale=1.5) + 0.5
    x = (x.contiguous(memory_format=torch.channels_last) if layout == "channels_last"
         else x.transpose(2, 3))
    assert gn.kernel_layout(x, 32) is None
    w, b = _gn_affine(gen, cuda, 320)
    kern = gn.group_norm(x, w, b, 32, 1e-5, True)
    twin = gn.group_norm_reference(x, w, b, 32, 1e-5, True)
    ref32 = F.silu(F.group_norm(x.float(), 32, w.float(), b.float(), 1e-5))
    ok, errs = _within_bound(kern, twin, ref32)
    assert ok and kern.is_contiguous(), errs


def test_group_norm_in_a_cuda_graph(cuda):
    from videomv_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device=cuda).manual_seed(6)
    x = _gn_input(gen, cuda, 2, 320, 24, 32, True)
    w, b = _gn_affine(gen, cuda, 320)
    eager = gn.group_norm(x, w, b, 32, 1e-5, True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = gn.group_norm(x, w, b, 32, 1e-5, True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    x.copy_(_gn_input(gen, cuda, 2, 320, 24, 32, True))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, gn.group_norm(x, w, b, 32, 1e-5, True))


def test_group_norm_module_dispatch(cuda):
    from videomv_tpu_torch.models.blocks import GroupNorm, TemporalConvBlockV2
    from videomv_tpu_torch.utils import profiling

    block = TemporalConvBlockV2(320).to(cuda, torch.bfloat16).eval()
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = _gn_input(gen, cuda, 2, 320, 24, 16, True)
    profiling.reset_counts(["gn.plain"])
    ops.reset_launch_counts()
    with torch.no_grad():
        out = block(x)
    # four norms with their SiLU fused, the first on the permuted input
    assert ops.launch_counts_by_shape()["group_norm"] == {(2, 320, 24 * 256, True): 4}
    assert profiling.counts_by_shape("gn.plain") == {}
    norm = GroupNorm(32, 320).to(cuda, torch.bfloat16)
    with torch.no_grad():
        norm(x)  # training mode: plain, counted
    assert profiling.counts_by_shape("gn.plain") == {(2, 320, 24 * 256, False): 1}
    assert out.shape == x.shape and torch.isfinite(out.float()).all()


def test_group_norm_rejects_what_it_cannot_take(cuda):
    from videomv_tpu_torch.ops import group_norm as gn

    w = torch.ones(64, device=cuda, dtype=torch.bfloat16)
    x = torch.zeros(2, 64, 8, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gn.group_norm(torch.zeros_like(x[:, :48]), w[:48], w[:48], 32, 1e-5)  # 32 ∤ 48
    with pytest.raises(ValueError):
        gn.group_norm(x.float(), w, w, 32, 1e-5)
    with pytest.raises(ValueError):
        gn.group_norm(x, w[:32], w, 32, 1e-5)
