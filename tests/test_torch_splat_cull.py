"""The culled composite kernel's plain mirrors on the CPU: the conservative
per-pair box and its 8-bit mask of warp blocks (``splat.cull_masks``), the
twin with every point outside the masks forced dead, and the heaviest-first
order of (view, tile) items (``splat.heaviest_first``). The kernel itself
runs only on the card (``tests/test_torch_gpu_kernels.py``); here its test
is held against every alive (pixel, pair) point of binned renders, and the
masked twin against the unmasked one and the Pallas kernel in interpret
mode."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videomv_tpu.ops.splat_pallas as jsp
from torch_port_helpers import set_torch_threads
from videomv_tpu.data.cameras import GSCameraSettings as JGSCameraSettings
from videomv_tpu.data.cameras import orbit_c2w_opengl as jorbit_c2w_opengl
from videomv_tpu.data.cameras import prepare_gs_training as jprepare_gs_training
from videomv_tpu.ops import gaussian_splat as jgs
from videomv_tpu_torch.data.cameras import (
    GSCameraSettings, orbit_c2w_opengl, prepare_gs_training)
from videomv_tpu_torch.ops import _build
from videomv_tpu_torch.ops import gaussian_splat as tgs
from videomv_tpu_torch.ops import splat

set_torch_threads()

IMG = 64
# the twin against the Pallas kernel, as in tests/test_torch_splat.py: fp32
# both, a running product against exp of a cumulative log sum
TOL = 1e-5


def _gaussians(n, seed):
    """Seeded Gaussians in the LGM's activation ranges, with anisotropic
    scales (elongated splats, near-degenerate conics) and opacities down to
    0, below and around the 1/255 cut."""
    rs = np.random.default_rng(seed)
    quat = rs.normal(size=(n, 4))
    opacity = np.where(rs.uniform(size=n) < 0.2, rs.uniform(0.0, 0.01, n),
                       rs.uniform(0.05, 1.0, n))
    return np.concatenate([
        rs.uniform(-0.6, 0.6, (n, 3)), opacity[:, None],
        np.exp(rs.uniform(np.log(0.002), np.log(0.06), (n, 3))),
        quat / np.linalg.norm(quat, axis=1, keepdims=True),
        rs.uniform(0, 1, (n, 3))], axis=1).astype(np.float32)


def _binned(seed, packed, max_pairs, n=320, views=2):
    g = torch.from_numpy(_gaussians(n, seed))
    st = GSCameraSettings(input_size=IMG, output_size=IMG)
    cams = prepare_gs_training(orbit_c2w_opengl(views, 10.0, 1.5), st, ray_size=16)
    prep = {k: v[None] for k, v in tgs.prepare_gaussians(g).items()}
    proj = tgs.project_prepared(prep, torch.from_numpy(cams["cam_view"][0]),
                                torch.from_numpy(cams["cam_view_proj"][0]), IMG,
                                st.tan_half_fov)
    return splat.bin_pairs(*proj, img_size=IMG, max_pairs=max_pairs, packed=packed)


def _alive(payload, tile_start, tile_count, nts):
    """``[pairs, 256]`` bool (every pair of every segment, in view and
    payload order, against the 256 pixels of its tile) and each pair's
    ``(view, position)``: alive where power <= 0 and alpha >= 1/255, with
    power and alpha rounded op by op in the kernel's order."""
    R, rows, _ = payload.shape
    T = nts * nts
    count = tile_count.reshape(-1).long()
    flat = torch.arange(R * T).repeat_interleave(count)
    first = torch.cumsum(count, 0) - count
    pos = (tile_start.reshape(-1).long().repeat_interleave(count)
           + torch.arange(int(count.sum())) - first.repeat_interleave(count))
    view, tile = flat // T, flat % T
    d = payload[view, :, pos]
    op = splat._unpack2(d[:, 6])[1] if rows == 8 else d[:, 8]
    p = torch.arange(256)
    px = ((tile % nts) * 16)[:, None].float() + (p % 16).float()
    py = ((tile // nts) * 16)[:, None].float() + (p // 16).float()
    dx, dy = px - d[:, 0:1], py - d[:, 1:2]
    quad = (d[:, 2:3] * dx) * dx + (d[:, 4:5] * dy) * dy
    power = -0.5 * quad - (d[:, 3:4] * dx) * dy
    alpha = torch.clamp_max(op[:, None] * torch.exp(power), 0.99)
    return (power <= 0.0) & (alpha >= 1.0 / 255.0), view, pos


@pytest.mark.parametrize("max_pairs", [1 << 13, 96])  # 96 overflows
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_hold_every_alive_point(seed, packed, max_pairs):
    payload, ts, tc, pairs = _binned(seed, packed, max_pairs)
    assert (pairs > max_pairs).all() == (max_pairs == 96), pairs
    masks = splat.cull_masks(payload, ts, tc, IMG // 16)
    alive, view, pos = _alive(payload, ts, tc, IMG // 16)
    assert alive.any()
    bits = (masks[view, pos].long()[:, None] >> splat.pixel_blocks()[None, :]) & 1
    assert not (alive & (bits == 0)).any()
    # outside the segments every mask is empty
    inside = torch.zeros_like(masks, dtype=torch.bool)
    inside[view, pos] = True
    assert (masks[~inside] == 0).all()
    # and the masks do cull: a fraction of the (block, pair) combinations
    kept = bits.reshape(-1, 256).float().mean().item()
    alive_blocks = torch.zeros(alive.shape[0], 8, dtype=torch.bool)
    alive_blocks.index_put_((torch.arange(alive.shape[0])[:, None].expand(-1, 256),
                             splat.pixel_blocks()[None, :].expand(alive.shape[0], -1)),
                            alive, accumulate=True)
    assert alive_blocks.float().mean().item() <= kept < 0.75, kept


@pytest.mark.parametrize("seed", [0, 1])
def test_masks_hold_every_alive_point_of_random_conics(seed):
    """Pairs drawn to press on the test's edges: conics from round to 1:300
    elongated at every angle, means in and around one tile, opacities from
    just below the cut to 1."""
    rs = np.random.default_rng(seed)
    n = 4096
    angle = rs.uniform(0, np.pi, n)
    s1 = np.exp(rs.uniform(np.log(0.3), np.log(30.0), n))
    s2 = s1 / np.exp(rs.uniform(0, np.log(300.0), n))
    rot = np.stack([np.cos(angle), -np.sin(angle), np.sin(angle), np.cos(angle)], 1)
    rot = rot.reshape(n, 2, 2)
    inv_cov = rot @ np.stack([np.diag([1 / a ** 2, 1 / b ** 2]) for a, b in zip(s1, s2)]) @ (
        rot.transpose(0, 2, 1))
    th = 1.0 / 255.0
    cols = [dict(mx=float(m[0]), my=float(m[1]), a=float(ic[0, 0]), b=float(ic[0, 1]),
                 c=float(ic[1, 1]), o=float(o))
            for m, ic, o in zip(rs.uniform(-24, 40, (n, 2)), inv_cov,
                                np.where(rs.uniform(size=n) < 0.3,
                                         th * rs.uniform(0.999, 1.01, n), rs.uniform(0, 1, n)))]
    payload, ts, tc = _segment_payload(16, cols)
    masks = splat.cull_masks(payload, ts, tc, 1)
    alive, view, pos = _alive(payload, ts, tc, 1)
    assert alive.any() and (masks != 0).any() and (masks != 255).any()
    bits = (masks[view, pos].long()[:, None] >> splat.pixel_blocks()[None, :]) & 1
    assert not (alive & (bits == 0)).any()


def _segment_payload(rows, columns):
    """One 16² tile (view 0) holding the given pairs, each a dict of
    payload fields, as a ``[1, rows, P]`` payload and its segment."""
    P = len(columns)
    pay = torch.zeros(1, rows, P)
    for j, col in enumerate(columns):
        if not col:
            continue  # a zero (dead) pair
        for r, key in enumerate(("mx", "my", "a", "b", "c")):
            pay[0, r, j] = col[key]
        if rows == 8:
            one = torch.tensor([1.0])
            pay[0, 5, j] = splat._pack2(one * 0.5, one * 0.25)[0]
            pay[0, 6, j] = splat._pack2(one * 0.75, torch.tensor([col["o"]]))[0]
            pay[0, 7, j] = splat._pack2(one * 2.0, one * 0.0)[0]
        else:
            pay[0, 5:8, j] = torch.tensor([0.5, 0.25, 0.75])
            pay[0, 8, j] = col["o"]
            pay[0, 9, j] = 2.0
    return pay, torch.zeros(1, 1, dtype=torch.int32), torch.full((1, 1), P, dtype=torch.int32)


@pytest.mark.parametrize("rows", [16, 8])
def test_dead_and_faint_pairs_get_no_block(rows):
    th = np.float32(1.0 / 255.0)
    small = dict(mx=7.5, my=7.5, a=2.0, b=0.0, c=2.0)
    cols = [{}, dict(small, o=0.0), dict(small, o=1e-3), dict(small, o=0.5 / 255.0),
            dict(small, o=float(th * np.float32(1 - 2.0 ** -9))), dict(small, o=0.8)]
    masks = splat.cull_masks(*_segment_payload(rows, cols), 1)[0]
    assert masks[:-1].tolist() == [0] * (len(cols) - 1)
    assert 0 < masks[-1].item() < 255  # a small splat at the centre meets some blocks


@pytest.mark.parametrize("rows", [16, 8])
def test_degenerate_conic_gets_every_block(rows):
    far = dict(mx=-40.0, my=-40.0, o=0.9)  # far from the tile: culled when well formed
    cols = [dict(far, a=0.0, b=0.0, c=1.0), dict(far, a=-1.0, b=0.0, c=1.0),
            dict(far, a=1.0, b=2.0, c=1.0), dict(far, a=1.0, b=1.0, c=1.0),
            dict(far, a=1.0, b=0.0, c=float("nan")), dict(far, a=1e30, b=0.0, c=1e30),
            dict(far, a=1.0, b=0.0, c=1.0, o=float("nan")), dict(far, a=1.0, b=0.0, c=1.0)]
    masks = splat.cull_masks(*_segment_payload(rows, cols), 1)[0]
    assert masks.tolist() == [255] * (len(cols) - 1) + [0]


def _jproj(g, cv, cvp, img):
    return [np.asarray(a) for a in jgs.project_gaussians(
        jnp.asarray(g), jnp.asarray(cv), jnp.asarray(cvp), img,
        float(np.tan(0.5 * np.deg2rad(39.6))))]


@pytest.mark.parametrize("packed", [False, True])
def test_masked_twin_is_bit_equal_and_matches_pallas_interpret(monkeypatch, packed):
    monkeypatch.setattr(jsp, "INTERPRET", True)
    img = 32
    g = _gaussians(192, seed=5)
    st = JGSCameraSettings(input_size=img, output_size=img)
    cams = jprepare_gs_training(jorbit_c2w_opengl(2, 10.0, 1.5), st, ray_size=16)
    payload, ts, tc, nts = jsp._bin_pairs(
        *(jnp.asarray(a) for a in _jproj(g, cams["cam_view"][0][1], cams["cam_view_proj"][0][1],
                                         img)),
        img_size=img, max_pairs=1 << 12, max_span=splat.MAX_SPAN, packed=packed)
    want = np.asarray(jsp._composite_call(payload, ts, tc, nts))
    args = (torch.from_numpy(np.array(payload))[None], torch.from_numpy(np.array(ts))[None],
            torch.from_numpy(np.array(tc))[None], nts)
    masks = splat.cull_masks(*args)
    assert 0 < (masks > 0).sum() and (masks[:, :int(tc.sum())] != 255).any()
    plain = splat.composite_reference(*args, chunk=32)
    culled = splat.composite_reference(*args, chunk=32, masks=masks)
    assert want[:, 3].max() > 0.5  # the view is covered
    assert torch.equal(culled, plain)
    np.testing.assert_allclose(culled[0].numpy(), want, rtol=TOL, atol=TOL)
    # a mask that leaves out alive points does change the output
    assert not torch.equal(splat.composite_reference(*args, chunk=32, masks=masks & 0xF0), plain)


@pytest.mark.parametrize("seed", [0, 3])
def test_heaviest_first_is_a_sorted_permutation(seed):
    _, _, tc, _ = _binned(seed, False, 1 << 13, views=3)
    rs = np.random.default_rng(seed)
    ties = torch.from_numpy(rs.integers(0, 4, (2, 25)).astype(np.int32))  # many ties
    for counts in (tc, ties):
        order = splat.heaviest_first(counts)
        assert order.dtype == torch.int32
        assert sorted(order.tolist()) == list(range(counts.numel()))
        by = counts.reshape(-1)[order.long()]
        assert (by[:-1] >= by[1:]).all()
        # ties keep index order (a stable sort)
        tied = by[:-1] == by[1:]
        assert (order[:-1][tied] < order[1:][tied]).all()


def test_block_geometry_matches_the_kernel_source():
    """The mirror's warp blocks and bit order are the CUDA kernels': the block
    shape and the margins from the header both culled kernels include, and
    the forward's pixel of each lane in both (the backward has no geometry of
    its own)."""
    src = open(os.path.join(_build.CSRC_DIR, "splat_cull.cuh")).read()
    assert re.search(r"kBlockW = (\d+), kBlockH = (\d+);", src).groups() == (
        str(splat.BLOCK_W), str(splat.BLOCK_H))
    for kernel in ("splat_composite.cu", "splat_composite_bwd.cu"):
        text = open(os.path.join(_build.CSRC_DIR, kernel)).read()
        assert '#include "splat_cull.cuh"' in text, kernel
        assert "kBlockW =" not in text and "kBlockH =" not in text, kernel
        assert "const int ix = (warp & 1) * kBlockW + (lane & (kBlockW - 1));" in text, kernel
        assert "const int iy = (warp >> 1) * kBlockH + (lane >> 3);" in text, kernel
    blocks = splat.pixel_blocks()
    # warp w holds its 32 lanes' pixels; the mirror names that warp's block
    for warp in range(8):
        for lane in (0, 7, 8, 31):
            ix = (warp & 1) * splat.BLOCK_W + (lane & (splat.BLOCK_W - 1))
            iy = (warp >> 1) * splat.BLOCK_H + (lane >> 3)
            assert blocks[iy * 16 + ix].item() == warp
    # the margins: the same values on both sides
    for name, value in splat.CULL_MARGINS.items():
        m = re.search(rf"constexpr float {name} = ([0-9.e+-]+)f;", src)
        assert m and float(m.group(1)) == value, name


def test_variant_on_cpu_runs_the_twin():
    payload, ts, tc, _ = _binned(0, True, 1 << 13)
    want = splat.composite_reference(payload, ts, tc, IMG // 16)
    for variant in splat.VARIANT_NAMES:
        got = splat._composite_forward(payload, ts, tc, IMG // 16, variant=variant)
        assert torch.equal(got, want)
