"""The port's splat path against the JAX package, fp32 on the CPU: the
projection, the bf16 packing, the tile binning (bit for bit, including an
overflowing capacity), the composite twin against the Pallas kernel in
interpret mode, the dense oracle, and the whole binned render. On the CPU
the composite wrapper runs its plain twin and launches nothing."""

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
from videomv_tpu_torch import ops
from videomv_tpu_torch.ops import gaussian_splat as tgs
from videomv_tpu_torch.ops import splat

set_torch_threads()

IMG = 32
TAN = float(np.tan(0.5 * np.deg2rad(39.6)))
# fp32 on both sides; the two composites take the same products in
# another order (running product here, exp of a cumulative log sum there)
TOL = 1e-5


@pytest.fixture()
def interpret(monkeypatch):
    monkeypatch.setattr(jsp, "INTERPRET", True)


def _scene(n, seed, views=2):
    """Gaussians in the LGM's activation ranges and ``views`` orbit cameras
    (as ``tests/test_pallas_kernels.py`` builds them)."""
    rs = np.random.default_rng(seed)
    quat = rs.normal(size=(n, 4))
    g = np.concatenate([
        rs.uniform(-0.7, 0.7, (n, 3)), rs.uniform(0.2, 1.0, (n, 1)),
        rs.uniform(0.02, 0.08, (n, 3)), quat / np.linalg.norm(quat, axis=1, keepdims=True),
        rs.uniform(0, 1, (n, 3))], axis=1).astype(np.float32)
    st = JGSCameraSettings(input_size=64, output_size=64)
    cams = jprepare_gs_training(jorbit_c2w_opengl(views, 10.0, 1.5), st, ray_size=16)
    return g, cams["cam_view"][0], cams["cam_view_proj"][0]


@pytest.fixture(scope="module")
def scene():
    return _scene(192, seed=0)


def _jproj(g, cv, cvp):
    return [np.asarray(a) for a in jgs.project_gaussians(
        jnp.asarray(g), jnp.asarray(cv), jnp.asarray(cvp), IMG, TAN)]


def test_project_prepared_matches_jax(scene):
    g, cv, cvp = scene
    want = _jproj(g, cv[0], cvp[0])
    got = [a.numpy() for a in tgs.project_gaussians(
        torch.from_numpy(g), torch.from_numpy(cv[0]), torch.from_numpy(cvp[0]), IMG, TAN)]
    names = ("mean2d", "inv_cov", "depth", "radius", "color", "opacity", "valid")
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        if name == "valid":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)
    # several views at once broadcast like one view at a time
    multi = tgs.project_prepared(tgs.prepare_gaussians(torch.from_numpy(g)),
                                 torch.from_numpy(cv), torch.from_numpy(cvp), IMG, TAN)
    np.testing.assert_array_equal(multi[0][0].numpy(), got[0])


def test_pack_unpack_bit_exact_vs_jax():
    rs = np.random.default_rng(3)
    a = np.concatenate([rs.standard_normal(1000) * 10.0 ** rs.integers(-8, 8, 1000),
                        [0.0, -0.0, 1.0, 0.99, 1e-40, 3e38]]).astype(np.float32)
    b = np.roll(a, 7)
    want = np.asarray(jsp._pack2(jnp.asarray(a), jnp.asarray(b)))
    got = splat._pack2(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    for g_half, w_half in zip(splat._unpack2(torch.from_numpy(got)),
                              jsp._unpack2(jnp.asarray(want))):
        np.testing.assert_array_equal(g_half.numpy().view(np.uint32),
                                      np.asarray(w_half).view(np.uint32))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("max_pairs", [1 << 12, 128])  # 128 overflows
def test_bin_pairs_bit_exact_vs_jax(scene, packed, max_pairs):
    g, cv, cvp = scene
    projs = [_jproj(g, cv[v], cvp[v]) for v in range(2)]
    got = splat.bin_pairs(*(torch.from_numpy(np.stack(a)) for a in zip(*projs)),
                          img_size=IMG, max_pairs=max_pairs, packed=packed)
    pairs = got[3].numpy()
    if max_pairs == 128:
        assert (pairs > max_pairs).all(), pairs  # the capacity does overflow
    for v, proj in enumerate(projs):
        want = jsp._bin_pairs(*(jnp.asarray(a) for a in proj), img_size=IMG,
                              max_pairs=max_pairs, max_span=splat.MAX_SPAN, packed=packed)
        np.testing.assert_array_equal(got[1][v].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2][v].numpy(), np.asarray(want[2]))
        np.testing.assert_array_equal(got[0][v].numpy().view(np.uint32),
                                      np.asarray(want[0]).view(np.uint32))
        assert int((got[1][v] + got[2][v]).max()) <= max_pairs


@pytest.mark.parametrize("packed", [False, True])
def test_composite_twin_matches_pallas_interpret(scene, interpret, packed):
    g, cv, cvp = scene
    payload, ts, tc, nts = jsp._bin_pairs(
        *(jnp.asarray(a) for a in _jproj(g, cv[1], cvp[1])), img_size=IMG,
        max_pairs=1 << 12, max_span=splat.MAX_SPAN, packed=packed)
    want = np.asarray(jsp._composite_call(payload, ts, tc, nts))
    got = splat.composite_reference(
        torch.from_numpy(np.asarray(payload))[None], torch.from_numpy(np.asarray(ts))[None],
        torch.from_numpy(np.asarray(tc))[None], nts, chunk=32)[0].numpy()
    assert want[:, 3].max() > 0.5  # the view is covered
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_composite_wrapper_on_cpu_runs_the_twin(scene):
    g, cv, cvp = scene
    proj = [torch.from_numpy(a)[None] for a in _jproj(g, cv[0], cvp[0])]
    payload, ts, tc, _ = splat.bin_pairs(*proj, img_size=IMG, max_pairs=1 << 12, packed=True)
    ops.reset_launch_counts()
    np.testing.assert_array_equal(splat.composite(payload, ts, tc, IMG // 16).numpy(),
                                  splat.composite_reference(payload, ts, tc, IMG // 16).numpy())
    assert ops.launch_counts()["splat_composite"] == 0


def test_rasterize_dense_matches_jax(scene):
    g, cv, cvp = scene
    bg = np.asarray([0.3, 0.5, 0.7], np.float32)
    want = jgs.rasterize_dense(jnp.asarray(g), jnp.asarray(cv[0]), jnp.asarray(cvp[0]),
                               IMG, TAN, jnp.asarray(bg), chunk=64, tile=16)
    got = tgs.rasterize_dense(torch.from_numpy(g), torch.from_numpy(cv[0]),
                              torch.from_numpy(cvp[0]), IMG, TAN, torch.from_numpy(bg),
                              chunk=64, tile=16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)


def test_render_binned_packed_matches_jax_pallas_batch(scene, interpret):
    g, cv, cvp = scene
    bg = np.asarray([0.5, 0.5, 0.5], np.float32)
    want = jsp.rasterize_pallas_batch(
        jnp.asarray(g)[None], jnp.asarray(cv)[None], jnp.asarray(cvp)[None], IMG, TAN,
        jnp.asarray(bg), max_pairs=16384, packed=True)
    got = tgs.render_gaussians(torch.from_numpy(g)[None], torch.from_numpy(cv)[None],
                               torch.from_numpy(cvp)[None], bg_color=torch.from_numpy(bg),
                               img_size=IMG, backend="binned", packed=True)
    for key in ("image", "alpha", "depth"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=TOL,
                                   atol=TOL, err_msg=key)
    assert tgs.pair_capacity(192, IMG) == 16384  # the JAX rule at this size


def test_render_auto_is_dense_on_cpu(scene):
    g, cv, cvp = scene
    args = (torch.from_numpy(g)[None], torch.from_numpy(cv)[None],
            torch.from_numpy(cvp)[None])
    auto = tgs.render_gaussians(*args, img_size=IMG)
    dense = tgs.render_gaussians(*args, img_size=IMG, backend="dense")
    for key in auto:
        np.testing.assert_array_equal(auto[key].numpy(), dense[key].numpy())
    # the binned path agrees with the dense oracle where no pair is dropped
    binned = tgs.render_gaussians(*args, img_size=IMG, backend="binned")
    np.testing.assert_allclose(binned["image"].numpy(), dense["image"].numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        tgs.render_gaussians(*args, img_size=IMG, backend="pallas")
