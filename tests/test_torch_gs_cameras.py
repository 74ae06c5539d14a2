"""The port's numpy copies of the splat-camera chain and the PLY writer equal
the JAX package's own: Plücker rays, the perspective matrix, the training
and reference-inference gs-camera chains, the raw orbit, and the bytes of a
``.ply`` file."""

import numpy as np
import pytest

import videomv_tpu.data.cameras as jcam
import videomv_tpu.ops.ply_io as jply
from videomv_tpu.ops.gs_cameras import proj_matrix as jproj_matrix
from videomv_tpu_torch.data import cameras as tcam
from videomv_tpu_torch.ops import ply_io as tply


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("frames,elev,dist,size", [(24, 15.0, 2.0, 16), (8, 10.0, 1.5, 12)])
def test_gs_camera_chains_equal_jax(frames, elev, dist, size):
    st_j = jcam.GSCameraSettings(input_size=size, output_size=2 * size)
    st_t = tcam.GSCameraSettings(input_size=size, output_size=2 * size)
    c2w_t = tcam.orbit_c2w_opengl(frames, elev, dist)
    np.testing.assert_array_equal(c2w_t, jcam.orbit_c2w_opengl(frames, elev, dist))
    _assert_same(tcam.prepare_gs_training(c2w_t, st_t, ray_size=size),
                 jcam.prepare_gs_training(c2w_t, st_j, ray_size=size))
    cam = tcam.orbit_camera_for_t2v(frames, elev, dist)
    _assert_same(tcam.prepare_gs_cameras(cam, st_t, ray_size=size),
                 jcam.prepare_gs_cameras(cam, st_j, ray_size=size))
    assert st_t.tan_half_fov == st_j.tan_half_fov


def test_rays_and_projection_equal_jax():
    pose = jcam.create_camera_to_world_matrix(20.0, 75.0, 1.7).astype(np.float32)
    np.testing.assert_array_equal(tcam.plucker_rays(pose, 9, 7, 39.6),
                                  jcam.plucker_rays(pose, 9, 7, 39.6))
    for a, b in zip(tcam.get_rays(pose, 5, 6, 50.0, opengl=False),
                    jcam.get_rays(pose, 5, 6, 50.0, opengl=False)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tcam.proj_matrix(39.6, 0.5, 2.5), jproj_matrix(39.6, 0.5, 2.5))
    np.testing.assert_array_equal(tcam.GSCameraSettings().proj_matrix,
                                  jcam.GSCameraSettings().proj_matrix)


def test_ply_writes_the_same_bytes_and_reads_back(tmp_path):
    rs = np.random.default_rng(9)
    g = np.concatenate([rs.uniform(-1, 1, (300, 3)), rs.uniform(0, 1, (300, 1)),
                        rs.uniform(0.001, 0.1, (300, 3)), rs.normal(size=(300, 4)),
                        rs.uniform(0, 1, (300, 3))], axis=1).astype(np.float32)
    n_t = tply.save_ply(g[None], str(tmp_path / "port.ply"))
    n_j = jply.save_ply(g[None], str(tmp_path / "jax.ply"))
    assert n_t == n_j == int((g[:, 3] >= 0.005).sum())
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back = tply.load_ply(str(tmp_path / "port.ply"))
    np.testing.assert_array_equal(back, jply.load_ply(str(tmp_path / "jax.ply")))
    kept = g[g[:, 3] >= 0.005]
    np.testing.assert_allclose(back[0], kept, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tply.save_ply(np.stack([g, g]), str(tmp_path / "two.ply"))
