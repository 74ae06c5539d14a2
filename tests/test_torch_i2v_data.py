"""The port's I2V data and host helpers against the JAX package's, on files
the test writes (all numpy and Pillow on both sides, so outputs are equal):
``GObjaverseI2VDataset`` on two objects of RGBA renders and camera JSONs
(the white background, the empty captions, the random azimuth roll from the
dataset's own ``random.Random``, the re-canonicalised supervision block and
``ref_frame``), ``ImageListDataset`` (list files, a missing image
zero-filled), ``data.recenter`` (the function and the CLI) and
``utils.seed.setup_seed``."""

import json
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

import videomv_tpu.data.datasets as jdata
from videomv_tpu.data import recenter as jrecenter
from videomv_tpu.data.cameras import GSCameraSettings as JGSCameraSettings
from videomv_tpu.utils.seed import setup_seed as jsetup_seed
from videomv_tpu_torch.data import datasets as tdata
from videomv_tpu_torch.data import recenter as trecenter
from videomv_tpu_torch.data.cameras import GSCameraSettings, orbit_c2w_opengl
from videomv_tpu_torch.utils.seed import setup_seed

VIEWS = 8


def _rgba(rs, size, border=0):
    """Seeded RGBA noise; with ``border`` a transparent frame around it."""
    img = rs.integers(0, 256, (size, size, 4), dtype=np.uint8)
    img[..., 3] = np.where(rs.random((size, size)) < 0.3, 0, img[..., 3])
    if border:
        img[:border, :, 3] = img[-border:, :, 3] = 0
        img[:, :border, 3] = img[:, -border:, 3] = 0
    return Image.fromarray(img, "RGBA")


@pytest.fixture(scope="module")
def objects(tmp_path_factory):
    """Two objects of VIEWS views each, a uid list and a caption file."""
    root = tmp_path_factory.mktemp("gobjaverse_i2v")
    rs = np.random.default_rng(3)
    c2w = orbit_c2w_opengl(VIEWS, 15.0, 2.0)
    for uid in ("obj_a", "obj_b"):
        for v in range(VIEWS):
            d = root / uid / f"{v:05d}"
            d.mkdir(parents=True)
            _rgba(rs, 80).save(d / f"{v:05d}.png")
            m = c2w[v]
            with open(d / f"{v:05d}.json", "w") as f:
                json.dump({"x": m[:3, 0].tolist(), "y": (-m[:3, 1]).tolist(),
                           "z": (-m[:3, 2]).tolist(), "origin": m[:3, 3].tolist()}, f)
    lst = root / "list.json"
    lst.write_text(json.dumps(["obj_a", "obj_b"]))
    caps = root / "captions.json"
    caps.write_text(json.dumps({"obj_a": "a red chair", "obj_b": "a lamp"}))
    return root, str(lst), str(caps)


def _assert_equal_items(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_equal_items(got[k], w)
        elif isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("gs_cameras", [True, False])
def test_i2v_dataset_equals_jax(objects, gs_cameras):
    root, lst, caps = objects
    kw = dict(data_list=[lst], data_dir_list=[str(root)], caption_dir=caps, resolution=(32, 32),
              max_frames=VIEWS, prepare_lgm=True, gs_full_size=64, replica=3, seed=5,
              prepare_gs_cameras=gs_cameras)
    want = list(jdata.GObjaverseI2VDataset(
        gs_settings=JGSCameraSettings(input_size=16, output_size=64), **kw))
    got = list(tdata.GObjaverseI2VDataset(
        gs_settings=GSCameraSettings(input_size=16, output_size=64), **kw))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_equal_items(g, w)
    # what the I2V variant changes: white background, no caption, the roll
    plain = list(tdata.GObjaverseVideoDataset(
        gs_settings=GSCameraSettings(input_size=16, output_size=64),
        **dict(kw, replica=1)))
    shifts = []
    for item, base in zip(got, plain * 3):
        assert item["caption"] == ""
        np.testing.assert_array_equal(item["ref_frame"], item["video"][0])
        shift = next(s for s in range(VIEWS)
                     if np.array_equal(item["camera_data"], np.roll(base["camera_data"], -s, 0)))
        shifts.append(shift)
        np.testing.assert_array_equal(item["mask"], np.roll(base["mask"], -shift, 0))
        np.testing.assert_array_equal(item["gs_data"]["masks_output"],
                                      np.roll(base["gs_data"]["masks_output"], -shift, 0))
        if gs_cameras:  # the supervision poses are canonicalised against the new view 0
            assert "input" in item["gs_data"] and item["gs_data"]["cam_view"].shape == (VIEWS, 4, 4)
    assert len(set(shifts)) > 1  # the dataset's own generator, a new draw per item
    rng = random.Random(5)
    assert shifts == [rng.randrange(VIEWS) for _ in range(6)]
    # on white: a fully transparent pixel of view 0 of obj_a is 1.0 in [0, 1]
    mask0 = tdata.GObjaverseI2VDataset(
        random_roll=False, **dict(kw, replica=1, prepare_lgm=False))
    item = next(iter(mask0))
    clear = item["video"].transpose(0, 2, 3, 1)[item["mask"][:, 0] == 0]
    assert clear.size and clear.min() == 1.0


def test_image_list_dataset_equals_jax(tmp_path):
    rs = np.random.default_rng(8)
    _rgba(rs, 40).save(tmp_path / "a.png")
    Image.fromarray(rs.integers(0, 256, (30, 50, 3), dtype=np.uint8)).save(tmp_path / "b.jpg")
    (tmp_path / "list.txt").write_text("a.png|||an apple\n\nb.jpg|||a box\nmissing.png|||gone\n")
    kw = dict(data_list=[str(tmp_path / "list.txt"), str(tmp_path / "absent.txt")],
              data_dir_list=[str(tmp_path), str(tmp_path)], resolution=(24, 16), max_frames=3,
              retries=2)
    want = list(jdata.ImageListDataset(**kw))
    got = list(tdata.ImageListDataset(**kw))
    assert len(tdata.ImageListDataset(**kw)) == len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_equal_items(g, w)
    assert [g["caption"] for g in got] == ["an apple", "a box", "gone"]
    assert got[0]["video"].shape == (3, 3, 16, 24) and not got[0]["video"][1:].any()
    # the missing image is zero-filled, which is black (-1) in [-1, 1]
    assert (got[2]["video"][0] == -1).all() and not got[2]["video"][1:].any()


def test_recenter_equals_jax(tmp_path):
    rs = np.random.default_rng(13)
    src = tmp_path / "in"
    src.mkdir()
    _rgba(rs, 90, border=17).save(src / "a_obj.png")
    Image.fromarray(rs.integers(0, 256, (40, 70, 3), dtype=np.uint8)).save(src / "b_rgb.png")
    (src / "c_not_an_image.png").write_text("not a png")
    for name, kw in (("a_obj.png", {}), ("a_obj.png", dict(crop_size=64, image_size=128)),
                     ("a_obj.png", dict(crop_size=-1)), ("b_rgb.png", {})):
        got = trecenter.recenter_image(str(src / name), **kw)
        want = jrecenter.recenter_image(str(src / name), **kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    out_t, out_j = tmp_path / "out_t", tmp_path / "out_j"
    trecenter.main([str(src), str(out_t)])
    jrecenter.main([str(src), str(out_j)])
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == ["00000.png", "00001.png"]
    for name in os.listdir(out_j):
        np.testing.assert_array_equal(np.asarray(Image.open(out_t / name)),
                                      np.asarray(Image.open(out_j / name)))
    with pytest.raises(SystemExit, match="usage"):
        trecenter.main([])


def test_setup_seed_equals_jax(monkeypatch):
    monkeypatch.setenv("PYTHONHASHSEED", "x")
    state = (random.getstate(), np.random.get_state(), torch.get_rng_state())
    try:
        jsetup_seed(17)
        want = (random.random(), np.random.rand(3), os.environ["PYTHONHASHSEED"])
        setup_seed(17)
        got = (random.random(), np.random.rand(3), os.environ["PYTHONHASHSEED"])
        t1 = torch.rand(4)
        assert got[0] == want[0] and got[2] == want[2] == "17"
        np.testing.assert_array_equal(got[1], want[1])
        setup_seed(17)
        assert torch.equal(torch.rand(4), t1)  # torch's default generator is seeded too
    finally:
        random.setstate(state[0])
        np.random.set_state(state[1])
        torch.set_rng_state(state[2])
