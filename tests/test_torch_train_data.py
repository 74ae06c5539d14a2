"""The port's training data readers against the JAX package's on files the
test writes: ``GObjaverseVideoDataset`` on a 24-view object of RGBA PNGs and
camera JSONs (items, the supervision block, skip-on-error), the multiview
loader through ``native/libmvdataio.so`` and through Pillow, and the LAION
tar-shard reader (``expand_shard_spec``, ``iter_tar_samples``, the filters,
``LaionImageDataset``, ``interleave_image_video``). All numpy on both
sides: outputs are equal."""

import io
import itertools
import json
import tarfile

import numpy as np
import pytest
from PIL import Image

import videomv_tpu.data.datasets as jdata
import videomv_tpu.data.laion as jlaion
import videomv_tpu.data.native_loader as jnative
from videomv_tpu.data.cameras import GSCameraSettings as JGSCameraSettings
from videomv_tpu_torch.data import datasets as tdata
from videomv_tpu_torch.data import laion as tlaion
from videomv_tpu_torch.data import native_loader as tnative
from videomv_tpu_torch.data.cameras import GSCameraSettings, orbit_c2w_opengl

VIEWS = 24


def _rgba(rs, size):
    img = rs.integers(0, 256, (size, size, 4), dtype=np.uint8)
    img[..., 3] = np.where(rs.random((size, size)) < 0.3, 0, img[..., 3])
    return Image.fromarray(img, "RGBA")


@pytest.fixture(scope="module")
def objects(tmp_path_factory):
    """Two objects of 24 views (the second misses a view, so it fails), a
    uid list and a caption file."""
    root = tmp_path_factory.mktemp("gobjaverse")
    rs = np.random.default_rng(0)
    c2w = orbit_c2w_opengl(VIEWS, 20.0, 1.8)
    for uid in ("obj_a", "obj_b"):
        for v in range(VIEWS):
            d = root / uid / f"{v:05d}"
            d.mkdir(parents=True)
            if not (uid == "obj_b" and v == 7):
                _rgba(rs, 96).save(d / f"{v:05d}.png")
            m = c2w[v]
            with open(d / f"{v:05d}.json", "w") as f:
                json.dump({"x": m[:3, 0].tolist(), "y": (-m[:3, 1]).tolist(),
                           "z": (-m[:3, 2]).tolist(), "origin": m[:3, 3].tolist()}, f)
    lst = root / "list.json"
    lst.write_text(json.dumps(["obj_a", "obj_b"]))
    caps = root / "captions.json"
    caps.write_text(json.dumps({"obj_a": "a red chair", "obj_b": "a lamp, 3d asset"}))
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
def test_gobjaverse_dataset_equals_jax(objects, gs_cameras):
    root, lst, caps = objects
    kw = dict(data_list=[lst], data_dir_list=[str(root)], caption_dir=caps, resolution=(64, 64),
              max_frames=VIEWS, prepare_lgm=True, gs_full_size=128, replica=1,
              prepare_gs_cameras=gs_cameras)
    want = list(jdata.GObjaverseVideoDataset(
        gs_settings=JGSCameraSettings(input_size=32, output_size=128), **kw))
    got = list(tdata.GObjaverseVideoDataset(
        gs_settings=GSCameraSettings(input_size=32, output_size=128), **kw))
    assert len(got) == len(want) == 1  # obj_b misses a view and is skipped
    _assert_equal_items(got[0], want[0])
    item = got[0]
    assert item["caption"] == "a red chair, 3d asset"
    assert item["video"].shape == (VIEWS, 3, 64, 64) and item["camera_data"].shape == (VIEWS, 16)
    assert item["gs_data"]["images_output"].shape == (VIEWS, 3, 128, 128)
    assert ("input" in item["gs_data"]) == gs_cameras
    cam = tdata.read_camera_matrix_single(str(root / "obj_a" / "00003" / "00003.json"))
    np.testing.assert_array_equal(cam, jdata.read_camera_matrix_single(
        str(root / "obj_a" / "00003" / "00003.json")))
    rgb, mask = tdata._load_rgba_on_bg(str(root / "obj_a" / "00000" / "00000.png"), 128, 48)
    jrgb, jmask = jdata._load_rgba_on_bg(str(root / "obj_a" / "00000" / "00000.png"), 128, 48)
    np.testing.assert_array_equal(rgb, jrgb)
    np.testing.assert_array_equal(mask, jmask)


@pytest.mark.parametrize("use_native", [True, False])
def test_multiview_loader_equals_jax(objects, use_native, monkeypatch):
    """The native library (the repository's own build) and the Pillow path
    (the library taken away) each give the JAX package's output on the same
    PNGs."""
    root, _, _ = objects
    paths = [str(root / "obj_a" / f"{v:05d}" / f"{v:05d}.png") for v in range(4)]
    if use_native:
        assert tnative.native_available(), f"{tnative.LIB_PATH} does not load"
    else:
        monkeypatch.setattr(tnative, "_load_lib", lambda: None)
    got = tnative.load_views(paths, out_size=64, background=128, full_size=80)
    if use_native:
        want = jnative.load_views(paths, out_size=64, background=128, full_size=80)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        assert got[0].shape == (4, 64, 64, 3) and got[3].shape == (4, 80, 80, 1)
        for i, p in enumerate(paths):
            rgb, mask = jdata._load_rgba_on_bg(p, 128, 64)
            np.testing.assert_allclose(got[0][i], rgb, atol=1e-6)
            np.testing.assert_array_equal(got[1][i], mask)
    with pytest.raises(Exception):
        tnative.load_views([str(root / "missing.png")], out_size=8)


def _jpeg(rs, w, h):
    buf = io.BytesIO()
    Image.fromarray(rs.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, format="JPEG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Two tar shards of (jpg, txt, json) samples: some pass the filters,
    some fail one (watermark, safety, aesthetic, size, aspect), one is not an
    image."""
    root = tmp_path_factory.mktemp("laion")
    rs = np.random.default_rng(1)
    metas = [{}, {"pwatermark": 0.9}, {"punsafe": 0.8}, {"aesthetic": 3.0},
             {"AESTHETIC_SCORE": 6.0}, {}, {}, {}]
    sizes = [(300, 200), (200, 200), (200, 200), (200, 200), (256, 256), (90, 200), (700, 150),
             (180, 260)]
    for s in range(2):
        with tarfile.open(root / f"{s:05d}.tar", "w") as tf:
            for i, (meta, (w, h)) in enumerate(zip(metas, sizes)):
                key = f"{s:05d}{i:04d}"
                files = {"jpg": _jpeg(rs, w, h), "txt": f"caption {s} {i}".encode(),
                         "json": json.dumps(meta).encode()}
                if i == 7:
                    files["jpg"] = b"not an image"
                for ext, data in files.items():
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return root


def test_shard_spec_and_tar_reader_equal_jax(shards):
    spec = str(shards / "{00000..00003}.tar")
    assert tlaion.expand_shard_spec(spec) == jlaion.expand_shard_spec(spec) == [
        str(shards / "00000.tar"), str(shards / "00001.tar")]
    glob = str(shards / "*.tar")
    assert tlaion.expand_shard_spec(glob) == jlaion.expand_shard_spec(glob)
    assert tlaion.expand_shard_spec(str(shards / "none.tar")) == []
    got = list(tlaion.iter_tar_samples(str(shards / "00000.tar")))
    assert got == list(jlaion.iter_tar_samples(str(shards / "00000.tar")))
    assert len(got) == 8 and set(got[0]) == {"jpg", "txt", "json"}
    f = tlaion.LaionFilterConfig()
    for meta, (w, h) in [({}, (300, 200)), ({"pwatermark": 0.9}, (200, 200)),
                         ({"aesthetic": 3.0}, (200, 200)), ({}, (90, 200)), ({}, (700, 150))]:
        assert f.accept(meta, w, h) == jlaion.LaionFilterConfig().accept(meta, w, h)


@pytest.mark.parametrize("shuffle_buffer", [2, 256])
def test_laion_dataset_equals_jax(shards, shuffle_buffer):
    paths = tlaion.expand_shard_spec(str(shards / "*.tar"))
    kw = dict(shards=paths, resolution=(64, 48), max_frames=1, shuffle_buffer=shuffle_buffer,
              seed=3)
    got, want = list(tlaion.LaionImageDataset(**kw)), list(jlaion.LaionImageDataset(**kw))
    assert len(got) == len(want) == 4  # 2 of the 8 samples of each shard pass
    for g, w in zip(got, want):
        assert g["caption"] == w["caption"]
        assert g["video"].shape == (1, 3, 48, 64)
        np.testing.assert_array_equal(g["video"], w["video"])
    # cycled epochs reshuffle: the seed moves on at each epoch end
    ds = tlaion.LaionImageDataset(**kw)
    two = list(itertools.islice(tdata.cycle_epochs(ds), 8))
    assert ds.seed == 4 and [x["caption"] for x in two[:4]] == [x["caption"] for x in got]


def test_interleave_image_video_equals_jax():
    def streams():
        return (iter(range(100, 200)), iter(range(0, 100)))

    got = list(itertools.islice(tlaion.interleave_image_video(*streams(), image_every=3), 9))
    want = list(itertools.islice(jlaion.interleave_image_video(*streams(), image_every=3), 9))
    assert got == want
    assert [k for k, _ in got] == ["video", "video", "image"] * 3
    assert all(k == "video" for k, _ in itertools.islice(
        tlaion.interleave_image_video(*streams(), image_every=0), 5))
