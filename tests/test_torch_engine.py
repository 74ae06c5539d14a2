"""The port's training engine on the CPU: ``T2VTrainer`` takes steps from
``configs/lgm_refine_train_tiny.yaml`` (a small text tower and VAE stand in
for ViT-H and the SD VAE, to keep the test fast), only the LGM changes, the
state saves and restores, no thread outlives the loop; the training and
inference CLIs run with ``--device cpu`` and refuse to run without a card
otherwise; the host data pipeline equals the JAX package's."""

import functools
import os
import threading

import numpy as np
import pytest
import torch

import videomv_tpu.data.datasets as jdata
import videomv_tpu_torch.training.engine as engine
from torch_port_helpers import set_torch_threads
from videomv_tpu_torch.config import load_config
from videomv_tpu_torch.data import datasets as tdata
from videomv_tpu_torch.models import AutoencoderKL, CLIPTextTower

set_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "lgm_refine_train_tiny.yaml")
SMALL = ["UNet.context_dim", "64", "save_ckp_interval", "0"]


@pytest.fixture()
def small_towers(monkeypatch):
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(engine, "CLIPTextTower",
                        functools.partial(CLIPTextTower, width=64, heads=2, layers=3))
    monkeypatch.setattr(engine, "AutoencoderKL", functools.partial(
        AutoencoderKL, ch=32, ch_mult=(1, 1, 1, 2), num_res_blocks=1))


def _trainer(tmp_path, *opts, dtype=torch.float32):
    cfg = load_config(TINY_CFG, opts=[*SMALL, "log_dir", str(tmp_path), *opts])
    return engine.T2VTrainer(cfg, device="cpu", dtype=dtype).init(zero_init=False)


def _snapshot(module):
    return [p.detach().clone() for p in module.parameters()]


def test_trainer_takes_steps_and_only_the_lgm_changes(small_towers, tmp_path):
    tr = _trainer(tmp_path)
    assert tr.use_lgm_refine and tr.lgm_state.step == 0
    assert all(p.dtype == torch.float32 and p.requires_grad for p in tr.lgm.parameters())
    frozen = {n: _snapshot(m) for n, m in (("unet", tr.unet), ("vae", tr.vae),
                                           ("clip", tr.clip), ("lpips", tr.lpips))}
    assert not any(p.requires_grad for n in frozen for p in getattr(tr, n).parameters())
    before = _snapshot(tr.lgm)
    n_threads = threading.active_count()
    # 2 steps: the warm-up learning rate is 0 at the first update
    loss = tr.train(num_steps=2, batch_size=2)
    assert np.isfinite(loss) and loss > 0
    assert threading.active_count() == n_threads  # the prefetch worker was joined
    assert tr.lgm_state.step == 2 and tr.lgm_state.optimizer.count == 2
    moved = max(float((a - b.detach()).abs().max()) for a, b in zip(before, tr.lgm.parameters()))
    assert moved > 0, "the LGM parameters must update"
    for name, snap in frozen.items():
        assert all(torch.equal(a, b) for a, b in zip(snap, getattr(tr, name).parameters())), name

    # save / restore: parameters, both moments and the step
    path = tr.save(str(tmp_path / "checkpoints"))
    assert os.path.basename(path) == "step_00000002.pth"
    want, mu, nu = _snapshot(tr.lgm), *(
        [t.clone() for t in getattr(tr.lgm_state.optimizer, k)] for k in ("mu", "nu"))
    tr.train(num_steps=1, batch_size=2)
    assert tr.lgm_state.step == 3
    tr.restore(path)
    assert tr.lgm_state.step == 2 and tr.lgm_state.optimizer.count == 2
    assert all(torch.equal(a, b) for a, b in zip(want, tr.lgm.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(mu, tr.lgm_state.optimizer.mu))
    assert all(torch.equal(a, b) for a, b in zip(nu, tr.lgm_state.optimizer.nu))


def test_memory_levers_and_wire_modes_give_the_same_first_loss(small_towers, tmp_path):
    """Per-block checkpointing with chunked views, the host camera wire and
    the fp32 supervision wire are the same step: each first loss equals the
    default's (the uint8 wire quantises the ground truth by at most 1/510)."""
    base = _trainer(tmp_path).train(num_steps=1, batch_size=2)
    levers = _trainer(tmp_path, "lgm_use_checkpoint", "True", "refine_view_chunk", "1")
    assert levers.lgm.unet.use_checkpoint and levers._step_kwargs["view_chunk"] == 1
    np.testing.assert_allclose(levers.train(num_steps=1, batch_size=2), base, rtol=1e-5)
    host = _trainer(tmp_path, "gs_wire_cameras", "False").train(num_steps=1, batch_size=2)
    np.testing.assert_allclose(host, base, rtol=1e-4)
    fp32 = _trainer(tmp_path, "wire_uint8", "False").train(num_steps=1, batch_size=2)
    np.testing.assert_allclose(fp32, base, rtol=2e-2)


def test_gs_features_wire(small_towers, tmp_path):
    tr = _trainer(tmp_path)
    host = next(tdata.batch_iterator(tr.make_dataset(), 2))
    feats = tr._gs_features(host)
    r = tr.lgm.opt.output_size
    assert set(feats) == {"images_gt", "masks_gt"}  # cameras are derived on the device
    assert feats["images_gt"].shape == (2, 4, 3, r, r) and feats["masks_gt"].shape == (2, 4, 1, r, r)
    tr.cfg.gs_wire_cameras = False
    feats = tr._gs_features(host)
    s = tr.lgm.opt.input_size
    assert feats["gs_rays"].shape == (2, 4, 6, s, s)
    assert feats["cam_view"].shape == feats["cam_view_proj"].shape == (2, 4, 4, 4)
    enc = tr.encode_batch(host)
    assert enc["latents"].shape == (2, 4, 4, 8, 8) and enc["latents"].dtype == torch.float32
    assert enc["y_words"].shape == (2, 77, 64) and enc["camera_data"].shape == (2, 4, 16)


def test_unported_modes_raise(tmp_path):
    cfg = load_config(TINY_CFG, opts=["UNet.use_lgm_refine", "False"])
    with pytest.raises(NotImplementedError, match="D2"):
        engine.T2VTrainer(cfg, device="cpu")


def test_training_cli_on_cpu(small_towers, tmp_path):
    from videomv_tpu_torch.training.__main__ import main

    loss = main(["--cfg", TINY_CFG, "--debug", "--steps", "2", "--batch-size", "2",
                 "--device", "cpu", *SMALL, "training_dtype", "float32", "log_dir",
                 str(tmp_path)])
    assert np.isfinite(loss) and loss > 0


@pytest.mark.parametrize("entry", ["training", "inference"])
def test_cli_without_a_card_refuses_to_run(entry, monkeypatch, tmp_path):
    """Both entry points run on the card by default; with no CUDA device and
    no ``--device cpu`` they stop before building anything."""
    import importlib

    monkeypatch.chdir(REPO)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"videomv_tpu_torch.{entry}.__main__").main
    cfg = TINY_CFG if entry == "training" else os.path.join(REPO, "configs",
                                                            "t2v_infer_tiny.yaml")
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["--cfg", cfg, "--debug", "log_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["--cfg", cfg, "--debug", "--device", "cuda:0", "log_dir", str(tmp_path)])


def test_host_data_pipeline_equals_jax():
    a = tdata.SyntheticMVDataset(resolution=(32, 32), max_frames=5, seed=3)
    b = jdata.SyntheticMVDataset(resolution=(32, 32), max_frames=5, seed=3)
    for idx in (0, 4):
        sa, sb = a.sample(idx), b.sample(idx)
        assert sorted(sa) == sorted(sb)
        for k in ("video", "camera_data"):
            assert sa[k].dtype == sb[k].dtype
            np.testing.assert_array_equal(sa[k], sb[k])
        assert sa["caption"] == sb["caption"]
    ba = next(tdata.batch_iterator(a, 3))
    bb = next(jdata.batch_iterator(b, 3))
    np.testing.assert_array_equal(ba["video"], bb["video"])
    assert ba["caption"] == bb["caption"] and ba["video"].shape == (3, 5, 3, 32, 32)

    class Finite:
        seed = 0

        def __iter__(self):
            return iter([{"x": np.full(2, self.seed)}, {"x": np.full(2, 10 + self.seed)}])

    got = [int(item["x"][0]) for item, _ in zip(tdata.cycle_epochs(Finite()), range(5))]
    want = [int(item["x"][0]) for item, _ in zip(jdata.cycle_epochs(Finite()), range(5))]
    assert got == want == [0, 10, 1, 11, 2]


def test_prefetch_worker_stops_drains_and_joins():
    def slow_forever():
        i = 0
        while True:
            yield {"i": i}
            i += 1

    n = threading.active_count()
    it = tdata.prefetch_host(slow_forever(), depth=2)
    assert [next(it)["i"] for _ in range(3)] == [0, 1, 2]
    assert threading.active_count() == n + 1
    it.close()  # the queue is full and the worker parked on put()
    assert threading.active_count() == n

    def boom():
        yield {"i": 0}
        raise RuntimeError("loader failed")

    it = tdata.prefetch_host(boom())
    assert next(it)["i"] == 0
    with pytest.raises(RuntimeError, match="loader failed"):
        next(it)
    assert threading.active_count() == n
    assert list(tdata.prefetch_host(iter([{"i": 1}, {"i": 2}]))) == [{"i": 1}, {"i": 2}]
