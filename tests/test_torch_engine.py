"""The port's training engine on the CPU (a small text tower and VAE stand
in for ViT-H and the SD VAE, to keep the tests fast). The LGM-refine
finetune of ``configs/lgm_refine_train_tiny.yaml``: ``T2VTrainer`` takes
steps, only the LGM changes, the state saves and restores, no thread outlives
the loop. The plain and joint-LAION UNet finetune of
``configs/t2v_train_tiny.yaml``: only the UNet changes, the EMA follows, the
whole state (parameters, moments, EMA, step) saves and restores, the image
steps come every ``image_every``-th step at f = 1 from a LAION shard the test
writes, the visualisation hook writes its files and never raises into the
loop. The training and inference CLIs run with ``--device cpu`` and refuse
to run without a card otherwise; the host data pipeline equals the JAX
package's."""

import functools
import io
import json
import os
import tarfile
import threading

import numpy as np
import pytest
import torch
from PIL import Image

import videomv_tpu.data.datasets as jdata
import videomv_tpu_torch.training.engine as engine
from torch_port_helpers import set_torch_threads
from videomv_tpu_torch.config import load_config
from videomv_tpu_torch.data import datasets as tdata
from videomv_tpu_torch.models import AutoencoderKL, CLIPTextTower
from videomv_tpu_torch.training.hooks import VisualTrainHook

set_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_CFG = os.path.join(REPO, "configs", "lgm_refine_train_tiny.yaml")
SMALL = ["UNet.context_dim", "64", "save_ckp_interval", "0"]
UNET_CFG = os.path.join(REPO, "configs", "t2v_train_tiny.yaml")
UNET_SMALL = [*SMALL, "training_dtype", "float32"]


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
    """``param_sharding: fsdp`` in one process (no process group) has
    nothing to shard and builds, as do ``dp_devices: 2`` there (the world
    of one is used) and the I2V trainer (either switch) on the CPU (the
    plain UNet finetune, ``use_lgm_refine False``, too: see the tests
    below). The multi-rank placements are ``test_torch_parallel_train.py``'s."""
    cfg = load_config(TINY_CFG, opts=["param_sharding", "fsdp"])
    tr = engine.T2VTrainer(cfg, device="cpu")
    assert not tr.fsdp and tr.mesh is None and int(cfg.dp_devices) == 2
    for opts in (["TASK_TYPE", "train_i2v_entrance"], ["UNet.type", "UNetSD_I2VGen"]):
        tr = engine.T2VTrainer(load_config(TINY_CFG, opts=opts), device="cpu")
        assert tr.is_i2v and type(tr.unet).__name__ == "UNetSD_I2VGen"
        assert type(tr.clip).__name__ == "OpenCLIPTextVisual"
    cfg = load_config(TINY_CFG, opts=["UNet.use_lgm_refine", "False", "prng_impl", "rbg"])
    assert not engine.T2VTrainer(cfg, device="cpu").use_lgm_refine


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


def _unet_trainer(tmp_path, *opts):
    cfg = load_config(UNET_CFG, opts=[*UNET_SMALL, "log_dir", str(tmp_path), *opts])
    return engine.T2VTrainer(cfg, device="cpu").init(zero_init=False)


def test_plain_finetune_moves_only_the_unet_and_round_trips(small_towers, tmp_path):
    tr = _unet_trainer(tmp_path, "Pretrain", "{grad_scale: 0.5, sd_keys_path: "
                       "data/stable_diffusion_image_key_temporal_attention_x1.json}")
    assert not tr.use_lgm_refine and tr.state.step == 0 and tr.unet.use_checkpoint
    assert all(p.dtype == torch.float32 and p.requires_grad for p in tr.unet.parameters())
    assert tr.state.ema is not None and len(tr.state.optimizer.scaled) > 20
    assert tr.zero_y.shape == (1, 77, 64)
    frozen = {n: _snapshot(getattr(tr, n)) for n in ("vae", "clip")}
    before = _snapshot(tr.unet)
    n_threads = threading.active_count()
    loss = tr.train(num_steps=3, batch_size=2)
    assert np.isfinite(loss) and loss > 0
    assert threading.active_count() == n_threads  # the prefetch worker was joined
    assert tr.state.step == 3 and tr.state.optimizer.count == 3
    moved = max(float((a - b.detach()).abs().max()) for a, b in zip(before, tr.unet.parameters()))
    assert moved > 0, "the UNet parameters must update"
    for name, snap in frozen.items():
        assert all(torch.equal(a, b) for a, b in zip(snap, getattr(tr, name).parameters())), name
    # EMA (decay 0.9999) lags the parameters
    ema_moved = max(float((a - e).abs().max()) for a, e in zip(before, tr.state.ema))
    assert 0 < ema_moved < moved

    path = tr.save(str(tmp_path / "checkpoints"))
    assert os.path.basename(path) == "step_00000003.pth"
    want = _snapshot(tr.unet)
    mu = [t.clone() for t in tr.state.optimizer.mu]
    nu = [t.clone() for t in tr.state.optimizer.nu]
    ema = [t.clone() for t in tr.state.ema]
    tr.train(num_steps=1, batch_size=2)
    assert tr.state.step == 4
    tr.restore(path)
    assert tr.state.step == 3 and tr.state.optimizer.count == 3
    for got, exp in ((list(tr.unet.parameters()), want), (tr.state.optimizer.mu, mu),
                     (tr.state.optimizer.nu, nu), (tr.state.ema, ema)):
        assert all(torch.equal(a, b) for a, b in zip(exp, got))


def _write_shard(path, n=3):
    rs = np.random.default_rng(2)
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            buf = io.BytesIO()
            Image.fromarray(rs.integers(0, 256, (160, 200, 3), dtype=np.uint8)).save(
                buf, format="JPEG")
            for ext, data in (("jpg", buf.getvalue()), ("txt", f"image {i}".encode()),
                              ("json", json.dumps({"aesthetic": 6.0}).encode())):
                info = tarfile.TarInfo(f"{i:06d}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def test_laion_image_steps_alternate_at_one_frame(small_towers, tmp_path):
    shard = tmp_path / "00000.tar"
    _write_shard(shard)
    tr = _unet_trainer(tmp_path, "image_every", "2", "batch_sizes", "{'4': 2, '1': 3}",
                       "img_dataset", json.dumps({"type": "LAIONImageDataset",
                                                  "shards": [str(shard)], "resolution": [64, 64]}))
    assert len(list(tr.make_image_dataset())) == 3
    seen = []
    step = tr.train_step

    def logged(state, feats, **kw):
        seen.append((tuple(feats["latents"].shape), "camera_data" in feats))
        return step(state, feats, **kw)

    tr.train_step = logged
    loss = tr.train(num_steps=5)
    assert np.isfinite(loss)
    assert seen == [((2, 4, 4, 8, 8), True), ((3, 4, 1, 8, 8), False)] * 2 + [
        ((2, 4, 4, 8, 8), True)]
    # no shards: image_every is ignored with a warning
    tr2 = _unet_trainer(tmp_path, "image_every", "2", "img_dataset", json.dumps(
        {"type": "LAIONImageDataset", "shards": ["/nonexistent/{0..3}.tar"]}))
    assert tr2.make_image_dataset() is None


def test_viz_hook_writes_and_never_raises(small_towers, tmp_path):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a chair\n")
    tr = _unet_trainer(tmp_path, "viz_interval", "1", "validation_prompts", str(prompts),
                       "ddim_timesteps", "2", "max_frames", "4", "use_ema", "True")
    tr.train(num_steps=1, batch_size=2)
    viz = tmp_path / "viz"
    names = sorted(os.listdir(viz))
    assert any(n.startswith("viz_step_00000001") for n in names), names
    assert any(n.startswith("latents_00000001_a_chair") for n in names), names
    assert tr.unet.training  # back in training mode after sampling
    # the EMA weights were swapped in and back
    assert all(not torch.equal(p, e) for p, e in zip(tr.unet.parameters(), tr.state.ema)
               if p.requires_grad and p.numel() > 1)

    def broken_factory():
        raise RuntimeError("no pipeline")

    hook = VisualTrainHook(broken_factory, ["x"], str(tmp_path / "viz2"))
    assert hook(5, tr.unet) is None and tr.unet.training
    tr.cfg.validation_prompts = str(tmp_path / "missing.txt")
    assert tr.make_viz_hook(str(tmp_path)) is None


def test_plain_training_cli_on_cpu(small_towers, tmp_path):
    from videomv_tpu_torch.training.__main__ import main

    loss = main(["--cfg", UNET_CFG, "--steps", "2", "--device", "cpu", *UNET_SMALL, "log_dir",
                 str(tmp_path)])
    assert np.isfinite(loss) and loss > 0


def test_fsdp_visualisation_writes_and_matches_the_unsharded_one(tmp_path):
    """``viz_interval`` under ``param_sharding: fsdp`` at world 2 (gloo
    ranks): every rank samples, rank 0 writes, and its frames are the
    replicated trainer's; the EMA weights are copied into the shards for it
    and back; the training loop runs the hook on every rank."""
    import torch_parallel_ranks as ranks
    from videomv_tpu_torch.parallel import spawn

    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a chair\n")
    got = spawn(ranks.fsdp_viz, 2, init_file=str(tmp_path / "rdv"), deadline_s=240,
                args=(str(tmp_path / "log"), str(prompts)))
    zero, one = got
    assert zero["fsdp"]["sampled"] and one["fsdp"]["sampled"]
    assert zero["replicated"]["sampled"] and not one["replicated"]["sampled"]
    assert zero["fsdp"]["path"] and os.path.exists(zero["fsdp"]["path"])
    assert one["fsdp"]["path"] is None and one["fsdp"]["frames"] is None
    a, b = zero["fsdp"]["frames"], zero["replicated"]["frames"]
    assert len(a) == len(b) == 1 and a[0].shape == b[0].shape == (4, 64, 64, 3)
    assert np.abs(a[0].astype(np.float64) - b[0]).max() / 255.0 <= 1e-5
    assert all(r["ema_swapped"] and r["ema_restored"] for r in got)
    assert any(n.startswith("viz_step_00000001") for n in zero["loop_wrote"])
