"""The temporal variants of the T2V UNet under frame parallelism, over gloo
ranks on the CPU (``parallel.mesh.spawn``), fp32, against the same UNet on
one process: the rotary UNet (``temporal_attn_times`` 2, ``use_sim_mask``,
a ``video_mask`` with an emptied row and a ``focus_present_mask`` row) and
the causal ``attemask`` UNet at sp 2 and sp 3 (the 4 × 4 level's 16 tokens
split 6 / 5 / 5), and the attemask UNet over an ``('sp', 'tp')`` mesh of
2 × 2, whose causal temporal attentions are cut to each rank's heads while
the rotary blocks' fused ``to_qkv`` stays whole (JAX ``tp_shardings``)."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_port_helpers import rel_err, set_torch_threads
from videomv_tpu_torch.models import UNetSD_T2VBase
from videomv_tpu_torch.parallel import spawn, tp_shardings
from videomv_tpu_torch.training.checkpoints import init_weights

set_torch_threads()

# against one rank: the same fp32 arithmetic, the temporal blocks' norms and
# sums taken over the ranks in another order (test_torch_parallel_serve.py)
RANK_TOL = 2e-4
DEADLINE_S = 300
TINY = dict(in_dim=4, dim=64, y_dim=64, context_dim=64, out_dim=4, dim_mult=(1, 2),
            num_heads=2, head_dim=32, num_res_blocks=1, attn_scales=(1.0, 0.5, 0.25),
            dropout=0.0)
VARIANTS = {"rotary": dict(TINY, temporal_block="rotary", temporal_attn_times=2,
                           use_sim_mask=True),
            "attemask": dict(TINY, temporal_block="attemask")}
B, F, HW = 2, 6, 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rs = np.random.default_rng(17)
    vm = rs.random((B, F)) > 0.3
    vm[0], vm[1, :2] = False, True
    inputs = {"x": rs.standard_normal((B, 4, F, HW, HW)).astype(np.float32),
              "t": np.array([981, 41]),
              "y": rs.standard_normal((B, 5, 64)).astype(np.float32),
              "cam": rs.standard_normal((B, F, 16)).astype(np.float32),
              "vm": vm, "fpm": np.array([False, True])}
    sds, want = {}, {}
    for name, kw in VARIANTS.items():
        unet = init_weights(UNetSD_T2VBase(**kw), seed=5, zero_init=False).eval()
        sds[name] = {k: v.numpy() for k, v in unet.state_dict().items()}
        masks = name == "rotary"
        inp = {k: torch.from_numpy(v) for k, v in inputs.items()}
        with torch.no_grad():
            want[name] = unet(inp["x"], inp["t"], y=inp["y"], camera_data=inp["cam"],
                              **(dict(video_mask=inp["vm"], focus_present_mask=inp["fpm"])
                                 if masks else {})).numpy()
    jobs = [{"kw": VARIANTS[n], "sd": sds[n], "masks": n == "rotary"} for n in VARIANTS]
    tp_job = [{"kw": VARIANTS["attemask"], "sd": sds["attemask"], "tp": 2}]
    tmp = tmp_path_factory.mktemp("rdv")
    plan = {"sp2": (2, jobs), "sp3": (3, jobs), "sp2tp2": (4, tp_job)}
    with ThreadPoolExecutor(len(plan)) as pool:
        futures = {tag: pool.submit(spawn, ranks.variant_forwards, n,
                                    init_file=os.path.join(str(tmp), tag),
                                    deadline_s=DEADLINE_S, args=(jobs_, inputs))
                   for tag, (n, jobs_) in plan.items()}
        got = {tag: f.result() for tag, f in futures.items()}
    return got, want


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("i,name", list(enumerate(VARIANTS)))
def test_frame_parallel_variant_matches_one_rank(runs, sp, i, name):
    got, want = runs
    assert np.abs(want[name]).max() > 1e-2
    for r in got[f"sp{sp}"]:
        assert r[i]["out"].shape == want[name].shape
        assert rel_err(r[i]["out"], want[name]) <= RANK_TOL


def test_attemask_sp_by_tp_matches_one_rank(runs):
    got, want = runs
    for r in got["sp2tp2"]:
        assert rel_err(r[0]["out"], want["attemask"]) <= RANK_TOL


def test_tp_cuts_attemask_attention_and_keeps_rotary_qkv_whole(runs):
    placement = runs[0]["sp2tp2"][0][0]["placement"]
    temporal = [k for k in placement if k.startswith("input_blocks.1.2.")]
    assert temporal and all(placement[k] in ("column", "row") for k in temporal)
    rotary = tp_shardings(UNetSD_T2VBase(**VARIANTS["rotary"]), 2, head_dim=32)
    assert not any("to_qkv" in k or "att_layers" in k for k in rotary)
    assert any(k.startswith("input_blocks.1.1.") for k in rotary)  # spatial blocks still cut
