"""The data-parallel and FSDP train steps of the port over gloo ranks on the
CPU (``parallel.mesh.spawn``), against the JAX package's step on one device
and against the port on one process.

The UNet finetune (the set-up of ``test_torch_unet_train.py`` at a global
batch of 4: configs/t2v_train_tiny.yaml's UNet, seeded weights through the
Flax-tree bridge, the JAX step's own draws replayed, dropout off) at world 2
and 4, replicated and FSDP-sharded: one SGD(1) step's loss and gradient, two
steps of the shipped AdamW chain (parameters and EMA), the replicated
parameters bit-equal on every rank. The engine: the training CLI on
configs/lgm_refine_train_tiny.yaml (``dp_devices: 2``) at world 2 and its
refusal at world 3, and a ``param_sharding: fsdp`` run with a save and a
restore."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_unet_train import (
    DIFFUSION,
    GRAD_TOL,
    LOSS_RTOL,
    P_ZERO,
    SD_KEYS,
    UNET,
    _jax_draws,
    _jax_run,
    _max_rel,
    _to_torch_names,
)
from torch_port_helpers import flatten_tree, seeded_like, set_torch_threads
from videomv_tpu.diffusion import GaussianDiffusion as JDiffusion
from videomv_tpu.models import UNetSD_T2VBase as JUNet
from videomv_tpu.training.optim import build_optimizer as jbuild_optimizer
from videomv_tpu_torch.models import UNetSD_T2VBase
from videomv_tpu_torch.parallel import spawn
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

B, F_, HW, L = 4, 4, 8, 5          # a global batch of 4: one row a rank at world 4
CTX = UNET["context_dim"]
# against the JAX step: the tolerances of test_torch_unet_train(_chain).py
PARAM_TOL = 1e-5
# against the port on one process: the same fp32 arithmetic, but the
# gradients summed over the ranks in another order; max |Δ| over every
# parameter against the largest entry of the reference
RANK_TOL = 2e-4
ADAMW = dict(lr=3e-5, warmup_steps=0, total_steps=100, grad_scale=0.5, sd_keys_path=SD_KEYS)
DEADLINE_S = 240


@pytest.fixture(scope="module")
def setup():
    ju = JUNet(**UNET)
    rs = np.random.default_rng(43)
    cams = rs.standard_normal((B, F_, 16)).astype(np.float32)
    shapes = jax.eval_shape(lambda: ju.init(
        jax.random.PRNGKey(0), jax.numpy.zeros((B, 4, F_, HW, HW)),
        jax.numpy.zeros((B,), np.int32), y=jax.numpy.zeros((B, L, CTX)),
        camera_data=jax.numpy.asarray(cams)))
    params = jax.tree_util.tree_map(np.asarray, seeded_like(shapes, 44))
    batch = {"latents": (rs.standard_normal((B, 4, F_, HW, HW)) * 0.5).astype(np.float32),
             "y_words": rs.standard_normal((B, L, CTX)).astype(np.float32),
             "camera_data": cams}
    zero_y = rs.standard_normal((1, L, CTX)).astype(np.float32)
    return ju, params, batch, zero_y


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The ranks' runs (world 2 and 4, and one rank) beside the JAX
    references, which compile while the ranks run."""
    _, params, batch, zero_y = setup
    draws = [_jax_draws(jax.random.PRNGKey(5), i, JDiffusion(**DIFFUSION), batch["latents"])
             for i in range(2)]
    sd = {k: v.numpy() for k, v in state_dict_from_flax(
        flatten_tree(params["params"]), UNetSD_T2VBase(**UNET)).items()}
    args = (UNET, sd, DIFFUSION, batch, zero_y,
            [tuple(x.numpy() for x in (d.t, d.noise, d.drop)) for d in draws], P_ZERO, ADAMW)
    tmp = tmp_path_factory.mktemp("rdv")
    with ThreadPoolExecutor(3) as pool:
        futures = {n: pool.submit(spawn, ranks.unet_train, n, init_file=str(tmp / f"w{n}"),
                                  deadline_s=DEADLINE_S, args=args) for n in (1, 2, 4)}
        sgd = _jax_run(setup, batch, optax.sgd(1.0))
        adamw = _jax_run(setup, batch, jbuild_optimizer(**ADAMW), steps=2, use_ema=True)
        got = {n: f.result() for n, f in futures.items()}
    one = got.pop(1)[0]
    for d, j in zip(draws, adamw[3]):  # the draws the JAX steps took
        assert all(torch.equal(a, b)
                   for a, b in zip((d.t, d.noise, d.drop), (j.t, j.noise, j.drop)))
    jgrads = jax.tree_util.tree_map(lambda o, n: np.asarray(o) - n, params, sgd[1])
    unet = UNetSD_T2VBase(**UNET)
    return dict(got=got, one=one, jloss=sgd[0][0], jgrads=_to_torch_names(jgrads, unet),
                jlosses=adamw[0], jparams=_to_torch_names(adamw[1], unet),
                jema=_to_torch_names(adamw[2], unet))


def _worst(got: dict, want: dict) -> float:
    top = max(np.abs(w).max() for w in want.values())
    return max(float(np.abs(got[k] - w).max()) for k, w in want.items()) / top


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_step_matches_jax(runs, world, mode):
    """Loss and gradient of one step, parameters and EMA after two AdamW
    steps, against the JAX step on one device."""
    r = runs["got"][world][0][mode]
    np.testing.assert_allclose(r["loss"], runs["jloss"], rtol=LOSS_RTOL)
    assert _max_rel(r["grads"], runs["jgrads"]) <= GRAD_TOL
    np.testing.assert_allclose(r["losses"], runs["jlosses"], rtol=LOSS_RTOL)
    assert _worst(r["params"], runs["jparams"]) <= PARAM_TOL
    assert _worst(r["ema"], runs["jema"]) <= PARAM_TOL
    if mode == "fsdp":
        assert r["sharded"] > 0


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["replicated", "fsdp"])
def test_step_matches_one_rank(runs, world, mode):
    """Against the port's step on one process, and the same parameters on
    every rank (the replicated ones bit for bit)."""
    one, res = runs["one"]["replicated"], runs["got"][world]
    r = res[0][mode]
    assert abs(r["loss"] - one["loss"]) <= RANK_TOL * abs(one["loss"])
    assert _worst(r["grads"], one["grads"]) <= RANK_TOL
    assert _worst(r["params"], one["params"]) <= RANK_TOL
    for other in res[1:]:
        assert other[mode]["losses"] == r["losses"]
        for k, v in r["params"].items():
            assert np.array_equal(other[mode]["params"][k], v), k


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine")
    return {n: spawn(ranks.engine_runs, n, init_file=str(tmp / f"w{n}"), deadline_s=DEADLINE_S,
                     args=(str(tmp / f"log{n}"),)) for n in (2, 3)}


def test_dp_devices_two_runs_at_world_two_and_raises_at_three(engine_runs):
    two, three = engine_runs[2], engine_runs[3]
    assert all("error" not in r for r in two)
    assert np.isfinite(two[0]["refine_loss"]) and two[1]["refine_loss"] == two[0]["refine_loss"]
    assert all("dp_devices 2 is below the world size 3" in r["error"] for r in three)


def test_fsdp_trainer_saves_and_restores(engine_runs):
    """``param_sharding: fsdp`` at world 2: the trainer steps, the save
    gathers the whole state, the restore re-shards it bit for bit."""
    for r in engine_runs[2]:
        assert np.isfinite(r["unet_loss"]) and r["sharded"] > 0 and r["restored_equal"]
