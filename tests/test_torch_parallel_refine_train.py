"""The data-parallel LGM-refine step of the port at two gloo ranks on the CPU
(``parallel.mesh.spawn``; the ``dp_devices: 2`` of
configs/lgm_refine_train_tiny.yaml), on the set-up of
``test_torch_lgm_refine.py`` (the same weights, batch of 2 and replayed JAX
draws, dropout off): against the JAX step on one device, the port on one
process, and the same loss and LGM gradient on both ranks."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from test_torch_lgm_refine import (  # noqa: F401 - setup and jax_step are fixtures
    DIFFUSION,
    GRAD_TOL,
    LGM_OPT,
    LOSS_RTOL,
    STEP,
    UNET,
    VAE,
    _jax_draws,
    _max_rel,
    jax_step,
    setup,
)
from torch_port_helpers import flatten_tree, set_torch_threads
from videomv_tpu.diffusion import GaussianDiffusion as JDiffusion
from videomv_tpu_torch.models import AutoencoderKL, UNetSD_T2VBase
from videomv_tpu_torch.models.lgm import LGM, LGMOptions
from videomv_tpu_torch.models.lpips import LPIPS
from videomv_tpu_torch.parallel import spawn
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

# against the port on one process: the loss to 2e-4. The gradients are held
# to the per-parameter bound of the JAX comparison (GRAD_TOL): a rank's batch
# of one instead of two reorders the fp32 sums of the convolutions' weight
# gradients, and that alone moves the LGM's input convolution by 8e-4 of the
# largest gradient entry (the same step at batch 2 on one and two threads
# differs as much)
RANK_TOL = 2e-4
DEADLINE_S = 240


@pytest.fixture(scope="module")
def runs(setup, request, tmp_path_factory):
    """The ranks run while the JAX step compiles."""
    _, params, batch = setup
    draws = _jax_draws(jax.random.PRNGKey(5), 0, JDiffusion(**DIFFUSION), batch["latents"])
    shells = {"unet": UNetSD_T2VBase(**UNET), "vae": AutoencoderKL(**VAE),
              "lgm": LGM(LGMOptions(**LGM_OPT)), "lpips": LPIPS()}
    models = {k: {n: v.numpy() for n, v in state_dict_from_flax(
        flatten_tree(params[k]["params"]), m).items()} for k, m in shells.items()}
    args = (models, UNET, VAE, LGM_OPT, DIFFUSION, STEP, batch, draws)
    tmp = tmp_path_factory.mktemp("rdv")
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(spawn, ranks.lgm_refine, n, init_file=str(tmp / f"w{n}"),
                               deadline_s=DEADLINE_S, args=args) for n in (2, 1)]
        jloss, _, jgrads, jdraws = request.getfixturevalue("jax_step")
        two, (one,) = (f.result() for f in futures)
    assert all(np.array_equal(draws[k], jdraws[k]) for k in draws)  # the JAX step's own
    want = {k: v.numpy() for k, v in state_dict_from_flax(
        flatten_tree(jgrads["params"]), shells["lgm"]).items()}
    return two, one, jloss, want


def test_two_ranks_match_jax(runs):
    two, _, jloss, want = runs
    np.testing.assert_allclose(two[0]["loss"], jloss, rtol=LOSS_RTOL)
    assert _max_rel(two[0]["grads"], want) <= GRAD_TOL


def test_two_ranks_match_one_rank_and_each_other(runs):
    two, one, _, _ = runs
    r = two[0]
    assert abs(r["loss"] - one["loss"]) <= RANK_TOL * abs(one["loss"])
    assert _max_rel(r["grads"], one["grads"]) <= GRAD_TOL
    assert two[1]["loss"] == r["loss"]
    assert all(np.array_equal(two[1]["grads"][k], v) for k, v in r["grads"].items())
