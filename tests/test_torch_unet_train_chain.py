"""Two steps of the shipped optimizer chain and an f = 1 image step of the
port's UNet finetune step against the JAX package's, fp32 on the CPU, on
the UNet and the set-up of ``test_torch_unet_train.py`` (the same weights,
batch and replayed draws, dropout off on both sides): AdamW with the bf16
first moment under ``annealing_lr``, the SD keys' gradients scaled by 0.5,
and EMA; and the joint LAION finetune's image step at f = 1 without a
camera, through SGD(1) so that ``old - new`` is the gradient."""

import jax
import numpy as np
import optax
import torch

from test_torch_unet_train import (  # noqa: F401 - setup is a fixture
    DIFFUSION,
    GRAD_TOL,
    LOSS_RTOL,
    P_ZERO,
    SD_KEYS,
    _jax_run,
    _max_rel,
    _port_unet,
    _sgd_step,
    _tbatch,
    _to_torch_names,
    setup,
)
from torch_port_helpers import set_torch_threads
from videomv_tpu.training.optim import build_optimizer as jbuild_optimizer
from videomv_tpu_torch.diffusion import GaussianDiffusion
from videomv_tpu_torch.parallel import TrainState, build_train_step, make_t2v_apply
from videomv_tpu_torch.training.optim import build_optimizer

set_torch_threads()

# parameters and EMA after two AdamW steps: against the largest entry of all
# the parameters (of the EMA). Adam divides each gradient entry by its own
# RMS, so where an entry is rounding noise in both frameworks its update
# differs by up to the learning rate; the shipped 3e-5 bounds that.
PARAM_TOL = 1e-5


def test_image_step_at_one_frame_matches_jax(setup):
    """An image step of the joint LAION finetune: f = 1, no camera."""
    _, params, batch, _ = setup
    img = {"latents": batch["latents"][:, :, :1].copy(), "y_words": batch["y_words"]}
    losses, new, _, draws = _jax_run(setup, img, optax.sgd(1.0))
    jgrads = jax.tree_util.tree_map(lambda o, n: np.asarray(o) - n, params, new)
    step, state, old = _sgd_step(setup, img)
    loss = step(state, _tbatch(img), draws=draws[0])
    np.testing.assert_allclose(float(loss), losses[0], rtol=LOSS_RTOL)
    grads = {k: (old[k] - p.detach()).numpy() for k, p in state.unet.named_parameters()}
    assert _max_rel(grads, _to_torch_names(jgrads, state.unet)) <= GRAD_TOL


def test_two_steps_of_the_shipped_chain_match_jax(setup):
    """AdamW with the bf16 first moment under ``annealing_lr`` (no warm-up,
    so both updates move), the SD keys' gradients scaled by 0.5, EMA on."""
    _, params, batch, zero_y = setup
    kw = dict(lr=3e-5, warmup_steps=0, total_steps=100, grad_scale=0.5, sd_keys_path=SD_KEYS)
    losses, jparams, jema, draws = _jax_run(setup, batch, jbuild_optimizer(**kw), steps=2,
                                            use_ema=True)
    unet = _port_unet(params)
    opt = build_optimizer(unet.named_parameters(), **kw)
    assert len(opt.scaled) > 20
    step = build_train_step(make_t2v_apply(unet), GaussianDiffusion(**DIFFUSION), ema_decay=0.9,
                            use_ema=True, p_zero=P_ZERO, zero_y=torch.from_numpy(zero_y))
    state = TrainState(step=0, unet=unet, optimizer=opt,
                       ema=[p.detach().clone() for p in unet.parameters()])
    start = {k: p.detach().clone() for k, p in unet.named_parameters()}
    for i in range(2):
        loss = step(state, _tbatch(batch), draws=draws[i])
        np.testing.assert_allclose(float(loss), losses[i], rtol=LOSS_RTOL)
    assert state.step == 2 and opt.count == 2
    got = {k: p.detach().numpy() for k, p in unet.named_parameters()}
    assert max(float((start[k] - p.detach()).abs().max())
               for k, p in unet.named_parameters()) > 1e-5
    names = [k for k, _ in unet.named_parameters()]
    got_ema = {k: e.numpy() for k, e in zip(names, state.ema)}
    for mine, theirs in ((got, _to_torch_names(jparams, unet)),
                         (got_ema, _to_torch_names(jema, unet))):
        top = max(float(np.abs(w).max()) for w in theirs.values())
        worst = max(float(np.abs(mine[k] - w).max()) for k, w in theirs.items())
        assert worst <= PARAM_TOL * top, (worst, top)
