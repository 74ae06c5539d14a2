"""The UNet finetune step of the port (``parallel.train_step``) against the
JAX package's ``build_train_step``, the slice as a whole at a small size,
fp32 on the CPU: the UNet of configs/t2v_train_tiny.yaml (dim 64, (1, 2),
2 × 32 heads, block checkpointing on) with the same seeded weights through
the Flax-tree bridge, the same batch, and the JAX step's own draws (t, the
noise, the classifier-free drop) replayed. Dropout is off on both sides
(the temporal convolutions carry a fixed 0.1 that no config turns off, and
the two frameworks' generators never agree): the JAX step applies the UNet
deterministically, the port sets every ``nn.Dropout`` to p = 0 in train
mode. With ``optax.sgd(1.0)`` and its mirror, ``old - new`` parameters are
each side's gradient. Then a dropped row, checkpointed against plain, the
remat policies, and the step's draws coming from its generator alone. The
shipped optimizer chain and the f = 1 image step are in
``test_torch_unet_train_chain.py`` (the JAX compiles are split between two
files, which the gate runs on two workers)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import flatten_tree, seeded_like, set_torch_threads
from videomv_tpu.diffusion import GaussianDiffusion as JDiffusion
from videomv_tpu.models import UNetSD_T2VBase as JUNet
from videomv_tpu.parallel import TrainState as JTrainState
from videomv_tpu.parallel import build_train_step as jbuild_train_step
from videomv_tpu.parallel import make_mesh, replicate, shard_batch
from videomv_tpu_torch.config import load_config
from videomv_tpu_torch.diffusion import GaussianDiffusion
from videomv_tpu_torch.inference.pipeline import unet_kwargs_from_cfg
from videomv_tpu_torch.models import UNetSD_T2VBase
from videomv_tpu_torch.parallel import (
    TrainDraws,
    TrainState,
    build_train_step,
    draw_train_randoms,
    make_t2v_apply,
)
from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

set_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = load_config(os.path.join(REPO, "configs", "t2v_train_tiny.yaml"))
UNET = unet_kwargs_from_cfg(CFG.UNet)
DIFFUSION = {k: v for k, v in CFG.Diffusion.items() if k != "type"}
B, F_, HW, L = 2, 4, 8, 5          # 2 samples, 4 views, 8×8 latents, 5 text tokens
CTX = UNET["context_dim"]
SD_KEYS = os.path.join(REPO, "data", "stable_diffusion_image_key_temporal_attention_x1.json")
P_ZERO = 0.5
# fp32 on both sides through the whole UNet and the loss
LOSS_RTOL = 1e-4
# gradients, per parameter: |got - want| against GRAD_TOL of that
# parameter's largest entry plus GRAD_FLOOR of the largest entry overall
# (the floor covers parameters whose gradient is rounding noise in both
# frameworks; the JAX side is old - new after an SGD step of 1, which rounds
# at the parameters' ulp)
GRAD_TOL = 5e-3
GRAD_FLOOR = 1e-5


def _jax_apply(ju):
    def apply_fn(params, xt, t, y, batch, rng):  # make_t2v_apply without dropout
        return ju.apply(params, xt, t, y=y, camera_data=batch.get("camera_data"))
    return apply_fn


@pytest.fixture(scope="module")
def setup():
    assert UNET["use_checkpoint"] and UNET["dim"] == 64 and UNET["dim_mult"] == (1, 2)
    ju = JUNet(**UNET)
    rs = np.random.default_rng(41)
    cams = rs.standard_normal((B, F_, 16)).astype(np.float32)
    shapes = jax.eval_shape(lambda: ju.init(
        jax.random.PRNGKey(0), jnp.zeros((B, 4, F_, HW, HW)), jnp.zeros((B,), jnp.int32),
        y=jnp.zeros((B, L, CTX)), camera_data=jnp.asarray(cams)))
    params = jax.tree_util.tree_map(np.asarray, seeded_like(shapes, 42))
    batch = {"latents": (rs.standard_normal((B, 4, F_, HW, HW)) * 0.5).astype(np.float32),
             "y_words": rs.standard_normal((B, L, CTX)).astype(np.float32),
             "camera_data": cams}
    zero_y = rs.standard_normal((1, L, CTX)).astype(np.float32)
    return ju, params, batch, zero_y


def _jax_draws(rng, step, diffusion, latents):
    """The draws of the JAX step: ``fold_in(rng, step)``, the 4-way split,
    randint, bernoulli, and ``loss``'s own split before ``sample_noise``."""
    rng = jax.random.fold_in(rng, step)
    t_rng, n_rng, z_rng, _ = jax.random.split(rng, 4)
    b = latents.shape[0]
    t = jax.random.randint(t_rng, (b,), 0, diffusion.num_timesteps)
    drop = jax.random.bernoulli(z_rng, P_ZERO, (b,))
    noise = diffusion.sample_noise(jax.random.split(n_rng)[0], jnp.asarray(latents))
    return TrainDraws(torch.from_numpy(np.asarray(t, np.int64)),
                      torch.from_numpy(np.asarray(noise)), torch.from_numpy(np.asarray(drop)))


def _jax_run(setup, batch, opt, steps=1, use_ema=False, ema_decay=0.9):
    """``steps`` JAX train steps; returns (losses, params, ema, draws per step)."""
    ju, params, _, zero_y = setup
    mesh = make_mesh(1)
    diffusion = JDiffusion(**DIFFUSION)
    step = jbuild_train_step(_jax_apply(ju), diffusion, opt, mesh, ema_decay=ema_decay,
                             use_ema=use_ema, p_zero=P_ZERO, zero_y=jnp.asarray(zero_y))
    fresh = lambda: jax.tree_util.tree_map(jnp.array, params)  # noqa: E731 - the step donates
    state = JTrainState(step=replicate(mesh, jnp.zeros((), jnp.int32)),
                        params=replicate(mesh, fresh()),
                        opt_state=replicate(mesh, opt.init(fresh())),
                        ema_params=replicate(mesh, fresh()) if use_ema else None)
    rng = jax.random.PRNGKey(5)
    jbatch = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    losses, draws = [], []
    for i in range(steps):
        state, loss = step(state, jbatch, rng)
        losses.append(float(loss))
        draws.append(_jax_draws(rng, i, diffusion, batch["latents"]))
    ema = (jax.tree_util.tree_map(np.asarray, state.ema_params) if use_ema else None)
    return losses, jax.tree_util.tree_map(np.asarray, state.params), ema, draws


class _SGD:
    """``optax.sgd(lr)``'s mirror: p <- p - lr · grad."""

    def __init__(self, params, lr=1.0):
        self.params, self.lr = [p for p in params], lr

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is not None:  # JAX's gradient of an unused parameter is 0
                p.sub_(self.lr * p.grad)


def _port_unet(params, use_checkpoint=True, dropout_off=True):
    unet = UNetSD_T2VBase(**dict(UNET, use_checkpoint=use_checkpoint))
    unet.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), unet))
    if dropout_off:
        for m in unet.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    return unet.train()


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _to_torch_names(tree, module):
    return {k: v.numpy() for k, v in state_dict_from_flax(
        flatten_tree(tree["params"]), module).items()}


def _max_rel(got: dict, want: dict, floor: float = GRAD_FLOOR, tol: float = GRAD_TOL) -> float:
    top = max(np.abs(w).max() for w in want.values())
    worst = 0.0
    for k, w in want.items():
        scale = np.abs(w).max() + floor * top / tol
        worst = max(worst, float(np.abs(got[k] - w).max() / scale))
    return worst


def _sgd_step(setup, batch, use_checkpoint=True):
    """One port step with SGD(1) and the JAX draws; returns (loss, grads by
    torch name, the step's module)."""
    _, params, _, zero_y = setup
    unet = _port_unet(params, use_checkpoint)
    old = {k: p.detach().clone() for k, p in unet.named_parameters()}
    step = build_train_step(make_t2v_apply(unet), GaussianDiffusion(**DIFFUSION), use_ema=False,
                            p_zero=P_ZERO, zero_y=torch.from_numpy(zero_y))
    state = TrainState(step=0, unet=unet, optimizer=_SGD(unet.parameters()))
    return step, state, old


@pytest.fixture(scope="module")
def jax_sgd(setup):
    _, params, batch, _ = setup
    losses, new, _, draws = _jax_run(setup, batch, optax.sgd(1.0))
    grads = jax.tree_util.tree_map(lambda o, n: np.asarray(o) - n, params, new)
    return losses[0], grads, draws[0]


def test_one_step_matches_jax(setup, jax_sgd):
    jloss, jgrads, draws = jax_sgd
    _, _, batch, _ = setup
    step, state, old = _sgd_step(setup, batch)
    loss = step(state, _tbatch(batch), draws=draws)
    assert state.step == 1 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    grads = {k: (old[k] - p.detach()).numpy() for k, p in state.unet.named_parameters()}
    want = _to_torch_names(jgrads, state.unet)
    assert set(want) == set(grads)
    assert max(np.abs(w).max() for w in want.values()) > 1e-4  # gradients worth comparing
    assert _max_rel(grads, want) <= GRAD_TOL


def test_a_dropped_row_takes_zero_y(setup, jax_sgd):
    """The loss with row 0 dropped equals the loss with row 0's text
    replaced by ``zero_y`` by hand and nothing dropped."""
    _, _, draws = jax_sgd
    _, params, batch, zero_y = setup
    step, _, _ = _sgd_step(setup, batch)
    drop = TrainDraws(draws.t, draws.noise, torch.tensor([True, False]))
    keep = TrainDraws(draws.t, draws.noise, torch.tensor([False, False]))
    manual = dict(batch, y_words=np.concatenate([np.broadcast_to(zero_y, (1, L, CTX)),
                                                 batch["y_words"][1:]]))
    with torch.no_grad():
        a = step.loss_fn(_tbatch(batch), drop)
        b = step.loss_fn(_tbatch(manual), keep)
        c = step.loss_fn(_tbatch(batch), keep)
    assert float(a) == pytest.approx(float(b), rel=1e-6) and float(a) != float(c)


def test_checkpointed_step_equals_plain(setup):
    """Block checkpointing recomputes each block in the backward pass with
    the forward's RNG state: with dropout on, the loss and the gradients
    equal those of the unchekpointed UNet from the same generator."""
    _, params, batch, zero_y = setup
    out = []
    for ckpt in (True, False):
        unet = _port_unet(params, use_checkpoint=ckpt, dropout_off=False)
        assert any(isinstance(m, torch.nn.Dropout) and m.p > 0 for m in unet.modules())
        step = build_train_step(make_t2v_apply(unet), GaussianDiffusion(**DIFFUSION),
                                use_ema=False, p_zero=P_ZERO, zero_y=torch.from_numpy(zero_y))
        state = TrainState(step=0, unet=unet, optimizer=_SGD(unet.parameters(), lr=0.0))
        state.optimizer.step = lambda: None  # keep the gradients for the comparison
        loss = step(state, _tbatch(batch), generator=torch.Generator().manual_seed(7))
        out.append((float(loss), {k: p.grad.clone() for k, p in unet.named_parameters()}))
    (l1, g1), (l2, g2) = out
    assert l1 == pytest.approx(l2, rel=1e-6)
    for k in g1:
        torch.testing.assert_close(g1[k], g2[k], rtol=1e-5, atol=1e-7 * float(g2[k].abs().max()))


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_unported_remat_policies_raise(policy):
    """``remat_policy`` dots / dots_no_batch (set by no shipped config) raise
    naming themselves; ``full`` builds and an unknown policy is refused."""
    with pytest.raises(NotImplementedError, match=policy):
        UNetSD_T2VBase(**dict(UNET, remat_policy=policy))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        UNetSD_T2VBase(**dict(UNET, remat_policy=policy + "_x"))
    assert UNetSD_T2VBase(**dict(UNET, remat_policy="full")).remat_policy == "full"


def test_the_step_draws_from_its_generator_only(setup):
    """Same generator seed → same draws, dropout masks and update, whatever
    the global RNG holds; the global RNG is left as it was; the generator
    advances past the dropout draws."""
    _, params, batch, zero_y = setup
    results = []
    for global_seed in (0, 1):
        unet = _port_unet(params, dropout_off=False)
        step = build_train_step(make_t2v_apply(unet), GaussianDiffusion(**DIFFUSION),
                                use_ema=False, p_zero=P_ZERO, zero_y=torch.from_numpy(zero_y))
        state = TrainState(step=0, unet=unet, optimizer=_SGD(unet.parameters(), lr=1e-3))
        gen = torch.Generator().manual_seed(11)
        torch.manual_seed(global_seed)
        before = torch.get_rng_state()
        loss = step(state, _tbatch(batch), generator=gen)
        assert torch.equal(torch.get_rng_state(), before)
        after = torch.Generator().manual_seed(11)
        draw_train_randoms(after, _tbatch(batch)["latents"], GaussianDiffusion(**DIFFUSION),
                           P_ZERO)
        assert not torch.equal(gen.get_state(), after.get_state())  # dropout drew from it
        results.append((float(loss), [p.detach().clone() for p in unet.parameters()],
                        gen.get_state()))
    (l0, p0, s0), (l1, p1, s1) = results
    assert l0 == l1 and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
