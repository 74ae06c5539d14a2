"""The port's learning-rate schedule and AdamW against the JAX package's
``annealing_lr`` and the optax chain ``build_optimizer`` builds (AdamW with
a bf16 first moment), on the same gradients."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import set_torch_threads
from videomv_tpu.training.optim import annealing_lr as jannealing_lr
from videomv_tpu.training.optim import build_optimizer as jbuild_optimizer
from videomv_tpu_torch.training.optim import AdamW, annealing_lr, build_optimizer

set_torch_threads()


@pytest.mark.parametrize("mode", ["cosine", "linear", "constant"])
def test_annealing_lr_matches_jax(mode):
    kw = dict(warmup_steps=10, total_steps=1000, decay_mode=mode)
    want, got = jannealing_lr(3e-5, **kw), annealing_lr(3e-5, **kw)
    for step in (0, 1, 5, 9, 10, 11, 250, 999, 1000, 5000):
        # both compute in float32
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)
    assert got(0) == 0.0 and got(10) == pytest.approx(3e-5)


@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_adamw_matches_optax_with_bf16_first_moment(weight_decay):
    """Three updates on the same parameters and gradients. The learning rate
    is large and warm-up short, so every update moves the parameters; the
    first runs at lr(0) = 0, as in optax. Parameters agree to fp32 rounding
    of the update (1e-6 relative), the stored bf16 first moment bit for bit
    or to one bf16 ulp where the fp32 sums differ in their last bit."""
    rs = np.random.default_rng(13)
    shapes = [(7, 5), (11,), (3, 2, 4)]
    params = [rs.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rs.standard_normal(s) * 10.0 ** rs.integers(-3, 1)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    kw = dict(lr=1e-2, weight_decay=weight_decay, warmup_steps=2, total_steps=100)

    jopt = jbuild_optimizer(**kw)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = build_optimizer(tparams, **kw)
    assert isinstance(topt, AdamW) and topt.mu[0].dtype == torch.bfloat16

    for i, gs in enumerate(grads):
        updates, jstate = jopt.update([jnp.asarray(g) for g in gs], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, gs):
            p.grad = torch.from_numpy(g.copy())
        lr = topt.step()
        assert (lr == 0.0) == (i == 0)
        for tp, jp in zip(tparams, jparams):
            np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    adam = jstate[0][0]  # chain -> adamw chain -> ScaleByAdamState
    assert int(adam.count) == topt.count == 3
    for tm, jm in zip(topt.mu, adam.mu):
        assert jm.dtype == jnp.bfloat16
        np.testing.assert_allclose(tm.float().numpy(), np.asarray(jm.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-30)
    for tv, jv in zip(topt.nu, adam.nu):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-30)
    # the parameters did move after warm-up
    assert max(float(np.abs(tp.detach().numpy() - p).max())
               for tp, p in zip(tparams, params)) > 1e-3


def test_optimizer_state_round_trip_and_unported_branches():
    p = [torch.nn.Parameter(torch.ones(4))]
    opt = build_optimizer(p, lr=1e-2, warmup_steps=0)
    p[0].grad = torch.full((4,), 0.5)
    opt.step()
    state = opt.state_dict()
    other = build_optimizer([torch.nn.Parameter(torch.ones(4))], lr=1e-2, warmup_steps=0)
    other.load_state_dict(state)
    assert other.count == 1 and torch.equal(other.mu[0], opt.mu[0])
    assert torch.equal(other.nu[0], opt.nu[0])
    with pytest.raises(ValueError):
        other.load_state_dict({"count": 1, "mu": [torch.zeros(3)], "nu": [torch.zeros(3)]})
    with pytest.raises(NotImplementedError, match="adafactor"):
        build_optimizer(p, optimizer="adafactor")
    with pytest.raises(ValueError, match="fp32"):
        AdamW([torch.nn.Parameter(torch.ones(2, dtype=torch.bfloat16))], lambda s: 0.0)
