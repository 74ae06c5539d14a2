"""The port's learning-rate schedule and optimizers against the JAX
package's ``annealing_lr`` and the optax chains ``build_optimizer`` builds
(AdamW with a bf16 first moment, Adafactor, the SD-key gradient scale,
``fix_weight`` as a scale of 0, clipping by the global norm), on the same
gradients; the key matcher marks the same parameters as the JAX one."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import set_torch_threads
from videomv_tpu.training.optim import annealing_lr as jannealing_lr
from videomv_tpu.training.optim import build_optimizer as jbuild_optimizer
from videomv_tpu_torch.training.optim import (
    Adafactor,
    AdamW,
    annealing_lr,
    build_optimizer,
    clip_by_global_norm_,
    sd_key_matcher,
)

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
    with pytest.raises(ValueError, match="optimizer"):
        build_optimizer(p, optimizer="sgd")
    with pytest.raises(ValueError, match="fp32"):
        AdamW([torch.nn.Parameter(torch.ones(2, dtype=torch.bfloat16))], lambda s: 0.0)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SD_KEYS = os.path.join(REPO, "data", "stable_diffusion_image_key_temporal_attention_x1.json")


def _run_both(jopt, topt_factory, named, grads, steps):
    """``steps`` updates of the optax chain ``jopt`` on a flax-style tree
    and of the port's optimizer on the same named tensors; returns both
    parameter sets (torch names) and the port's optimizer."""
    jtree = {"params": {}}
    for name, flax_path, value in named:
        node = jtree["params"]
        for part in flax_path[:-1]:
            node = node.setdefault(part, {})
        node[flax_path[-1]] = jnp.asarray(value)

    def jgrads(i):
        out = jax.tree_util.tree_map(lambda x: x, jtree)
        for name, flax_path, _ in named:
            node = out["params"]
            for part in flax_path[:-1]:
                node = node[part]
            node[flax_path[-1]] = jnp.asarray(grads[i][name])
        return out

    jstate = jopt.init(jtree)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(v.copy())) for n, _, v in named}
    topt = topt_factory(list(tparams.items()))
    for i in range(steps):
        updates, jstate = jopt.update(jgrads(i), jstate, jtree)
        jtree = optax.apply_updates(jtree, updates)
        for n, p in tparams.items():
            p.grad = torch.from_numpy(grads[i][n].copy())
        topt.step()
    want = {}
    for name, flax_path, _ in named:
        node = jtree["params"]
        for part in flax_path:
            node = node[part]
        want[name] = np.asarray(node)
    return {n: p.detach().numpy() for n, p in tparams.items()}, want, topt


# (torch name, flax path, shape): the first three are SD-origin keys, the
# camera MLP is not; the weight of a 2-D kernel is [out, in] in torch and
# [in, out] in flax, which no elementwise chain tells apart
NAMED_SHAPES = [("input_blocks.0.0.bias", ("input_blocks_0_0", "bias"), (16,)),
                ("out.2.weight", ("out_2", "kernel"), (12, 8)),
                ("out.2.bias", ("out_2", "bias"), (8,)),
                ("camera_embedding.0.weight", ("camera_embedding_0", "kernel"), (6, 8))]


def _named_and_grads(steps, seed, scale=1.0):
    rs = np.random.default_rng(seed)
    named = [(n, fp, rs.standard_normal(s).astype(np.float32)) for n, fp, s in NAMED_SHAPES]
    grads = [{n: (rs.standard_normal(v.shape) * scale).astype(np.float32) for n, _, v in named}
             for _ in range(steps)]
    return named, grads


@pytest.mark.parametrize("grad_scale", [0.5, 0.0])
def test_sd_key_grad_scale_and_fix_weight_match_jax(grad_scale):
    """``Pretrain.grad_scale`` 0.5 and ``fix_weight`` (a scale of 0): the
    listed keys take scaled gradients before AdamW."""
    named, grads = _named_and_grads(3, 31)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=100, grad_scale=grad_scale,
              sd_keys_path=SD_KEYS)
    got, want, topt = _run_both(jbuild_optimizer(**kw), lambda p: build_optimizer(p, **kw),
                                named, grads, 3)
    assert [topt.names[i] for i in topt.scaled] == [
        "input_blocks.0.0.bias", "out.2.weight", "out.2.bias"]
    for n in got:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=1e-7)
    start = {n: v for n, _, v in named}
    if grad_scale == 0.0:  # fix_weight: the SD keys stay, the rest moves
        assert all(np.array_equal(got[topt.names[i]], start[topt.names[i]]) for i in topt.scaled)
    assert not np.array_equal(got["camera_embedding.0.weight"], start["camera_embedding.0.weight"])


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_grad_clip_matches_clip_by_global_norm(scale):
    """Clipping at a global norm of 1: small gradients pass unchanged,
    large ones are rescaled, before the key scale and AdamW."""
    named, grads = _named_and_grads(2, 32, scale)
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=100, grad_clip=1.0, grad_scale=0.5,
              sd_keys_path=SD_KEYS)
    got, want, _ = _run_both(jbuild_optimizer(**kw), lambda p: build_optimizer(p, **kw),
                             named, grads, 2)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=1e-7)
    # the clip itself against optax on one gradient set
    g = [torch.from_numpy(grads[0][n].copy()) for n, _, _ in NAMED_SHAPES]
    jg, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(x.numpy()) for x in g], None)
    clip_by_global_norm_(g, 1.0)
    for a, b in zip(g, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_adafactor_matches_optax():
    """Three updates of ``optimizer: adafactor`` against the JAX package's
    ``optax.adafactor`` chain: one factored parameter (two axes >= 128, one
    of them the leading axis in torch and the trailing one in flax, as for a
    kernel) and unfactored ones (a vector, a small matrix)."""
    rs = np.random.default_rng(33)
    shapes = [("big.weight", ("big", "kernel"), (160, 130)),
              ("conv.weight", ("conv", "kernel"), (3, 144, 128)),
              ("small.weight", ("small", "kernel"), (7, 5)),
              ("vec.bias", ("vec", "bias"), (11,))]
    named = [(n, fp, (rs.standard_normal(s) * 0.1).astype(np.float32)) for n, fp, s in shapes]
    grads = [{n: (rs.standard_normal(v.shape) * 10.0 ** rs.integers(-3, 1)).astype(np.float32)
              for n, _, v in named} for _ in range(3)]
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=100, optimizer="adafactor")
    got, want, topt = _run_both(jbuild_optimizer(**kw), lambda p: build_optimizer(p, **kw),
                                named, grads, 3)
    assert isinstance(topt, Adafactor) and topt.count == 3
    assert topt.dims == [(1, 0), (2, 1), None, None]
    for n in got:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-7)
    start = {n: v for n, _, v in named}
    assert all(not np.array_equal(got[n], start[n]) for n in got)
    state = topt.state_dict()
    again = build_optimizer([(n, torch.nn.Parameter(torch.zeros(v.shape))) for n, _, v in named],
                            **kw)
    again.load_state_dict(state)
    assert again.count == 3 and all(torch.equal(a, b) for a, b in zip(again.v_row, topt.v_row))


def test_grad_scale_path_errors_match_jax():
    p = [("w", torch.nn.Parameter(torch.ones(2)))]
    with pytest.raises(ValueError, match="sd_keys_path"):
        build_optimizer(p, grad_scale=0.5, sd_keys_path=None)
    with pytest.raises(FileNotFoundError, match="does not exist"):
        build_optimizer(p, grad_scale=0.5, sd_keys_path="/nonexistent/keys.json")
    # the shipped relative path resolves under the repository root
    assert build_optimizer(p, grad_scale=0.5, sd_keys_path=os.path.relpath(
        SD_KEYS, REPO)).grad_scale == 0.5
    assert build_optimizer(p, grad_scale=1.0, sd_keys_path=None).grad_scale is None


def test_sd_key_matcher_marks_the_jax_matchers_set():
    """On the UNet of configs/t2v_train_tiny.yaml: the parameters the port
    matches by name are those the JAX matcher marks in the flax tree, carried
    over to torch names by ``state_dict_from_flax``."""
    from videomv_tpu.models import UNetSD_T2VBase as JUNet
    from videomv_tpu.training.optim import sd_key_matcher as jmatcher
    from videomv_tpu_torch.models import UNetSD_T2VBase
    from videomv_tpu_torch.training.checkpoints import state_dict_from_flax

    kw = dict(dim=64, y_dim=32, context_dim=32, dim_mult=(1, 2), num_heads=2, head_dim=32,
              num_res_blocks=1, dropout=0.0)
    shapes = jax.eval_shape(lambda: JUNet(**kw).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 2, 8, 8)), jnp.zeros((1,), jnp.int32),
        y=jnp.zeros((1, 3, 32)), camera_data=jnp.zeros((1, 2, 16))))
    jmatch = jmatcher(SD_KEYS)
    marks = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [str(q.key) for q in path if hasattr(q, "key")][1:]
        marks["/".join(keys)] = np.full(leaf.shape, float(jmatch("_".join(keys))), np.float32)
    module = UNetSD_T2VBase(**kw)
    want = {k for k, v in state_dict_from_flax(marks, module).items() if float(v.max()) == 1.0}
    match = sd_key_matcher(SD_KEYS)
    got = {n for n, _ in module.named_parameters() if match(n)}
    assert got == want and len(got) > 50
    with open(SD_KEYS) as f:
        listed = json.load(f)
    assert all(k in listed or k.replace(".bias", ".weight") in listed for k in got)


# ------------------------------------------------ Adafactor over FSDP shards

# shapes whose axis 0 is the largest (its mean over axis 0 spans the
# shards), the second largest (row_col_mean spans them; a 2-D and a 4-D
# kernel), neither, unfactored, and row counts that do not divide by 2 or 3
SHARDED_SHAPES = {"a": (161, 130), "b": (130, 200), "c": (5, 144, 130), "d": (7, 5),
                  "e": (128, 144, 3, 3), "f": (11,)}
ADAFACTOR_KW = dict(lr=1e-2, warmup_steps=1, total_steps=100, optimizer="adafactor")


@pytest.fixture(scope="module")
def sharded_adafactor(tmp_path_factory):
    import torch_parallel_ranks as ranks
    from videomv_tpu_torch.parallel import spawn

    rs = np.random.default_rng(71)
    params = {k: (rs.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in SHARDED_SHAPES.items()}
    grads = [{k: (rs.standard_normal(s) * 10.0 ** rs.integers(-3, 1)).astype(np.float32)
              for k, s in SHARDED_SHAPES.items()} for _ in range(2)]
    tmp = tmp_path_factory.mktemp("rdv")
    got = {n: spawn(ranks.adafactor_shards, n, init_file=str(tmp / f"w{n}"), deadline_s=240,
                    args=(params, grads, ADAFACTOR_KW)) for n in (2, 3)}
    tparams = [(k, torch.nn.Parameter(torch.from_numpy(v.copy()))) for k, v in params.items()]
    opt = build_optimizer(tparams, **ADAFACTOR_KW)
    for g in grads:
        for k, p in tparams:
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return got, {k: p.detach().numpy() for k, p in tparams}, opt


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_adafactor_matches_the_whole_one(sharded_adafactor, world):
    """Two steps over shards (world 2 and 3, uneven rows) against the port's
    unsharded Adafactor, itself held to optax above: parameters and the
    gathered state within 1e-6 of the largest entry."""
    got, want, opt = sharded_adafactor
    whole = opt.state_dict()
    assert opt.dims == [Adafactor._factored_dims(s) for s in SHARDED_SHAPES.values()]
    for r in got[world]:
        assert r["sharded"] == len(SHARDED_SHAPES)
        for k, w in want.items():
            assert np.abs(r["params"][k] - w).max() <= 1e-6 * np.abs(w).max(), k
        assert r["state"]["count"] == whole["count"] == 2
        for key in ("v_row", "v_col", "v"):
            for a, b in zip(r["state"][key], whole[key]):
                assert a.shape == tuple(b.shape)
                np.testing.assert_allclose(a, b.numpy(), rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_adafactor_state_round_trips(sharded_adafactor, world):
    assert all(r["restored_equal"] for r in sharded_adafactor[0][world])
