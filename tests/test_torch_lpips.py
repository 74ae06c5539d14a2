"""The port's LPIPS against the JAX package's, fp32 on the CPU, on the same
seeded weights through the Flax-tree bridge: the distance, and its gradient
with respect to the second image (the rendered view in training)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_port_helpers import flatten_tree, seeded_like, set_torch_threads
from videomv_tpu.models.lpips import LPIPS as JLPIPS
from videomv_tpu_torch.models.lpips import LPIPS
from videomv_tpu_torch.training.checkpoints import (
    load_matched,
    rename_lpips_key,
    state_dict_from_flax,
)

set_torch_threads()

SIZE = 32
# fp32 both sides, 13 convolutions deep; seeded lin heads of either sign
TOL = 2e-4


def _models():
    jm = JLPIPS()
    probe = jnp.zeros((1, 3, SIZE, SIZE))
    params = seeded_like(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), probe, probe)), 61)
    tm = LPIPS()
    tm.load_state_dict(state_dict_from_flax(flatten_tree(params["params"]), tm))
    return jm, params, tm.eval()


def test_lpips_forward_and_input_gradient_match_jax():
    jm, params, tm = _models()
    rs = np.random.default_rng(6)
    x0 = rs.uniform(-1, 1, (3, 3, SIZE, SIZE)).astype(np.float32)
    x1 = rs.uniform(-1, 1, (3, 3, SIZE, SIZE)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x0), jnp.asarray(x1)))
    want_grad = np.asarray(jax.grad(
        lambda b: jnp.mean(jm.apply(params, jnp.asarray(x0), b)))(jnp.asarray(x1)))
    t1 = torch.from_numpy(x1).requires_grad_()
    got = tm(torch.from_numpy(x0), t1)
    assert got.shape == (3,)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL, atol=TOL * scale)
    (got_grad,) = torch.autograd.grad(got.mean(), t1)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=TOL,
                               atol=TOL * np.abs(want_grad).max())
    # identical images are at distance 0
    with torch.no_grad():
        assert float(tm(torch.from_numpy(x0), torch.from_numpy(x0)).abs().max()) == 0.0


def test_lpips_loads_released_key_names():
    """The module's keys are the released ``vgg.pth`` keys; the ModuleList
    form and an LGM checkpoint's ``lpips_loss.`` prefix are renamed, the
    scaling layer's buffers dropped."""
    tm = LPIPS()
    sd = {k: torch.randn_like(v) for k, v in tm.state_dict().items()}
    assert "net.slice2.5.weight" in sd and "lin3.model.1.weight" in sd and len(sd) == 31
    released = {}
    for k, v in sd.items():
        k = "lins." + k[3:] if k.startswith("lin") else k
        released["lpips_loss." + k] = v
    released["lpips_loss.scaling_layer.shift"] = torch.zeros(1, 3, 1, 1)
    report = load_matched(tm, released, rename_lpips_key)
    assert not report["missing"] and not report["unexpected"] and not report["mismatched"]
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k]), k
