"""The seeded initialisation (``training.checkpoints.init_weights`` and
``init_models``) draws the same values as the plain sequential loop it
replaced: each parameter drawn from the module's numpy stream, scaled and
copied in turn. Pinned two ways: a SHA-256 of the weights of two small
modules, computed with that loop, and the loop itself kept here as the
reference."""

import hashlib
import math

import numpy as np
import pytest
import torch

from torch_port_helpers import set_torch_threads
from videomv_tpu_torch.models import UNetSD_T2VBase
from videomv_tpu_torch.models.lgm import LGM, LGMOptions
from videomv_tpu_torch.training.checkpoints import _zero_init_names, init_models, init_weights

set_torch_threads()

UNET = dict(dim=32, y_dim=16, context_dim=16, dim_mult=(1, 2), num_heads=2, head_dim=16,
            num_res_blocks=1, attn_scales=(1.0,))
LGM_OPT = dict(input_size=16, down_channels=(32, 64), down_attention=(False, True),
               mid_attention=True, up_channels=(64, 32), up_attention=(True, False),
               splat_size=16, output_size=16, num_views=3, num_input_views=2)
MODELS = {"unet": lambda: UNetSD_T2VBase(**UNET), "lgm": lambda: LGM(LGMOptions(**LGM_OPT))}
# SHA-256 over (name, float32 bytes) in named_parameters order, seed 5, from
# the sequential loop (the LGM has no zero-initialised layer)
PINNED = {
    ("unet", True): "4cfe613c88b5802edc27cefc72ff1b41d6705895c06589aef5e03fc98851f375",
    ("unet", False): "03ed7932fbc6d02cbb1656237c6b186a96979dac8ea3d879388f4f48e7cb63c6",
    ("lgm", True): "2448b4a8548bfbe968b6f7e4ef6714d50dde9b3fd633a8864af2e07d9b03262c",
    ("lgm", False): "2448b4a8548bfbe968b6f7e4ef6714d50dde9b3fd633a8864af2e07d9b03262c",
}


def _meta(name):
    with torch.device("meta"):
        return MODELS[name]()


def _digest(module):
    h = hashlib.sha256()
    for n, p in module.named_parameters():
        h.update(n.encode())
        h.update(p.detach().numpy().astype(np.float32).tobytes())
    return h.hexdigest()


@torch.no_grad()
def _sequential(module, seed, zero_init):
    """The reference: draw, scale and copy each parameter in turn."""
    module.to_empty(device="cpu")
    rng = np.random.default_rng(seed)
    zeros = _zero_init_names(module) if zero_init else set()
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        n = rng.standard_normal(shape, dtype=np.float32)
        if name in zeros:
            val = np.zeros(shape, np.float32)
        elif len(shape) >= 2:
            val = n * np.float32(math.prod(shape[1:]) ** -0.5)
        elif name.endswith("weight"):
            val = 1.0 + 0.1 * n
        else:
            val = 0.1 * n
        p.copy_(torch.from_numpy(val))
    return module


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("zero_init", [True, False])
def test_init_weights_draws_the_pinned_values(name, zero_init):
    module = init_weights(_meta(name), 5, zero_init=zero_init, device="cpu")
    assert _digest(module) == PINNED[(name, zero_init)]
    assert _digest(_sequential(_meta(name), 5, zero_init)) == PINNED[(name, zero_init)]
    if zero_init and name == "unet":
        assert not module.out[2].weight.any()  # a zero-initialised layer


def test_init_models_equals_one_module_after_another():
    jobs = [("unet", 3), ("lgm", 4), ("unet", 9)]
    got = [(_meta(name), seed) for name, seed in jobs]
    init_models(got, zero_init=False, device="cpu")
    for (module, seed), (name, _) in zip(got, jobs):
        want = _sequential(_meta(name), seed, False)
        for (n, a), (_, b) in zip(module.named_parameters(), want.named_parameters()):
            assert torch.equal(a, b), n
    init_models([])  # nothing to seed
