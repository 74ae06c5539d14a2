"""The plain reference against the port at tiny sizes on the CPU, in fp32:
each model on the same seeded weights, the capacity-bounded render against
the port's binned render, the DDIM step against the port's sampler, and the
work counts of a served request."""

import functools

import pytest
import torch

from mvbench import weights
from mvbench.reference import counting, nets, render
from mvbench.reference.diffusion import DDIM, guided
from mvbench.reference.lowp import q8

torch.manual_seed(0)


def _pair(ref_cls, port_cls, seed, **kw):
    with torch.device("meta"):
        ref = ref_cls(**kw.get("ref", {}))
    ref.to_empty(device="cpu")
    port = port_cls()
    shapes = [(n, t.shape) for n, t in ref.state_dict().items()]
    sd = weights.seeded_state_dict(shapes, seed, "m", "cpu", torch.float32)
    ref.load_state_dict(sd)
    port.load_state_dict(sd)
    return ref.eval(), port.eval()


def _rel(a, b):
    return float((a - b).norm() / b.norm())


UNET = dict(dim=64, context_dim=64, dim_mult=(1, 2), num_heads=2, head_dim=32,
            num_res_blocks=1, attn_scales=(1.0, 0.5, 0.25))


@pytest.mark.parametrize("i2v", [False, True], ids=["t2v", "i2v"])
def test_unet_matches_the_port(i2v):
    from videomv_tpu_torch.models import UNetSD_T2VBase
    from videomv_tpu_torch.models.unet_i2v import UNetSD_I2VGen

    port_cls = functools.partial(UNetSD_I2VGen if i2v else UNetSD_T2VBase, y_dim=64, dropout=0.0,
                                 **UNET)
    ref_cls = nets.UNetI2V if i2v else nets.UNetT2V
    ref, port = _pair(ref_cls, port_cls, 3, ref=dict(UNET, **({"y_dim": 64} if i2v else {})))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 4, 6, 8, 8, generator=g)
    t = torch.tensor([981, 501])
    kw = dict(y=torch.randn(2, 5, 64, generator=g), camera_data=torch.randn(2, 6, 16, generator=g))
    if i2v:
        kw.update(local_image=torch.randn(2, 4, 1, 8, 8, generator=g),
                  image=torch.randn(2, 64, generator=g))
    with torch.no_grad():
        assert _rel(port(x, t, **kw), ref(x, t, **kw)) < 1e-5


def test_vae_and_text_and_visual_towers_match_the_port():
    from videomv_tpu_torch.models import AutoencoderKL
    from videomv_tpu_torch.models.clip import CLIPVisionTower, OpenCLIPTextVisual

    vae_kw = dict(ch=32, ch_mult=(1, 1, 2), num_res_blocks=1)
    ref, port = _pair(nets.VAE, functools.partial(AutoencoderKL, **vae_kw), 4, ref=vae_kw)
    g = torch.Generator().manual_seed(2)
    img = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
    z = torch.randn(2, 4, 8, 8, generator=g)
    with torch.no_grad():
        assert _rel(port.decode(z), ref.decode(z)) < 1e-5
        assert _rel(port.encode_first_stage(img, 0.18), 0.18 * ref.encode_mode(img)) < 1e-5
    vis = dict(image_size=28, patch_size=14, width=64, heads=2, layers=2, embed_dim=32)
    text = dict(width=64, heads=2, layers=3, embed_dim=32)
    ref, port = _pair(nets.CLIPText, lambda: OpenCLIPTextVisual(CLIPVisionTower(**vis), **text), 5,
                      ref=dict(text, visual=vis))
    toks = torch.zeros(2, 77, dtype=torch.long)
    toks[:, :5] = torch.tensor([49406, 320, 1125, 539, 49407])
    with torch.no_grad():
        assert _rel(port.encode_text(toks)[1], ref.encode_text(toks)) < 1e-5
        im = torch.randn(2, 3, 28, 28, generator=g)
        assert _rel(port.encode_image(im), ref.visual(im)) < 1e-5


def test_lgm_matches_the_port():
    from videomv_tpu_torch.models.lgm import LGM, LGMOptions

    opt = dict(input_size=32, down_channels=(32, 64), down_attention=(False, True),
               mid_attention=True, up_channels=(64, 32), up_attention=(True, False),
               splat_size=32)
    ref, port = _pair(nets.LGM, lambda: LGM(LGMOptions(**opt, output_size=32)), 6,
                      ref=nets.lgm_options(opt))
    x = torch.randn(1, 4, 9, 32, 32, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert _rel(port(x), ref(x)) < 1e-5


@pytest.mark.parametrize("capacity", [None, 3000], ids=["room", "overflow"])
def test_render_matches_the_port_binned_render_with_its_pair_capacity(capacity):
    from videomv_tpu_torch.data.cameras import (GSCameraSettings, orbit_c2w_opengl,
                                                prepare_gs_training)
    from videomv_tpu_torch.ops.gaussian_splat import render_gaussians

    g = torch.Generator().manual_seed(4)
    n, size = 2048, 64
    gs = torch.cat([torch.rand(n, 3, generator=g) - 0.5, torch.rand(n, 1, generator=g),
                    0.01 + 0.05 * torch.rand(n, 3, generator=g), torch.randn(n, 4, generator=g),
                    torch.rand(n, 3, generator=g)], dim=1)
    gs[:, 7:11] /= gs[:, 7:11].norm(dim=1, keepdim=True)
    cams = prepare_gs_training(orbit_c2w_opengl(4), GSCameraSettings(input_size=size,
                                                                       output_size=size), size)
    cv, cvp = (torch.as_tensor(cams[k]) for k in ("cam_view", "cam_view_proj"))
    cap = capacity or render.capacity(n, size)
    port = render_gaussians(gs[None], cv, cvp, bg_color=torch.full((3,), 0.5), img_size=size,
                            backend="binned", max_pairs=cap)["image"][0]
    ref, demanded = render.render(gs, cv[0], cvp[0], size, 39.6, 0.5, cap)
    assert (max(demanded) > cap) == (capacity is not None)
    assert _rel(port, ref) < 1e-4


def test_ddim_step_matches_the_port_sampler():
    from videomv_tpu_torch.diffusion import GaussianDiffusion
    from videomv_tpu_torch.diffusion.samplers import _ddim_update, _pred_x0, ddim_timestep_seq

    for d in ({"schedule": "linear_sd", "schedule_param": {"num_timesteps": 1000,
               "init_beta": 0.00085, "last_beta": 0.012}, "mean_type": "eps"},
              {"schedule": "cosine", "schedule_param": {"num_timesteps": 1000,
               "cosine_s": 0.008, "zero_terminal_snr": True}, "mean_type": "v"}):
        port, ref = GaussianDiffusion(**d), DDIM(d)
        assert ref.timesteps(50) == [int(s) for s in ddim_timestep_seq(1000, 50)]
        g = torch.Generator().manual_seed(5)
        xt, c, u = (torch.randn(1, 4, 3, 4, 4, generator=g) for _ in range(3))
        for step in (981, 501, 21, 1):
            t = torch.tensor([step])
            out = u + 9.0 * (c - u)
            want = _ddim_update(port, _pred_x0(port, out, xt, t, None, None, False), xt, t, 20,
                                0.0, None)
            got = ref.step(ref.x0(guided(c, u, 9.0), xt, step), xt, step, 20)
            assert _rel(want.double(), got) < 1e-4  # fp32 against float64


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(6))
    e8, e16 = _rel(q8(x), x), _rel(x.bfloat16().float(), x)
    assert 0.01 < e8 < 0.05 and e16 < 0.005


def test_work_of_a_served_request_counts_the_kernels_calls():
    import json
    import os

    cfg = json.load(open(os.path.join(os.path.dirname(__file__), "..", "configs", "t2v.json")))
    refined = counting.serve_request(cfg, False, True, 50)
    plain = counting.serve_request(cfg, False, False, 50)
    self_attn = lambda w, shape: sum(1 for k, s, m in (c for c in w["calls"] if c[0] == "attn")
                                     if s == shape and not m)
    # 47 CFG forwards of 48 rows and 3 cond-row forwards of 24 rows, 5 self-attentions at 32²
    assert self_attn(refined, (48, 1024, 1024, 5, 64)) == 47 * 5
    assert self_attn(refined, (24, 1024, 1024, 5, 64)) == 3 * 5
    assert self_attn(plain, (48, 1024, 1024, 5, 64)) == 50 * 5
    # the LGM's cross-view attention at 16² (5 blocks) and 8² (6), each refine
    assert self_attn(refined, (1, 1024, 1024, 16, 64)) == 3 * 5
    assert self_attn(refined, (1, 256, 256, 16, 64)) == 3 * 6
    ffn = [s for k, s, *_ in refined["calls"] if k == "ffn"]
    assert sum(1 for s in ffn if s == (49152, 320, 1280)) == 47 * 10
    assert 0.4e15 < plain["flops"] < refined["flops"] < 2e15
