"""The rank bodies of the multi-rank tests (``tests/test_torch_parallel_*.py``).

Each function runs in one process of ``videomv_tpu_torch.parallel.mesh.spawn``
(gloo on the CPU, one thread), imports torch and the port only (a rank starts
from a fresh interpreter and never loads JAX), takes numpy inputs and state
dicts from the test, and returns numpy results."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class SGD:
    """``optax.sgd(lr)``'s mirror, p <- p - lr · grad, over plain or
    FSDP-sharded parameters."""

    def __init__(self, params, lr=1.0):
        self.params, self.lr = list(params), lr

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is not None:
                p.sub_(self.lr * p.grad)


class HalfDenoiser(torch.nn.Module):
    """A stand-in UNet whose eps is ``x_t / 2``: it mixes no frames and no
    rows and rounds nothing, so every placement of a sample reaches the
    refine with the same bits and the refine alone (the canonical views'
    decode and gather, the LGM, the view-sharded render, the encode)
    decides how far the placement departs from one rank."""

    def forward(self, x, t, **kw):
        return 0.5 * x


def full(t):
    """A parameter or gradient as a whole numpy array (gathered when it is
    an FSDP shard)."""
    from torch.distributed.tensor import DTensor

    t = t.detach()
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


def _dropout_off(module):
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return module


def _tensors(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


# ------------------------------------------------------------------ train


def unet_train(rank, n, unet_kw, sd, diffusion_kw, batch, zero_y, draws, p_zero, adamw_kw):
    """The UNet finetune's data-parallel step, replicated and FSDP-sharded:
    one SGD(1) step (loss and gradient, ``old - new``), then two steps of the
    shipped AdamW chain with EMA from the same weights (losses, parameters,
    EMA). ``draws`` are the global batch's, one per step."""
    from torch.distributed.tensor import DTensor

    from videomv_tpu_torch.diffusion import GaussianDiffusion
    from videomv_tpu_torch.models import UNetSD_T2VBase
    from videomv_tpu_torch.parallel import (
        TrainDraws,
        TrainState,
        apply_fsdp,
        build_train_step,
        make_mesh,
        make_t2v_apply,
        shard_batch,
    )
    from videomv_tpu_torch.training.optim import build_optimizer, local_tensor

    mesh = make_mesh(n)
    local = shard_batch(mesh, _tensors(batch))
    draws = [TrainDraws(*(torch.from_numpy(np.asarray(x)) for x in d)) for d in draws]
    out = {}
    for mode in ("replicated", "fsdp") if n > 1 else ("replicated",):
        def unet():
            u = UNetSD_T2VBase(**unet_kw)
            u.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
            u = _dropout_off(u).train()
            if mode == "fsdp":
                apply_fsdp(u.fsdp_units(), mesh, min_size=1024)
            return u

        def step_fn(u, **kw):
            return build_train_step(make_t2v_apply(u), GaussianDiffusion(**diffusion_kw),
                                    p_zero=p_zero, zero_y=torch.from_numpy(zero_y), mesh=mesh,
                                    **kw)

        u = unet()
        old = {k: full(p) for k, p in u.named_parameters()}
        state = TrainState(0, u, SGD(u.parameters()))
        loss = float(step_fn(u, use_ema=False)(state, local, draws=draws[0]))
        grads = {k: old[k] - full(p) for k, p in u.named_parameters()}

        u = unet()
        ema = [local_tensor(p.detach()).clone() for p in u.parameters()]
        state = TrainState(0, u, build_optimizer(u.named_parameters(), **adamw_kw), ema)
        step = step_fn(u, use_ema=True, ema_decay=0.9)
        losses = [float(step(state, local, draws=d)) for d in draws[:2]]
        params = {k: full(p) for k, p in u.named_parameters()}
        ema_full = {}
        for (k, p), e in zip(u.named_parameters(), state.ema):
            if isinstance(p, DTensor):
                e = DTensor.from_local(e, p.device_mesh, p.placements, shape=p.shape,
                                       stride=p.stride()).full_tensor()
            ema_full[k] = e.numpy().copy()
        sharded = sum(isinstance(p, DTensor) for p in u.parameters())
        out[mode] = dict(loss=loss, grads=grads, losses=losses, params=params, ema=ema_full,
                         sharded=sharded)
    return out


def lgm_refine(rank, n, models, unet_kw, vae_kw, lgm_kw, diffusion_kw, step_kw, batch, draws):
    """One data-parallel LGM-refine step with SGD(1): loss and the LGM's
    gradients (``old - new``)."""
    from videomv_tpu_torch.diffusion import GaussianDiffusion
    from videomv_tpu_torch.models import AutoencoderKL, UNetSD_T2VBase
    from videomv_tpu_torch.models.lgm import LGM, LGMOptions
    from videomv_tpu_torch.models.lpips import LPIPS
    from videomv_tpu_torch.parallel import make_mesh, make_t2v_apply, shard_batch
    from videomv_tpu_torch.training.lgm_refine import (
        LGMTrainState,
        RefineDraws,
        build_lgm_refine_step,
    )

    def load(module, name):
        module.load_state_dict({k: torch.from_numpy(v) for k, v in models[name].items()})
        return module

    mesh = make_mesh(n)
    unet = load(UNetSD_T2VBase(**unet_kw), "unet").eval().requires_grad_(False)
    vae = load(AutoencoderKL(**vae_kw), "vae").eval().requires_grad_(False)
    lpips = load(LPIPS(), "lpips").eval().requires_grad_(False)
    lgm = load(LGM(LGMOptions(**lgm_kw)), "lgm").train()
    step = build_lgm_refine_step(make_t2v_apply(unet), vae, lgm, GaussianDiffusion(**diffusion_kw),
                                 lpips=lpips, mesh=mesh, **step_kw)
    old = {k: p.detach().clone() for k, p in lgm.named_parameters()}
    d = RefineDraws(**{k: torch.from_numpy(np.array(v)) for k, v in draws.items()},
                    dropout_seed=0)
    loss, _ = step(LGMTrainState(0, lgm, SGD(lgm.parameters())), shard_batch(mesh,
                   _tensors(batch)), draws=d)
    return dict(loss=float(loss),
                grads={k: (old[k] - p.detach()).numpy() for k, p in lgm.named_parameters()})


def _small_towers():
    import videomv_tpu_torch.training.engine as engine
    from videomv_tpu_torch.models import AutoencoderKL, CLIPTextTower

    os.chdir(REPO)
    engine.CLIPTextTower = functools.partial(CLIPTextTower, width=64, heads=2, layers=3)
    engine.AutoencoderKL = functools.partial(AutoencoderKL, ch=32, ch_mult=(1, 1, 1, 2),
                                             num_res_blocks=1)
    return engine


def engine_runs(rank, n, log_dir):
    """The training CLI (as ``torchrun`` starts it) on
    configs/lgm_refine_train_tiny.yaml (``dp_devices: 2``), then the plain
    UNet finetune of configs/t2v_train_tiny.yaml under ``param_sharding:
    fsdp``: two steps, a save, a restore into a fresh trainer. At a world
    other than 2 the first raises; the error is returned."""
    from videomv_tpu_torch.config import load_config
    from videomv_tpu_torch.training.__main__ import main

    engine = _small_towers()
    small = ["UNet.context_dim", "64", "save_ckp_interval", "0", "training_dtype", "float32"]
    try:
        loss = main(["--cfg", "configs/lgm_refine_train_tiny.yaml", "--steps", "2",
                     "--batch-size", "2", "--device", "cpu", *small, "log_dir", log_dir])
    except ValueError as e:
        return {"error": str(e)}
    out = {"refine_loss": loss}
    cfg = load_config("configs/t2v_train_tiny.yaml",
                      opts=[*small, "log_dir", log_dir, "param_sharding", "fsdp",
                            "lr", "1e-3", "warmup_steps", "0"])
    tr = engine.T2VTrainer(cfg, device="cpu").init(zero_init=False)
    out["unet_loss"] = tr.train(num_steps=2, batch_size=2)
    path = tr.save(os.path.join(log_dir, "ckpt"))
    state = {"params": {k: full(p) for k, p in tr.unet.named_parameters()},
             "mu": [m.float().numpy().copy() for m in tr._full(tr.state.optimizer.mu)],
             "ema": [e.numpy().copy() for e in tr._full(tr.state.ema)]}
    back = engine.T2VTrainer(cfg, device="cpu").init(zero_init=False).restore(path)
    out["restored_equal"] = (
        back.state.step == tr.state.step
        and all(np.array_equal(state["params"][k], full(p))
                for k, p in back.unet.named_parameters())
        and all(np.array_equal(a, b.float().numpy())
                for a, b in zip(state["mu"], back._full(back.state.optimizer.mu)))
        and all(np.array_equal(a, b.numpy())
                for a, b in zip(state["ema"], back._full(back.state.ema))))
    out["sharded"] = sum(type(p).__name__ == "DTensor" for p in tr.unet.parameters())
    return out


# ---------------------------------------------------------------- serving


def pipeline(cfg_path, opts, models, vae_kw, lgm_kw=None, i2v=False):
    """The tiny T2V (or I2V) pipeline of ``cfg_path`` on the CPU with a small
    VAE (and LGM) and the given weights, by model name."""
    from videomv_tpu_torch.config import load_inference_config
    from videomv_tpu_torch.inference import I2VPipeline, T2VPipeline
    from videomv_tpu_torch.models import AutoencoderKL
    from videomv_tpu_torch.models.lgm import LGM, LGMOptions

    pipe = (I2VPipeline if i2v else T2VPipeline)(load_inference_config(cfg_path, opts=opts),
                                                 device="cpu")
    pipe.vae = AutoencoderKL(**vae_kw)
    if lgm_kw is not None:
        pipe.lgm = LGM(LGMOptions(**lgm_kw))
    pipe.load_state_dicts(**{name: {k: torch.from_numpy(v) for k, v in sd.items()}
                             for name, sd in models.items()})
    return pipe


def serve(rank, n, cfg_path, opts, models, vae_kw, lgm_kw, inputs, jobs, steps):
    """Run ``jobs`` on every rank and return each one's latents (and, for
    ``generate``, the uint8 frames' checksum). A job is a dict: ``kind``
    ``generate`` (one frame-parallel T2V request from the input named by
    ``noise``, default ``noise1``), ``i2v`` (the frame-parallel I2V sampler)
    or ``batch`` (``generate_batch`` with its ``data_parallel`` /
    ``force_batched``), ``refine``, ``serving_tp``, and ``stub`` (the UNet
    replaced by ``HalfDenoiser``); or ``refused``, which
    asks a ``serving_tp`` pipeline for a data-parallel batch and a
    single-rank request and returns the errors they raise.
    Each ``serving_tp`` has its pipeline (tensor parallelism cuts the UNet in
    place)."""
    inp = {k: torch.from_numpy(v) for k, v in inputs.items()}
    pipes, out = {}, []
    for job in jobs:
        tp, stub = int(job.get("serving_tp", 1)), bool(job.get("stub"))
        if (tp, stub) not in pipes:
            pipes[tp, stub] = pipeline(cfg_path, [*opts, "serving_tp", str(tp)], models, vae_kw,
                                       lgm_kw, i2v=job["kind"] == "i2v")
            if stub:
                pipes[tp, stub].unet = HalfDenoiser()
        pipe = pipes[tp, stub]
        if job["kind"] == "refused":
            errors = []
            for call in (lambda: pipe.generate_batch(
                             ["a", "b"], steps=steps, y_words=inp["y"][:2],
                             negative_words=inp["zero_y"], noise=inp["noise3"][:2],
                             data_parallel=True),
                         lambda: pipe.generate("x", steps=steps, y_words=inp["y"][:1],
                                               negative_words=inp["zero_y"],
                                               noise=inp["noise1"])):
                try:
                    call()
                    errors.append(None)
                except RuntimeError as e:
                    errors.append(str(e))
            out.append(errors)
            continue
        if job["kind"] == "generate":
            r = pipe.generate("x", steps=steps, guide_scale=9.0, use_gs_refine=job["refine"],
                              y_words=inp["y"][:1], negative_words=inp["zero_y"],
                              frame_parallel=True, noise=inp[job.get("noise", "noise1")])
        elif job["kind"] == "i2v":
            mesh = pipe._serving_mesh()
            cam, *gs = pipe._get_cameras(15.0, 2.0)
            gs = tuple(gs) if job["refine"] else None

            def sample(nz, cm):
                return pipe.sample_i2v(nz, inp["y"][:1], inp["zero_y"], cm, inp["local"],
                                       inp["img"], inp["zero_img"], steps, 6.0, gs=gs,
                                       view_mesh=mesh if gs else None)

            lat = (sample(inp["noise1"], cam) if mesh is None
                   else pipe._frame_parallel(mesh, inp["noise1"], cam, sample)[0])
            r = {"latents": lat.numpy()}
        else:
            r = pipe.generate_batch(["a", "b", "c"], steps=steps, guide_scale=9.0,
                                    use_gs_refine=job["refine"], y_words=inp["y"],
                                    negative_words=inp["zero_y"], noise=inp["noise3"],
                                    data_parallel=job["dp"], force_batched=job["forced"])
        out.append(r["latents"])
    return out


# ------------------------------------------------------------ placements


def mesh_checks(rank, n, batch, x, hw_tokens):
    """``shard_batch``'s rows, the frames ↔ tokens all-to-all and the sharded
    GroupNorm on this rank, against the whole tensors every rank holds."""
    from videomv_tpu_torch.parallel import (
        FrameShard,
        frame_parallel_mesh,
        make_mesh,
        replicate,
        shard_batch,
        shard_on_axis,
    )
    from videomv_tpu_torch.parallel.collectives import group_norm, token_splits

    out = {"rows": {k: v.numpy() for k, v in shard_batch(make_mesh(n), _tensors(batch)).items()}}
    try:
        shard_batch(make_mesh(n), {"x": torch.zeros(n + 1, 2)})
    except ValueError as e:
        out["indivisible"] = str(e)
    w = torch.full((3,), float(rank))
    replicate([w])
    out["replicated"] = w.numpy()

    full_x = torch.from_numpy(x)
    mesh = frame_parallel_mesh(full_x.shape[2])
    shard = FrameShard.of(mesh, full_x.shape[2])
    local = shard_on_axis(mesh, full_x, 2)
    tokens = shard.frames_to_tokens(local)
    b, c, f, hh, ww = full_x.shape
    start = sum(token_splits(hh * ww, n)[:rank])
    want = full_x.reshape(b, c, f, hh * ww)[..., start:start + tokens.shape[-1]]
    out["tokens_exact"] = bool(torch.equal(tokens, want))
    out["round_trip_exact"] = bool(torch.equal(shard.tokens_to_frames(tokens, (hh, ww)), local))
    norm = torch.nn.GroupNorm(2, c, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(torch.linspace(0.5, 1.5, c))
        norm.bias.copy_(torch.linspace(-0.2, 0.2, c))
        got = shard.tokens_to_frames(group_norm(norm, tokens, shard.group), (hh, ww))
        out["group_norm_err"] = float((got - shard_on_axis(mesh, norm(full_x), 2)).abs().max())
    out["token_counts"] = [int(t) for t in token_splits(hh * ww, n)]
    return out


def sleeper(rank, n, seconds):
    import time

    if rank == n - 1:
        time.sleep(seconds)
    return rank


def failer(rank, n):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return rank


def inference_cli(rank, n, log_dir):
    """The inference CLI as ``torchrun`` starts it, with ``frame_parallel``
    on: configs/t2v_infer_tiny.yaml with a small text tower (UNet context
    64). Returns what it reports written and what the rank finds on disk."""
    import videomv_tpu_torch.inference.pipeline as tpipeline
    from videomv_tpu_torch.inference.__main__ import main
    from videomv_tpu_torch.models import CLIPTextTower

    os.chdir(REPO)
    tpipeline.CLIPTextTower = functools.partial(CLIPTextTower, width=64, heads=2, layers=3)
    written = main(["--cfg", "configs/t2v_infer_tiny.yaml", "--debug", "--device", "cpu",
                    "sampling_dtype", "float32", "log_dir", log_dir, "UNet.context_dim", "64",
                    "ddim_timesteps", "3", "frame_parallel", "True"])
    return {"written": written, "exists": [os.path.exists(p) for p in written]}


# ------------------------------------------------------- temporal variants


def variant_forwards(rank, n, jobs, inputs):
    """Each job's tiny UNet forward on this rank's frames: ``jobs`` are
    dicts of the UNet's kwargs (``kw``), its state dict (``sd``), the
    ``tp`` degree (the mesh is ``('sp', 'tp')`` with sp = n / tp) and
    whether the rotary masks go in (``masks``). Returns every frame's output
    (gathered over sp) and, for tp > 1, the placement ``tp_shardings``
    gave the UNet."""
    from videomv_tpu_torch.models import UNetSD_T2VBase
    from videomv_tpu_torch.parallel import (
        FrameShard,
        frame_sharded,
        place_params_tp,
        shard_on_axis,
        tensor_parallel_mesh,
        tp_shardings,
    )

    inp = _tensors(inputs)
    out = []
    for job in jobs:
        unet = UNetSD_T2VBase(**job["kw"])
        unet.load_state_dict(_tensors(job["sd"]))
        unet.eval()
        tp = int(job.get("tp", 1))
        mesh = tensor_parallel_mesh(num_heads=unet.num_heads, tp=tp, sp=n // tp)
        placement = None
        if tp > 1:
            placement = tp_shardings(unet, tp, head_dim=unet.head_dim)
            place_params_tp(mesh, unet, head_dim=unet.head_dim)
        shard = FrameShard.of(mesh, inp["x"].shape[2], axis="sp")
        masks = (dict(video_mask=inp["vm"], focus_present_mask=inp["fpm"])
                 if job.get("masks") else {})
        with torch.no_grad(), frame_sharded(shard):
            local = unet(shard_on_axis(mesh, inp["x"], 2), inp["t"], y=inp["y"],
                         camera_data=shard_on_axis(mesh, inp["cam"], 1), **masks)
        out.append({"out": shard.gather(local, 2).numpy(), "placement": placement})
    return out


# ------------------------------------------------------ Adafactor, viz (FSDP)


def adafactor_shards(rank, n, params, grads, kw):
    """``optimizer: adafactor`` over FSDP shards of ``params`` (name →
    array; each its own unit, every one sharded on axis 0, uneven where its
    rows do not divide): ``len(grads)`` steps from the given whole gradients,
    then the parameters and the gathered state, and whether a fresh sharded
    optimizer loaded from that state holds this rank's state bit for bit."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from videomv_tpu_torch.parallel import apply_fsdp, make_mesh
    from videomv_tpu_torch.training.optim import build_optimizer

    mesh = make_mesh(n)

    def sharded_module():
        units = torch.nn.ModuleDict()
        for name, value in params.items():
            unit = torch.nn.Module()
            unit.w = torch.nn.Parameter(torch.from_numpy(value.copy()))
            units[name] = unit
        apply_fsdp(list(units.values()), mesh, min_size=1)
        return units

    units = sharded_module()
    named = [(name, unit.w) for name, unit in units.items()]
    opt = build_optimizer(named, **kw)
    for g in grads:
        for name, p in named:
            p.grad = distribute_tensor(torch.from_numpy(g[name].copy()), p.device_mesh,
                                       p.placements)
        opt.step()
    out = {"params": {name: full(p) for name, p in named},
           "sharded": sum(isinstance(p, DTensor) for _, p in named)}
    state = opt.full_state_dict()
    out["state"] = {k: ([t.numpy().copy() for t in v] if isinstance(v, list) else v)
                    for k, v in state.items()}
    again = build_optimizer([(name, unit.w) for name, unit in sharded_module().items()], **kw)
    again.load_full_state_dict(state)
    mine = opt.state_dict()
    out["restored_equal"] = again.count == opt.count and all(
        torch.equal(a, b) for key in ("v_row", "v_col", "v")
        for a, b in zip(again.state_dict()[key], mine[key]))
    return out


def fsdp_viz(rank, n, log_dir, prompts):
    """The visualisation of configs/t2v_train_tiny.yaml (EMA on, 2 DDIM
    steps, 4 views), replicated and under ``param_sharding: fsdp``, from the
    same seeded weights: the frames each one writes (rank 0 writes; under
    FSDP every rank samples), whether the EMA weights are copied into the
    shards for it and back, and one step of the loop with the hook on."""
    import videomv_tpu_torch.training.hooks as hooks
    from videomv_tpu_torch.config import load_config

    engine = _small_towers()
    written = []
    save = hooks.save_video_grid

    def capture(path, videos, captions):
        written.append([np.asarray(v).copy() for v in videos])
        return save(path, videos, captions)

    hooks.save_video_grid = capture
    out = {}
    for mode in ("replicated", "fsdp"):
        cfg = load_config("configs/t2v_train_tiny.yaml", opts=[
            "UNet.context_dim", "64", "save_ckp_interval", "0", "training_dtype", "float32",
            "log_dir", os.path.join(log_dir, mode), "param_sharding", mode, "viz_interval", "1",
            "validation_prompts", prompts, "ddim_timesteps", "2", "max_frames", "4"])
        tr = engine.T2VTrainer(cfg, device="cpu").init(zero_init=False)
        written.clear()
        path = None
        if tr._viz_here:
            with tr._ema_weights():
                path = tr.make_viz_hook(cfg.log_dir)(1, tr.unet)
        out[mode] = {"path": path, "frames": written[0] if written else None,
                     "sampled": tr._viz_here}
    # under FSDP: the EMA weights (here half the trained ones) in the
    # shards within the context, the trained ones after it
    trained = {k: full(p) for k, p in tr.unet.named_parameters()}
    with torch.no_grad():
        torch._foreach_mul_(tr.state.ema, 0.5)
    with tr._ema_weights():
        inside = {k: full(p) for k, p in tr.unet.named_parameters()}
    out["ema_swapped"] = all(np.array_equal(inside[k], np.float32(0.5) * v)
                             for k, v in trained.items())
    out["ema_restored"] = all(np.array_equal(full(p), trained[k])
                              for k, p in tr.unet.named_parameters())
    tr.train(num_steps=1, batch_size=2)
    out["loop_wrote"] = sorted(os.listdir(os.path.join(cfg.log_dir, "viz"))) if rank == 0 else None
    return out
