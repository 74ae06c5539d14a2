"""A multi-rank dry run of the port's placements on the CPU.

Counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``:
its tiny UNet in four flavours over ``n`` gloo ranks on the CPU, one process
each (``parallel.mesh.spawn``):

1. the replicated data-parallel train step (AdamW 3e-5, weight decay 1e-4,
   EMA) on a global batch of ``n`` samples, one a rank;
2. the same step with the UNet's blocks FSDP-sharded (``apply_fsdp`` with
   ``min_size`` 1024): its loss must be the replicated step's (|Δ| < 2e-4)
   at each of two steps, the second after an update;
3. the frame-parallel forward of one sample (frames over the largest
   ``('sp',)`` mesh that divides them) against the same forward on one rank
   (max |Δ| < 2e-4);
4. the composed ``('sp', 'tp')`` forward (frames over sp, attention heads
   over tp = 2) against it too (max |Δ| < 2e-4).

The UNet's weights are seeded with its zero-initialised layers drawn too, so
a forward is not trivially 0. Prints the JAX version's summary line.

    python -m videomv_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Dict

import numpy as np
import torch

__all__ = ["dryrun_multichip"]

TOL = 2e-4
UNET = dict(in_dim=4, dim=64, y_dim=32, context_dim=32, out_dim=4, dim_mult=(1, 2),
            num_heads=2, head_dim=16, num_res_blocks=1, attn_scales=(1.0,), dropout=0.0,
            use_camera_condition=True)
DIFFUSION = dict(schedule="linear_sd",
                 schedule_param=dict(num_timesteps=1000, init_beta=0.00085, last_beta=0.0120),
                 mean_type="eps", var_type="fixed_small")
FRAMES, HW, TOKENS = 4, 16, 5


def _unet():
    from ..models import UNetSD_T2VBase
    from ..training.checkpoints import init_weights

    with torch.device("meta"):
        unet = UNetSD_T2VBase(**UNET)
    return init_weights(unet, seed=0, zero_init=False, device="cpu")


def _steps(n: int, fsdp: bool, batch: Dict[str, torch.Tensor], steps: int = 2):
    """``steps`` data-parallel train steps; returns their losses."""
    from ..diffusion import GaussianDiffusion
    from ..training.optim import AdamW
    from .mesh import apply_fsdp, make_mesh, shard_batch
    from .train_step import TrainState, build_train_step, make_t2v_apply

    mesh = make_mesh(n)
    unet = _unet().train()
    if fsdp:
        apply_fsdp(unet.fsdp_units(), mesh, min_size=1024)
    opt = AdamW(unet.named_parameters(), lambda count: 3e-5, weight_decay=1e-4)
    from ..training.optim import local_tensor

    state = TrainState(0, unet, opt, [local_tensor(p.detach()).clone()
                                      for p in unet.parameters()])
    step = build_train_step(make_t2v_apply(unet), GaussianDiffusion(**DIFFUSION), mesh=mesh)
    gen = torch.Generator().manual_seed(1)
    local = shard_batch(mesh, batch)
    return [float(step(state, local, generator=gen)) for _ in range(steps)]


def _rank(r: int, n: int) -> dict:
    from .infer import FrameShard, frame_parallel_mesh, frame_sharded, shard_on_axis
    from .tp import place_params_tp, tensor_parallel_mesh

    rs = np.random.default_rng(3)
    batch = {"latents": torch.from_numpy((rs.standard_normal((n, 4, FRAMES, HW, HW)) * 0.5)
                                         .astype(np.float32)),
             "y_words": torch.from_numpy(rs.standard_normal((n, TOKENS, 32)).astype(np.float32)),
             "camera_data": torch.from_numpy(rs.standard_normal((n, FRAMES, 16))
                                             .astype(np.float32))}
    out = {"loss": _steps(n, False, batch), "fsdp": _steps(n, True, batch)}

    x = torch.from_numpy(rs.standard_normal((1, 4, FRAMES, HW, HW)).astype(np.float32))
    t = torch.zeros((1,), dtype=torch.long)
    y, cam = batch["y_words"][:1], batch["camera_data"][:1]
    unet = _unet().eval()
    with torch.no_grad():
        ref = unet(x, t, y=y, camera_data=cam)
        sp = frame_parallel_mesh(FRAMES, n)
        if sp is not None and sp.get_coordinate() is not None:
            shard = FrameShard.of(sp, FRAMES)
            with frame_sharded(shard):
                got = unet(shard_on_axis(sp, x, 2), t, y=y, camera_data=shard_on_axis(sp, cam, 1))
            out["sp"] = (sp.size(), float((shard.gather(got, 2) - ref).abs().max()))
        tp_n = 2
        sp_n = max((d for d in range(1, n // tp_n + 1) if FRAMES % d == 0), default=1)
        if sp_n > 1:
            mesh = tensor_parallel_mesh(num_heads=UNET["num_heads"], tp=tp_n, sp=sp_n)
            if mesh.get_coordinate() is not None:
                place_params_tp(mesh, unet, head_dim=UNET["head_dim"])
                shard = FrameShard.of(mesh, FRAMES, axis="sp")
                with frame_sharded(shard):
                    got = unet(shard_on_axis(mesh, x, 2), t, y=y,
                               camera_data=shard_on_axis(mesh, cam, 1))
                out["sptp"] = (sp_n, tp_n, float((shard.gather(got, 2) - ref).abs().max()))
    return out


def dryrun_multichip(n_devices: int, deadline_s: float = 600.0) -> dict:
    """Run the four flavours on ``n_devices`` gloo ranks on the CPU, check
    them, print the summary line and return rank 0's results."""
    from .mesh import spawn

    with tempfile.TemporaryDirectory() as tmp:
        res = spawn(_rank, n_devices, init_file=os.path.join(tmp, "rendezvous"),
                    deadline_s=deadline_s)[0]
    loss, fsdp = res["loss"], res["fsdp"]
    if not all(np.isfinite(loss + fsdp)):
        raise AssertionError(f"non-finite loss: replicated {loss}, fsdp {fsdp}")
    worst = max(abs(a - b) for a, b in zip(loss, fsdp))
    if worst >= TOL:
        raise AssertionError(f"fsdp/replicated loss mismatch: {fsdp} vs {loss}")
    if "sp" not in res:
        raise AssertionError(f"no sp mesh for {FRAMES} frames over {n_devices} devices")
    sp_n, err = res["sp"]
    if err >= TOL:
        raise AssertionError(f"frame-parallel forward mismatch: max|Δ|={err}")
    tail = ""
    if "sptp" in res:
        s, t, tp_err = res["sptp"]
        if tp_err >= TOL:
            raise AssertionError(f"sp×tp forward mismatch: max|Δ|={tp_err}")
        tail = f", sp{s}×tp{t} fwd Δ={tp_err:.1e}"
    print(f"dryrun_multichip({n_devices}): ok, loss={loss[0]:.4f} (fsdp {fsdp[0]:.4f}, "
          f"sp fwd Δ={err:.1e} on {sp_n} devices{tail})", flush=True)
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="multi-rank dry run of the port on the CPU")
    p.add_argument("n_devices", type=int, nargs="?", default=4)
    dryrun_multichip(p.parse_args(argv).n_devices)


if __name__ == "__main__":
    main()
