"""Training-step machinery and multi-device placements of the port: one
process per device over ``torch.distributed`` (``mesh``), the data-parallel
and FSDP train step (``train_step``), frame-parallel serving (``infer``),
tensor-parallel attention (``tp``), their collectives (``collectives``) and
a multi-rank dry run on the CPU (``dryrun``)."""

from .infer import (
    FrameShard,
    current_frame_shard,
    frame_parallel_mesh,
    frame_sharded,
    replicate_params,
    shard_on_axis,
)
from .mesh import (
    apply_fsdp,
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
    spawn,
    world_size,
)
from .tp import place_params_tp, tensor_parallel_mesh, tp_shardings
from .train_step import (
    TrainDraws,
    TrainState,
    build_train_step,
    draw_train_randoms,
    make_i2v_apply,
    make_t2v_apply,
)

__all__ = ["FrameShard", "TrainDraws", "TrainState", "apply_fsdp", "build_train_step",
           "current_frame_shard", "draw_train_randoms", "frame_parallel_mesh", "frame_sharded",
           "init_distributed", "make_i2v_apply", "make_mesh", "make_t2v_apply",
           "place_params_tp", "replicate", "replicate_params", "shard_batch",
           "shard_on_axis", "spawn", "tensor_parallel_mesh", "tp_shardings", "world_size"]
