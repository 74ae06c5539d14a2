"""Training-step machinery of the port (one device; the multi-device
placements of the JAX package's ``parallel`` are not ported yet)."""

from .train_step import TrainDraws, TrainState, build_train_step, draw_train_randoms, make_t2v_apply

__all__ = ["TrainDraws", "TrainState", "build_train_step", "draw_train_randoms", "make_t2v_apply"]
