from .checkpoints import (
    init_models,
    init_weights,
    load_matched,
    load_torch_checkpoint,
    state_dict_from_flax,
)

__all__ = ["init_models", "init_weights", "load_matched", "load_torch_checkpoint",
           "state_dict_from_flax"]
