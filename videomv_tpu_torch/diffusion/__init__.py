from .gaussian import DiffusionParams, GaussianDiffusion
from .samplers import (
    ddim_reverse_sample_loop,
    ddim_sample_loop,
    ddim_timestep_seq,
    ddpm_sample_loop,
    plms_sample_loop,
)
from .schedules import beta_schedule, rescale_zero_terminal_snr

__all__ = [
    "DiffusionParams",
    "GaussianDiffusion",
    "beta_schedule",
    "ddim_reverse_sample_loop",
    "ddim_sample_loop",
    "ddim_timestep_seq",
    "ddpm_sample_loop",
    "plms_sample_loop",
    "rescale_zero_terminal_snr",
]
