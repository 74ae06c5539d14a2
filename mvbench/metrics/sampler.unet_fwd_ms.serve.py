"""Milliseconds of one CFG denoiser forward ([cond; uncond] rows): the mean
over the traced window of the time between CUDA events recorded by a
forward pre-hook and a forward hook on the pipeline's UNet. The refine's
cond-row forwards are not counted."""


def read(r):
    ms = r["cfg_forward_ms"]
    return sum(ms) / len(ms) if ms else None
