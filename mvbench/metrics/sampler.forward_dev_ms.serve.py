"""Milliseconds of one CFG denoiser forward ([cond; uncond] rows) on the
device: the mean of the program's own ``sampler.forward`` spans (one a plain
DDIM step; the refine's forwards are not among them) in the first request it
recorded, the first profiled pass (``mvbench/program_spans.py``). The
program-side counterpart of ``sampler.unet_fwd_ms.serve``."""

from mvbench.program_spans import dev_ms, mean, named


def read(r):
    return mean(dev_ms(named("sampler.forward")))
