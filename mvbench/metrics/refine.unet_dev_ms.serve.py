"""Milliseconds of the refine's denoiser forward (the refined rows) and its x0
estimate on the device: the mean of the program's own ``refine.unet`` spans
over the refines of the first request it recorded, the first profiled pass
(``mvbench/program_spans.py``)."""

from mvbench.program_spans import dev_ms, mean, named


def read(r):
    return mean(dev_ms(named("refine.unet")))
