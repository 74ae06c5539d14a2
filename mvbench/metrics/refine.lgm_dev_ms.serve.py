"""Milliseconds of the refine's LGM reconstruction on the device (4 views and
their rays to the Gaussians): the mean of the program's own ``refine.lgm``
spans over the refines of the first request it recorded, the first profiled
pass (``mvbench/program_spans.py``)."""

from mvbench.program_spans import dev_ms, mean, named


def read(r):
    return mean(dev_ms(named("refine.lgm")))
