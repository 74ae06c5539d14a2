"""Milliseconds of the refine's render of every view on the device (projection,
binning, the splat composite): the mean of the program's own ``refine.render``
spans over the refines of the first request it recorded, the first profiled
pass (``mvbench/program_spans.py``)."""

from mvbench.program_spans import dev_ms, mean, named


def read(r):
    return mean(dev_ms(named("refine.render")))
