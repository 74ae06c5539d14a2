"""Milliseconds of one plain DDIM step on the device: the mean of the
program's own ``sampler.step`` spans of the steps that do not refine (the CFG
forward, the guidance mix and the update, and any wait of the stream between
forwards) in the first request it recorded, the first profiled pass
(``mvbench/program_spans.py``)."""

from mvbench.program_spans import dev_ms, mean


def read(r):
    return mean(dev_ms(lambda s: s["name"] == "sampler.step" and not s["attrs"].get("refine")))
