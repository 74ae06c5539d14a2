"""A request's model FLOPs over its time at the H100's dense bf16 peak, %.

The FLOPs are counted by ``FlopCounterMode`` over the plain reference on
the meta device at the cell's shapes (``reference/counting.py``: every
product and convolution of the encodes, the 50 denoiser forwards, the
refine's models and the decode), so they are the same whatever implements
them. The time is the traced window's seconds per request (spans on,
profiler off)."""

from mvbench.roofline import PEAK_BF16_FLOPS


def read(r):
    flops, sec = r["work"]["flops"], r["request_s"]
    return 100.0 * flops / (sec * PEAK_BF16_FLOPS) if flops > 0 and sec > 0 else None
