"""Milliseconds of a request's conditioning encodes on the device (the text
tower; for I2V also the visual tower and the reference-frame VAE encode):
the sum of the program's own ``pipeline.encode.*`` spans in the first request
it recorded, the first profiled pass (``mvbench/program_spans.py``). The
program-side counterpart of ``pipeline.encode_ms.serve``."""

from mvbench.program_spans import dev_ms


def read(r):
    ms = dev_ms(lambda s: s["name"].startswith("pipeline.encode."))
    return sum(ms) if ms else None
