"""Milliseconds of a request's final decode on the device (the VAE over every
view, the uint8 conversion): the program's own ``pipeline.decode`` span in the
first request it recorded, the first profiled pass
(``mvbench/program_spans.py``). The program-side counterpart of
``pipeline.decode_ms.serve``; the copy to the host is the span
``pipeline.to_host``, not this one."""

from mvbench.program_spans import dev_ms, named


def read(r):
    ms = dev_ms(named("pipeline.decode"))
    return sum(ms) if ms else None
