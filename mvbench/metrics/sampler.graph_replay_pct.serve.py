"""Share of the denoiser's forwards that the program served by replaying a
CUDA graph, in %: ``100 · unet.graph_replays / unet.forwards`` over the
counter deltas of the first request the program recorded, the first
profiled pass (``mvbench/program_spans.py``). A program that counts no
forwards gives nothing to read (``None``)."""

from mvbench.program_spans import first_request


def read(r):
    rec = first_request()
    forwards = rec["counts"].get("unet.forwards", 0) if rec is not None else 0
    if not forwards:
        return None
    return 100.0 * rec["counts"].get("unet.graph_replays", 0) / forwards
