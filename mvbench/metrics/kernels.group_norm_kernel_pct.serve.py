"""The share of a request's GroupNorm work that kernel 6 served, in % of the
elements normalised: 100 × the elements (N·C·F·H·W) of the calls that
launched the kernel (``launch.group_norm``, by (N, C, F·H·W, silu)) over
those of every counted call (the launches and the bf16 calls a gate sent to
the plain path, ``gn.plain``, by the same key), from the by-shape counts of
the first request the program recorded, the first profiled pass
(``mvbench/program_spans.py``). A program whose record has no by-shape
counts, or that counts no such call, gives nothing to read."""

from mvbench.program_spans import first_request


def read(r):
    rec = first_request()
    by = rec.get("by_shape") if rec is not None else None
    if not by:
        return None
    kernel = sum(cnt * n * c * s for (n, c, s, _), cnt in by.get("launch.group_norm", {}).items())
    plain = sum(cnt * n * c * s for (n, c, s, _), cnt in by.get("gn.plain", {}).items())
    return 100.0 * kernel / (kernel + plain) if kernel + plain > 0 else None
