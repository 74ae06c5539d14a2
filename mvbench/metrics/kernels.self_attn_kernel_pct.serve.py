"""The share of a request's long self-attention that kernel 1 served, in %
of its FLOPs: over the self-attention calls of at least 256 tokens at head
size 64 or 128, 100 × the FLOPs (4·B·H·S²·D) of those that launched the
kernel (``launch.flash_attention``, by (B, S, H, D)) over those of all of
them (the launches and the plain path's ``attn.plain``, by (B, S_q, S_kv, H,
D)), from the by-shape counts of the first request the program recorded,
the first profiled pass (``mvbench/program_spans.py``). A call the gate
sends back to the plain path lowers it. A program whose record has no
by-shape counts, or that counts no such call, gives nothing to read."""

from mvbench.program_spans import first_request


def _flops(b, s, h, d):
    return 4.0 * b * h * s * s * d


def read(r):
    rec = first_request()
    by = rec.get("by_shape") if rec is not None else None
    if not by:
        return None
    kernel = sum(n * _flops(b, s, h, d) for (b, s, h, d), n in
                 by.get("launch.flash_attention", {}).items() if s >= 256 and d in (64, 128))
    plain = sum(n * _flops(b, sq, h, d) for (b, sq, sk, h, d), n in
                by.get("attn.plain", {}).items() if sq == sk and sq >= 256 and d in (64, 128))
    return 100.0 * kernel / (kernel + plain) if kernel + plain > 0 else None
