"""Milliseconds a request spends in its conditioning encodes (the text
tower; for I2V also the visual tower and the reference-frame VAE encode),
from spans fenced by ``torch.cuda.synchronize()`` around the pipeline's
encode methods, summed per request and averaged over the traced window."""


def read(r):
    ms = r["spans"].get("encode")
    return sum(ms) / r["requests"] if ms else None
