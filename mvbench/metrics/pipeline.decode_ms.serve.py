"""Milliseconds of a request's final decode (the VAE over every view, the
uint8 conversion on the device): the mean of fenced spans around the
pipeline's decode over the traced window. The copy of the views to the host
follows it in the entry and is not in this span."""


def read(r):
    ms = r["spans"].get("decode")
    return sum(ms) / len(ms) if ms else None
