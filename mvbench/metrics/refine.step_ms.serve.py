"""Milliseconds of one Gaussian-splat refine call (denoiser forward, decode
of the refine views, LGM, render, encode of every view): the mean of fenced
spans around the refine function the pipeline builds, over the traced
window."""


def read(r):
    ms = r["spans"].get("refine")
    return sum(ms) / len(ms) if ms else None
