"""The GEGLU feed-forwards' share of their roofline in one profiled request, %.

The work is every GEGLU feed-forward of the request's denoiser forwards
with width C <= 640, at least 4096 tokens and an inner width that 256
divides (the spatial and temporal transformers of the 32² and 16² levels),
counted from the reference's structure at the cell's shapes; its bound is
the sum of each call's ``ffn_bound_ms``. The time is the device time of the
kernels named below in the profiled request."""

from mvbench.roofline import ffn_bound_ms

KERNELS = ("geglu_ffn_kernel", "geglu_ffn_wgmma_kernel")


def read(r):
    bound = sum(ffn_bound_ms(t, c, inner) for kind, (t, c, inner) in
                ((x[0], x[1]) for x in r["work"]["calls"] if x[0] == "ffn")
                if c <= 640 and t >= 4096 and inner % 256 == 0)
    ms = sum(v for name, v in r["profile"]["kernel_ms"].items() if any(k in name for k in KERNELS))
    return 100.0 * bound / ms if bound > 0 and ms > 0 else None
