"""Self-attention's share of its roofline in one profiled request, %.

The work is every unmasked self-attention of the request with at least 256
tokens and a head size of 64 or 128 (the UNet's spatial self-attention at
32² and 16², the LGM's at its two deepest levels), counted from the
reference's structure at the cell's shapes; its bound is the sum of each
call's ``attn_bound_ms``. The time is the device time of the kernels named
below in the profiled request."""

from mvbench.roofline import attn_bound_ms

KERNELS = ("flash_attn_fwd_kernel", "flash_attn_wgmma_kernel")


def read(r):
    bound = sum(attn_bound_ms(b, s, h, d) for kind, (b, s, s_kv, h, d), masked
                in ((c[0], c[1], c[2]) for c in r["work"]["calls"] if c[0] == "attn")
                if not masked and s == s_kv and s >= 256 and d in (64, 128))
    ms = sum(v for name, v in r["profile"]["kernel_ms"].items() if any(k in name for k in KERNELS))
    return 100.0 * bound / ms if bound > 0 and ms > 0 else None
