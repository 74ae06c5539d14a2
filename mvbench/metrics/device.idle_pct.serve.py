"""The share of one profiled request's window in which no device operation
runs, %, from the ``torch.profiler`` timeline (merged kernel, copy and set
intervals against the request's host span)."""


def read(r):
    p = r["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"]) if p["window_s"] > 0 and p["busy_s"] > 0 \
        else None
