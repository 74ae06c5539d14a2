"""A request's model work as its family counts it (``work``), MFLOP."""


def read(r):
    flops = r["work"]["flops"]
    return flops / 1e6 if flops > 0 else None
