"""Device: 100 less the share of the traced stretch that the union of the
card's kernel, copy and set intervals covers, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
