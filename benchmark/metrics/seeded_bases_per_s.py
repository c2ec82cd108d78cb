"""End to end: read bases whose exact seed stream is back in host memory,
over the whole timed window (all groups dispatched in it, until the last is
home); a flagged read's bases do not count."""


def read(ctx):
    return ctx.seeded_bases / ctx.window_s if ctx.window_s > 0 else None
