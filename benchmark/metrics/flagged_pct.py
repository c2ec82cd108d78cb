"""Funnel: the share of the timed window's reads that came back flagged
(the funnel's hit budget or the stream's occurrence budget), with no seeds,
in %: read from the flags of the program's own streams."""


def read(ctx):
    if not ctx.attempted:
        return None
    return 100.0 * ctx.failed / ctx.attempted
