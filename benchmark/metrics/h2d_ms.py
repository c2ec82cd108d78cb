"""Copies: device milliseconds of Memcpy HtoD a group, in the traced
stretch (torch.profiler)."""

from benchmark import devtrace


def read(ctx):
    return devtrace.op_ms(ctx.trace, ("Memcpy HtoD",))
