"""Funnel: the least time a group's funnel work needs (benchmark/
yardstick.py, from the checked groups' reads and the table, text and
suffix-array sectors they touch) over its device time a group (the
kernels that `funnel_ms` reads), in %, against the H100's published
peaks."""

from benchmark import devtrace, yardstick
from benchmark.metrics.funnel_ms import KERNELS


def read(ctx):
    ms, w = devtrace.op_ms(ctx.trace, KERNELS), ctx.work
    if not ms or w is None:
        return None
    return 100.0 * yardstick.bound_ms(w["funnel_bytes"], w["funnel_ops"])[0] / ms
