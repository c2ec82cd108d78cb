"""Expand, resolve, pack: the least time a group's resolver work needs
(benchmark/yardstick.py) over its device time a group (the kernels that
`resolve_ms` reads), in %, against the H100's published peaks."""

from benchmark import devtrace, yardstick
from benchmark.metrics.resolve_ms import KERNELS


def read(ctx):
    ms, w = devtrace.op_ms(ctx.trace, KERNELS), ctx.work
    if not ms or w is None:
        return None
    return 100.0 * yardstick.bound_ms(w["resolve_bytes"], w["resolve_ops"])[0] / ms
