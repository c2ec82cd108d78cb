"""Expand, resolve, pack: device milliseconds a group of resolve_pack's
kernels (`kernels.resolve_pack`, csrc/resolve_pack.cu: totals, emit and the
rest, and the sets queued before them), in the traced stretch."""

from benchmark import devtrace

KERNELS = ("totals_kernel", "rows_kernel", "flag_kernel", "emit_kernel", "sa_walk_kernel")


def read(ctx):
    return devtrace.op_ms(ctx.trace, KERNELS)
