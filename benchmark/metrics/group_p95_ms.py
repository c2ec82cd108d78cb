"""Dispatch: the 95th percentile, over every group of the timed window, of
the milliseconds from its dispatch until its stream is in host memory,
through the benchmark's entry (see `enqueue_ms`)."""

import numpy as np


def read(ctx):
    if not ctx.latency_s:
        return None
    return 1e3 * float(np.percentile(ctx.latency_s, 95))
