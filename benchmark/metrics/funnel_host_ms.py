"""Funnel: host milliseconds of the program's `kart.funnel` span, the
funnel's wrapper (`ops.pack.kmer_seed_scan_packed`: its checks, allocations
and queued kernels).

The mean over the spans that the program's recorder
(`kart_tpu_torch.utils.trace.TIMERS`) holds, which records while the traced
stretch's profiler session is active; None where it holds none, or where
the program has no such recorder."""

SPAN = "kart.funnel"


def read(ctx):
    from kart_tpu_torch.utils import trace

    timers = getattr(trace, "TIMERS", None)
    n = timers.n.get(SPAN, 0) if timers is not None else 0
    return 1e3 * timers.acc[SPAN] / n if n else None
