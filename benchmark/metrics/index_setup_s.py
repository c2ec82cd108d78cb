"""Index set-up: seconds of the program's three `kart.index.*` set-up spans
in the run, summed: `kart.index.load` (`load_index`, the index files),
`kart.index.tables` (`build_tables`: the `.kmt` sidecar's load, or its
build) and `kart.index.upload` (the mapper's device copies of the FM
index, the funnel's tables and the full SA).  The program records them
whatever its recorder's switch (`kart_tpu_torch.utils.trace.setup_span`),
since set-up precedes any profiler session.  Part of `setup_s`.

None where the recorder holds none of them, or where the program has no
such recorder."""

SPANS = ("kart.index.load", "kart.index.tables", "kart.index.upload")


def read(ctx):
    from kart_tpu_torch.utils import trace

    timers = getattr(trace, "TIMERS", None)
    if timers is None or not any(timers.n.get(s, 0) for s in SPANS):
        return None
    return sum(timers.acc.get(s, 0.0) for s in SPANS)
