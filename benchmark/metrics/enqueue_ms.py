"""Dispatch: host milliseconds a group spends inside the entry call (the
uploads queued, `_seed_resolved`, the download queued, the event), the mean
over every group of the timed window, on the benchmark's own spans.  The
entry is the benchmark's copy of `TorchKartMapper._dispatch_seed_async`
less its packing and its fresh pinned buffers: a change to the mapper's
dispatch reaches this only through `pack_reads_2bit` and `_seed_resolved`."""


def read(ctx):
    if not ctx.enqueue_s:
        return None
    return 1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s)
