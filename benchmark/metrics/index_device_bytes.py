"""Index set-up: bytes of the index tensors the mapper holds on its device
(the SA, the text words and BWT, the occurrence checkpoints, the funnel's
tables; a storage two names share counted once), as the program's
`index_device_bytes` counter last set it (`kart_tpu_torch.utils.trace`'s
`TIMERS.counters`).  None where the program keeps no such counter."""

COUNTER = "index_device_bytes"


def read(ctx):
    from kart_tpu_torch.utils import trace

    counters = getattr(getattr(trace, "TIMERS", None), "counters", None)
    return counters.get(COUNTER) if counters else None
