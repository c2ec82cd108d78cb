"""Ordered SAM output merging.

The reference serializes all SAM emission behind one OutputLock so records
appear in chunk-completion order (reference: src/Mapping.cpp:601-622).  Our
equivalent for parallel producers keeps the stronger guarantee we already
give on one host — output in (library, chunk index) order, records in
read order within a chunk — without serializing the mapping itself:
producers hand finished chunks to an OrderedChunkWriter which buffers
out-of-order arrivals and flushes the contiguous prefix.

For multi-host data parallelism each host maps a deterministic slice of
the input (parallel.distributed.shard_libraries / fastq_byte_ranges) and
writes its own shard file; merge_sam_shards concatenates them in shard
order, keeping exactly one header — the result equals a single-host run
over the concatenated input.  Counterpart of kart_tpu/parallel/merge.py,
copied unchanged.
"""

from __future__ import annotations

import heapq
import threading


class OrderedChunkWriter:
    """Reorders (seq_no, text) blocks onto a writer in seq_no order.

    Thread-safe: any producer may push any sequence number once; blocks
    are written the moment the prefix is contiguous.  `close()` asserts
    nothing is still buffered (a missing chunk is a bug, not a timeout)."""

    def __init__(self, writer):
        self._writer = writer
        self._next = 0
        self._heap: list[tuple[int, str]] = []
        self._lock = threading.Lock()

    def push(self, seq_no: int, text: str) -> None:
        with self._lock:
            heapq.heappush(self._heap, (seq_no, text))
            while self._heap and self._heap[0][0] == self._next:
                _, t = heapq.heappop(self._heap)
                self._writer(t)
                self._next += 1

    def close(self) -> None:
        with self._lock:
            if self._heap:
                missing = self._next
                raise RuntimeError(f"ordered writer closed with chunk {missing} missing")


def merge_sam_shards(shard_paths, out_path) -> None:
    """Concatenate per-host SAM shard files in shard order, keeping the
    header lines (@...) only from the first shard."""
    with open(out_path, "wb") as out:
        for i, p in enumerate(shard_paths):
            with open(p, "rb") as f:
                for line in f:
                    if i > 0 and line.startswith(b"@"):
                        continue
                    out.write(line)
