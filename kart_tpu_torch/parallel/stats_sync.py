"""Exact cross-host insert-size statistics: speculative chunk execution
with an ordered stat relay.

The reference's online insert-size estimate is a sequential recurrence:
chunk k's pairing distance is EstDistance(stats after chunks 0..k-1)
(reference: src/Mapping.cpp:533-540), so naive data parallelism diverges
from the single-host stream as soon as 1000 pairs have been seen.  The
distributed design here keeps hosts parallel anyway:

  * chunk k's SAM output and stat delta depend on the prefix stats ONLY
    through the integer estimate `est` (computed once per chunk — see
    native process_chunk_impl);
  * each host SPECULATES est from the freshest stats it has seen, maps its
    chunk immediately, then validates against the exact prefix stats from
    the relay (which serializes only the tiny scalar hand-off, not the
    mapping);
  * on an est mismatch — rare once the estimate converges — the chunk is
    remapped with the true stats.

The result is bit-identical to the single-host stream at any host count,
with the heavy work (seeding, alignment, SAM formatting) fully parallel.

Two relay transports: in-process (LocalStatRelay, for tests and
thread-parallel use) and TCP (StatRelayServer/SocketStatRelay) for real
multi-process runs alongside torch.distributed (the relay carries four host
scalars per chunk; device collectives would be the wrong tool).
Counterpart of kart_tpu/parallel/stats_sync.py, copied unchanged.
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading

FIELDS = ("paired", "distance", "unique", "unmapped")


def est_distance(stats: dict, max_insert_size: int) -> int:
    """EstDistance (Mapping.cpp:533-540) from a stats dict."""
    if stats["paired"] >= 1000:
        est = stats["distance"] // (stats["paired"] >> 2)
        return est + (est >> 1)
    return max_insert_size


class LocalStatRelay:
    """Ordered (by global chunk index) stat hand-off inside one process."""

    def __init__(self):
        self._stats = dict.fromkeys(FIELDS, 0)
        self._next = 0
        self._cond = threading.Condition()

    def peek(self) -> dict:
        with self._cond:
            return dict(self._stats)

    def get(self, k: int) -> dict:
        """Block until every chunk before k has posted; return prefix stats."""
        with self._cond:
            self._cond.wait_for(lambda: self._next == k)
            return dict(self._stats)

    def post(self, k: int, stats: dict) -> None:
        with self._cond:
            assert self._next == k, (self._next, k)
            self._stats = dict(stats)
            self._next = k + 1
            self._cond.notify_all()


class StatRelayServer:
    """TCP server wrapping a LocalStatRelay (run on host 0).  Line-JSON
    protocol: {"op": "get"|"post"|"peek", "k": int, "stats": {...}}."""

    def __init__(self, host="127.0.0.1", port=0):
        relay = LocalStatRelay()
        self.relay = relay

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    req = json.loads(line)
                    op = req["op"]
                    if op == "get":
                        resp = relay.get(req["k"])
                    elif op == "post":
                        relay.post(req["k"], req["stats"])
                        resp = {"ok": True}
                    else:
                        resp = relay.peek()
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()

        self._srv = socketserver.ThreadingTCPServer((host, port), Handler)
        self._srv.daemon_threads = True
        self.address = self._srv.server_address
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


class SocketStatRelay:
    """Client side of StatRelayServer; same interface as LocalStatRelay."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._f = self._sock.makefile("rwb")
        self._lock = threading.Lock()

    def _call(self, req: dict) -> dict:
        with self._lock:
            self._f.write(json.dumps(req).encode() + b"\n")
            self._f.flush()
            return json.loads(self._f.readline())

    def peek(self) -> dict:
        return self._call({"op": "peek"})

    def get(self, k: int) -> dict:
        return self._call({"op": "get", "k": k})

    def post(self, k: int, stats: dict) -> None:
        self._call({"op": "post", "k": k, "stats": stats})

    def close(self):
        self._f.close()
        self._sock.close()


def chunk_aligned_ranges(n_pairs: int, n_shards: int, pairs_per_chunk: int = 2000):
    """Contiguous pair-index ranges per shard, aligned to the global chunk
    grid so shard-local chunk boundaries coincide with the single-host
    stream's (the native reader chunks 4000 reads = 2000 pairs,
    io/fastq.READ_CHUNK_SIZE).  Returns [(lo_pair, hi_pair, first_chunk)]."""
    n_chunks = -(-n_pairs // pairs_per_chunk) if n_pairs else 0
    out = []
    for s in range(n_shards):
        c0 = n_chunks * s // n_shards
        c1 = n_chunks * (s + 1) // n_shards
        out.append((min(c0 * pairs_per_chunk, n_pairs), min(c1 * pairs_per_chunk, n_pairs), c0))
    return out


def _map_with(mapper, chunk, pair_end, fastq, stats):
    """Map one chunk against explicit prefix stats; returns (sam_lines,
    delta, est)."""
    before = {f: stats[f] for f in FIELDS}
    mapper.stats = dict(total=0, **before)
    est = est_distance(before, mapper.max_insert_size)
    sam = mapper.map_chunk(chunk, pair_end, fastq)
    delta = {f: mapper.stats[f] - before[f] for f in FIELDS}
    return sam, delta, est


def map_shard(mapper, path1, path2, pair_end, fastq, relay, first_chunk, writer,
              counters=None) -> None:
    """Map one input shard with exact sequential stat semantics.

    `first_chunk` is the shard's first GLOBAL chunk index (from
    chunk_aligned_ranges).  `counters`, when given, collects
    {"chunks": n, "respeculated": m} for observability."""
    from ..io.fastq import ReadStream, next_chunk

    s1 = ReadStream(path1, fastq)
    s2 = ReadStream(path2, fastq) if path2 else None
    k = first_chunk
    spec_stats = relay.peek()
    try:
        while True:
            chunk = next_chunk(s1, s2, pair_end, mapper.pacbio)
            if not chunk:
                break
            sam, delta, est_spec = _map_with(mapper, chunk, pair_end, fastq, spec_stats)
            true_stats = relay.get(k)
            if est_distance(true_stats, mapper.max_insert_size) != est_spec:
                sam, delta, _ = _map_with(mapper, chunk, pair_end, fastq, true_stats)
                if counters is not None:
                    counters["respeculated"] = counters.get("respeculated", 0) + 1
            after = {f: true_stats[f] + delta[f] for f in FIELDS}
            relay.post(k, after)
            spec_stats = after
            for line in sam:
                writer(line + "\n")
            if counters is not None:
                counters["chunks"] = counters.get("chunks", 0) + 1
            k += 1
    finally:
        s1.close()
        if s2:
            s2.close()
