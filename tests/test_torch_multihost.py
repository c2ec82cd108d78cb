"""Multi-host data parallelism of the port, as tests/test_multihost.py
holds kart_tpu's: below the 1000-pair threshold two independent shard runs
merged equal the single-host run (and kart_tpu's); above it two concurrent
shard mappers with the in-process stat relay reproduce the single-host
stream (itself equal to kart_tpu's) exactly while the insert-size estimate
evolves; and a genuine
two-process run (tests/torch_mh_worker.py: the gloo group of the port's
init_distributed, an all_gather, the TCP stat relay, map_shard) merges to
the single-host records."""

import json
import os
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from conftest import make_genome

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from simulate_reads import simulate  # noqa: E402


def _map_to(prefix, r1, r2, out, cli=None):
    if cli is None:
        from kart_tpu_torch import cli
    args = ["kart", "-i", str(prefix), "-f", str(r1)]
    if r2 is not None:
        args += ["-f2", str(r2)]
    args += ["-o", str(out), "-silent"]
    assert cli.main(args) == 0


@pytest.fixture(scope="module")
def mh_index(workdir):
    from kart_tpu_torch.index import build_index

    d = workdir / "torch_mh"
    d.mkdir(exist_ok=True)
    fa = d / "g.fa"
    fa.write_text(make_genome(np.random.default_rng(1234), [60000, 40000], n_runs=3))
    build_index(str(fa), str(d / "idx"), verbose=False)
    return d, fa


def _split_by_ranges(path, ranges, outdir, tag):
    recs = Path(path).read_text().splitlines(keepends=True)
    recs = ["".join(recs[i : i + 4]) for i in range(0, len(recs), 4)]
    outs = []
    for s, (lo, hi) in enumerate(ranges):
        p = Path(outdir) / f"{tag}_shard{s}.fq"
        p.write_text("".join(recs[lo:hi]))
        outs.append(p)
    return outs


def _records_only(path: Path) -> str:
    return "".join(
        ln for ln in path.read_text().splitlines(keepends=True) if not ln.startswith("@")
    )


def test_two_host_merge_equals_single_host(mh_index):
    from kart_tpu import cli as jax_cli
    from kart_tpu_torch.parallel import merge_sam_shards, paired_record_ranges

    d, fa = mh_index
    r1, r2 = d / "r1.fq", d / "r2.fq"
    simulate(str(fa), str(r1), str(r2), n_reads=1200, read_len=100, seed=5)
    single, jax_single = d / "single.sam", d / "jax_single.sam"
    _map_to(d / "idx", r1, r2, single)
    _map_to(d / "idx", r1, r2, jax_single, jax_cli)
    assert single.read_bytes() == jax_single.read_bytes()

    ranges = paired_record_ranges(str(r1), str(r2), 2)
    shards1 = _split_by_ranges(r1, ranges, d, "mh1")
    shards2 = _split_by_ranges(r2, ranges, d, "mh2")
    shard_sams = []
    for s in range(2):
        out = d / f"shard{s}.sam"
        _map_to(d / "idx", shards1[s], shards2[s], out)
        shard_sams.append(out)
    merged = d / "merged.sam"
    merge_sam_shards([str(p) for p in shard_sams], str(merged))
    assert merged.read_text() == single.read_text()


@pytest.fixture(scope="module")
def evolving(mh_index):
    """8 chunks (16,000 pairs) whose insert size shifts midway (300 ->
    600), so that EstDistance changes across chunk boundaries; the
    single-host SAM of the port, which equals kart_tpu's byte for byte, so
    that the relay and two-process runs held to it are held to kart_tpu."""
    from kart_tpu import cli as jax_cli

    d, fa = mh_index
    r1, r2 = d / "ev_r1.fq", d / "ev_r2.fq"
    a1, a2, b1, b2 = (d / f"ev_{x}.fq" for x in ("a1", "a2", "b1", "b2"))
    simulate(str(fa), str(a1), str(a2), n_reads=16000, read_len=100, dist=300, std=30, seed=21)
    simulate(str(fa), str(b1), str(b2), n_reads=16000, read_len=100, dist=600, std=60, seed=22)
    r1.write_bytes(a1.read_bytes() + b1.read_bytes())
    r2.write_bytes(a2.read_bytes() + b2.read_bytes())
    single, jax_single = d / "ev_single.sam", d / "ev_jax_single.sam"
    _map_to(d / "idx", r1, r2, single)
    _map_to(d / "idx", r1, r2, jax_single, jax_cli)
    assert single.read_bytes() == jax_single.read_bytes()
    return d, r1, r2, single


def test_stat_relay_above_threshold(evolving):
    """Two concurrent shard mappers and LocalStatRelay equal the single-host
    stream above the 1000-pair threshold with an evolving estimate."""
    from kart_tpu_torch.index import load_index
    from kart_tpu_torch.parallel.stats_sync import (
        LocalStatRelay,
        chunk_aligned_ranges,
        map_shard,
    )
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    d, r1, r2, single = evolving
    n_pairs = sum(1 for _ in open(r1)) // 4
    assert n_pairs == 16000
    ranges = chunk_aligned_ranges(n_pairs, 2)
    shards1 = _split_by_ranges(r1, [(lo, hi) for lo, hi, _ in ranges], d, "ev1")
    shards2 = _split_by_ranges(r2, [(lo, hi) for lo, hi, _ in ranges], d, "ev2")

    gidx = load_index(str(d / "idx"))
    relay = LocalStatRelay()
    outs = [[] for _ in range(2)]
    counters = [dict() for _ in range(2)]
    errors = []

    def run(s):
        try:
            mapper = TorchKartMapper(gidx, device="cpu")
            map_shard(mapper, str(shards1[s]), str(shards2[s]), True, True, relay,
                      ranges[s][2], outs[s].append, counters[s])
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    assert "".join("".join(o) for o in outs) == _records_only(single)
    assert sum(c.get("chunks", 0) for c in counters) == 8


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_torch_distributed(evolving):
    """A genuine two-process torch.distributed run: the gloo group, an
    all_gather across interpreters, the TCP stat relay; the merged SAM
    equals the single-host records."""
    from kart_tpu_torch.parallel.stats_sync import StatRelayServer, chunk_aligned_ranges

    d, r1, r2, single = evolving
    ranges = chunk_aligned_ranges(16000, 2)
    shards1 = _split_by_ranges(r1, [(lo, hi) for lo, hi, _ in ranges], d, "td1")
    shards2 = _split_by_ranges(r2, [(lo, hi) for lo, hi, _ in ranges], d, "td2")

    server = StatRelayServer()
    port = _free_port()
    procs, outs = [], []
    try:
        for pid in range(2):
            out = d / f"td_shard{pid}.sam"
            outs.append(out)
            cfg = d / f"td_cfg{pid}.json"
            cfg.write_text(json.dumps(dict(
                coordinator=f"127.0.0.1:{port}", nprocs=2, pid=pid, repo=str(REPO),
                prefix=str(d / "idx"), r1=str(shards1[pid]), r2=str(shards2[pid]),
                relay_host=server.address[0], relay_port=server.address[1],
                first_chunk=ranges[pid][2], out=str(out),
            )))
            env = {k: v for k, v in os.environ.items()
                   if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).parent / "torch_mh_worker.py"), str(cfg)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            ))
        for p in procs:
            sout, serr = p.communicate(timeout=300)
            assert p.returncode == 0, serr.decode()[-2000:]
            assert b"WORKER_OK" in sout, sout.decode()[-500:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.close()
    assert "".join(o.read_text() for o in outs) == _records_only(single)
