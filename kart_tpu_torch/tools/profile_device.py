"""Stage-level profile of one dispatch group of the port's device-pipelined
mode (KART_SEED_MODE=device), on the CUDA card or, with --cpu, on the CPU.

Counterpart of kart_tpu's `tools/profile_device.py`.  It reads G reader
chunks of 4,000 reads (the steady-state unit of
`TorchKartMapper._map_stream_device`) from bench.py's read set (made by
`tools/simdata.py`) and times each stage of that group alone, as the mapper
runs it.  kart_tpu's stage names, and the port's additions (+):

  read_host          + NativeReader: the group's G chunks, groups read one after
                       another from one reader
  encode_host        + _encode_group: the C++ encoder into (B, l_max) int8
  pack_host            the C++ 2-bit packer (ops/pack.pack_reads_2bit)
  pin_host           + _to_device's pinned copies of words, amb_r, amb_p, rlens
  h2d_words            their uploads on the mapper's stream
  scan_dev             the seeding scan alone: kmer_funnel, or unpack_reads +
                       fm_seed_scan (ops/pack.kmer_seed_scan_packed, seed_scan_packed)
  scan_resolve_dev     the mapper's own _seed_resolved: the scan, then
                       resolve_pack (in the sampled SA mode: rows, walk, flag, emit)
  resolve_delta_dev    scan_resolve_dev - scan_dev
  d2h_stream           the stream's download into pinned memory on the mapper's stream
  finalize_host      + _finalize_seed after the group's event: decode, re-seed
  reseed_batch       + of which the re-seed batch of the flagged lanes
                       (_reseed_device_flat; 0 where no lane is flagged)
  post_native          _chunk_flat + process_chunk_flat per 4,000-read chunk
  group_serial       + _dispatch_seed_async + _finalize_seed end to end, alone
                       (the mapper overlaps groups; this is one without overlap)

On the card, scan_dev and scan_resolve_dev are timed by slope over CUDA
graphs of 8 and 136 calls (tools/bench_kernels.time_both; the per-call event
window stands beside them in `derived`), the two copies by CUDA events
around `reps` copies on the mapper's stream (a window), and host stages by
the host clock, each the mean of `reps` runs after an untimed one (the
re-seed batch: of one run), the least and most of one run in
`derived["host_min_max_s"]`.  With --cpu every stage runs the plain
versions on the host clock, and the copies, which the CPU does not make,
are null.  The JSON's `timing` names each stage's method; a CPU time is
never a device time.
The profiled stream is checked equal to the mapper's own dispatch of the
same group.

    python -m kart_tpu_torch.tools.profile_device [--group 8] [--reps 5]
        [--engine auto|kmer|fm|fm_sampled] [--cpu] [--index PREFIX --reads R1 R2]

`fm` closes the funnel's gate (KART_KMER_GATE=0), so the FM stepper seeds;
`fm_sampled` also resolves through the sampled SA (KART_SA_MODE=sampled, the
human-scale shape).  Without --index the bench assets are made or found in
bench_data/ of the repository.  Without --cpu and without a CUDA device it
exits non-zero and measures nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(REPO, "bench_data")
READ_LEN = 150
ENGINE_ENV = {"auto": {}, "kmer": {}, "fm": {"KART_KMER_GATE": "0"},
              "fm_sampled": {"KART_SA_MODE": "sampled"}}


def device_for(cpu: bool) -> torch.device:
    """The CUDA device, or the CPU when asked; raises without a CUDA device
    unless the CPU was asked for."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --cpu to run the plain versions"
                         " on the CPU")
    return torch.device("cuda")


@contextlib.contextmanager
def environ(env: dict):
    """os.environ with `env` set inside the block, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def make_mapper(gidx, engine: str, device):
    """A TorchKartMapper of the device-pipelined mode whose seeding engine
    is `engine`, its state made as the CLI makes it (prepare()); the
    engine's environment is read there and restored after."""
    from ..pipeline.mapper import TorchKartMapper

    with environ({"KART_SEED_MODE": "device", **ENGINE_ENV[engine]}):
        mapper = TorchKartMapper(gidx, device=device)
        mapper.prepare()
    if engine == "kmer" and mapper._get_kmer_tables() is None:
        raise SystemExit("--engine kmer: the funnel's tables fail the gate on this index")
    return mapper


@contextlib.contextmanager
def read_group(mapper, r1: str, r2: str, G: int, reps: int = 1):
    """One steady-state group, as _map_stream_device makes it: G chunks of
    the native reader (kept valid inside the block) encoded into (B, l_max)
    int8 codes.  The read and the encode are each timed over `reps` runs
    after an untimed one: groups read one after another from one reader, as
    the mapper reads them (where the file runs out, a new reader starts over
    from its first read, its open counted in that run), and the encode of
    the last group read, which is the one yielded.  Yields (chunks,
    reads_i8, rlens, l_max, read seconds, encode seconds), each time a
    host_seconds tuple."""
    from ..native.post import NativeReader
    from ..pipeline.mapper import _B_BUCKETS, _CHUNK, _L_BUCKETS, _bucket

    reader = []

    def read():
        chunks = mapper._read_group(reader[0], G) if reader else []
        if sum(n for n, _ in chunks) < G * _CHUNK:
            while reader:
                reader.pop().close()
            reader.append(NativeReader(r1, r2, True, True, False, n_bufs=G + 2))
            chunks = mapper._read_group(reader[0], G)
        return chunks

    def encode():
        return mapper._encode_group(chunks, _L_BUCKETS, sorted(set(_B_BUCKETS + [G * _CHUNK])))

    try:
        t_read = host_seconds(read, reps)
        chunks = t_read[1]
        if sum(n for n, _ in chunks) != G * _CHUNK:
            raise ValueError(f"{r1}: fewer than {G * _CHUNK} reads for a group of {G} chunks")
        t_enc = host_seconds(encode, reps)
        reads_i8, rl, l_max = t_enc[1]
        if l_max != _bucket(READ_LEN, _L_BUCKETS):
            raise ValueError(f"l_max {l_max}: the group's reads are not {READ_LEN} bp")
        yield chunks, reads_i8, rl, l_max, t_read, t_enc
    finally:
        while reader:
            reader.pop().close()


def host_seconds(fn, reps: int):
    """fn() once untimed, then reps timed calls -> (mean seconds, the last
    result, (least, most) seconds of one call)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        ts.append(time.perf_counter() - t0)
    return sum(ts) / reps, out, (min(ts), max(ts))


def copy_window(stream, copy, reps: int) -> float:
    """Seconds per copy() by CUDA events around reps calls on `stream`."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        copy()
        start.record()
        for _ in range(reps):
            copy()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def profile(mapper, r1: str, r2: str, *, group: int = 8, reps: int = 5):
    """The stage table of one group of G = `group` chunks on the mapper's
    device -> (report dict with stages_s, per_read_us, timing and derived;
    the profiled stream as numpy)."""
    from ..ops.kmer_seed import hit_cap_for
    from ..ops.pack import kmer_seed_scan_packed, pack_reads_2bit, seed_scan_packed, unpack_stream
    from ..ops.resolve import decode_resolved_counts
    from ..pipeline.mapper import _host_arrays
    from . import bench_kernels

    cuda = mapper.device.type == "cuda"
    st: dict[str, float | None] = {}
    timing: dict[str, str | None] = {}
    derived: dict = {}
    spread: dict[str, tuple[float, float]] = {}

    def host(name, fn, n=reps):
        st[name], out, spread[name] = host_seconds(fn, n)
        timing[name] = "host"
        return out

    def device(name, fn):
        if cuda:
            st[name], derived[name + "_window_s"] = bench_kernels.time_both(fn)
            timing[name] = "slope"
        else:
            host(name, fn)

    with read_group(mapper, r1, r2, group, reps) as (chunks, reads_i8, rl, l_max, t_read,
                                                     t_enc):
        B = reads_i8.shape[0]
        for name, (mean, _, least_most) in (("read_host", t_read), ("encode_host", t_enc)):
            st[name], spread[name], timing[name] = mean, least_most, "host"

        # the mapper's own group, end to end without overlap; each run lets
        # go of the one before, as the mapper does, so that the pinned
        # blocks return to the host allocator's cache
        def serial():
            t0 = time.perf_counter()
            entry = mapper._dispatch_seed_async(reads_i8, rl, l_max)
            if cuda:
                entry["event"].synchronize()
            t1 = time.perf_counter()
            res = mapper._finalize_seed(entry, B, reads_i8, rl, l_max)
            runs.append((time.perf_counter() - t0, time.perf_counter() - t1))
            return _host_arrays(entry["host"]), res

        runs: list[tuple[float, float]] = []
        serial()
        runs.clear()
        for _ in range(reps):
            own, res = serial()
        for k, name in enumerate(("group_serial", "finalize_host")):
            ts = [r[k] for r in runs]
            st[name], spread[name], timing[name] = sum(ts) / reps, (min(ts), max(ts)), "host"
        log = mapper.group_log[-1]

        words, amb_r, amb_p = host("pack_host", lambda: pack_reads_2bit(reads_i8))
        arrays = (words, amb_r, amb_p, rl)
        if cuda:
            # _to_device's staging, then its copies
            pinned = host("pin_host", lambda: [
                torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).pin_memory()
                for a in arrays])
            dev_t = [t.to(mapper.device) for t in pinned]
            st["h2d_words"] = copy_window(
                mapper._stream, lambda: [t.to(mapper.device, non_blocking=True) for t in pinned],
                reps)
            timing["h2d_words"] = "window"
        else:
            st["pin_host"] = st["h2d_words"] = timing["pin_host"] = timing["h2d_words"] = None
            dev_t = mapper._to_device(arrays)[0]
        w, ar, ap, r = dev_t
        max_seeds = mapper._max_seeds(l_max)
        tb = mapper._get_kmer_tables()
        if tb is not None:
            def scan():
                return kmer_seed_scan_packed(
                    mapper._device_tables(), w, ar, ap, r, mapper.min_seed_len,
                    max_seeds=max_seeds, l_max=l_max, hit_cap=hit_cap_for(tb.max_mult),
                    rounds=mapper._funnel_rounds(l_max))
        else:
            def scan():
                return seed_scan_packed(mapper.fm, w, ar, ap, r, mapper.min_seed_len,
                                        max_seeds=max_seeds, l_max=l_max)

        def scan_resolve():
            return mapper._seed_resolved(w, ar, ap, r, l_max, B)

        device("scan_dev", scan)
        device("scan_resolve_dev", scan_resolve)
        st["resolve_delta_dev"] = st["scan_resolve_dev"] - st["scan_dev"]
        timing["resolve_delta_dev"] = timing["scan_dev"]

        out = scan_resolve()
        parts = out if isinstance(out, tuple) else (out,)
        if cuda:
            down = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in parts]

            def d2h():
                for h, t in zip(down, parts):
                    h.copy_(t, non_blocking=True)

            mapper._stream.wait_stream(torch.cuda.current_stream())
            st["d2h_stream"] = copy_window(mapper._stream, d2h, reps)
            timing["d2h_stream"] = "window"
        else:
            st["d2h_stream"] = timing["d2h_stream"] = None
        stream = _host_arrays(out)
        for a, b in zip(stream if isinstance(stream, tuple) else (stream,),
                        own if isinstance(own, tuple) else (own,)):
            if not np.array_equal(a, b):
                raise AssertionError("the profiled stream differs from the mapper's own dispatch")

        # the re-seed batch alone, on the lanes the stream flags
        H = mapper._occ_budget(B, l_max)
        ok = decode_resolved_counts(unpack_stream(stream, B, H, mapper._pack16(l_max))[0])[0]
        bad = np.nonzero(~ok[:B])[0]
        st["reseed_batch"] = 0.0
        if len(bad):
            host("reseed_batch", lambda: mapper._reseed_device_flat(bad, reads_i8, rl, l_max), 1)
        timing["reseed_batch"] = "host"

        # the C++ post of each chunk, as _map_stream_device calls it
        def post():
            stats = dict(total=0, unique=0, unmapped=0, paired=0, distance=0)
            row = 0
            for n0, ptrs0 in chunks:
                cnt, rp, ln, gp = mapper._chunk_flat(res, row, row + n0)
                mapper.native.process_chunk_flat(n0, n0 % 2 == 0, True, ptrs0, cnt, rp, ln, gp,
                                                 stats)
                row += n0
            return stats

        stats = host("post_native", post)

    nbytes = sum(p.nbytes for p in (stream if isinstance(stream, tuple) else (stream,)))
    up_bytes = sum(a.nbytes for a in arrays)
    order = ("read_host", "encode_host", "pack_host", "pin_host", "h2d_words", "scan_dev",
             "scan_resolve_dev", "resolve_delta_dev", "d2h_stream", "finalize_host",
             "reseed_batch", "post_native", "group_serial")
    stages = {k: st[k] for k in order}
    derived.update(
        B=B, l_max=l_max, engine="kmer" if tb is not None else f"fm/{mapper._device_sa_mode()}",
        device=torch.cuda.get_device_name(mapper.device) if cuda else "cpu", reps=reps,
        flagged_lanes=int(len(bad)), reseeded_device=log["reseeded_device"],
        reseeded_host=log["reseeded_host"], mapped_reads=B - stats["unmapped"],
        stream_bytes=int(nbytes), upload_bytes=int(up_bytes),
        h2d_MBps=None if not st["h2d_words"] else up_bytes / st["h2d_words"] / 1e6,
        d2h_MBps=None if not st["d2h_stream"] else nbytes / st["d2h_stream"] / 1e6,
        group_reads_per_sec_scan_resolve_only=B / max(st["scan_resolve_dev"], 1e-12),
        group_serial_reads_per_sec=B / st["group_serial"], host_min_max_s=spread,
        serial_host_per_group_ms=1e3 * (st["pack_host"] + (st["d2h_stream"] or 0.0)),
    )
    report = {"stages_s": stages,
              "per_read_us": {k: None if v is None else 1e6 * v / B for k, v in stages.items()},
              "timing": {k: timing[k] for k in order}, "derived": derived}
    return report, stream


def add_input_args(ap: argparse.ArgumentParser) -> None:
    """--cpu, --index and --reads, which this tool and analyze_trace share."""
    ap.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    ap.add_argument("--index", default=None, help="index prefix (default: the bench assets)")
    ap.add_argument("--reads", nargs=2, default=None, metavar=("R1", "R2"))


def inputs(args):
    """(device, loaded index, r1, r2) of add_input_args' flags: raises
    without a CUDA device unless --cpu; without --index, bench.py's assets
    in bench_data/ (made where missing)."""
    from ..index import load_index
    from . import simdata

    device = device_for(args.cpu)
    if args.index is None:
        prefix, r1, r2 = simdata.ensure_assets(DATA)
    elif args.reads is None:
        raise SystemExit("--index needs --reads R1 R2")
    else:
        prefix, (r1, r2) = args.index, args.reads
    return device, load_index(prefix), r1, r2


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--group", type=int, default=int(os.environ.get("KART_DEVICE_GROUP", "8")))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--engine", choices=list(ENGINE_ENV), default="auto",
                    help="seeding engine to profile (fm_sampled = human-scale shape)")
    add_input_args(ap)
    args = ap.parse_args(argv)
    device, gidx, r1, r2 = inputs(args)
    print(f"# device: {device}", file=sys.stderr)
    report, _ = profile(make_mapper(gidx, args.engine, device), r1, r2, group=args.group,
                        reps=args.reps)
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
