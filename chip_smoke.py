"""Smoke run of the PyTorch/CUDA port (kart_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root
    python3 chip_smoke.py --compare DIR   # also time DIR/kart_tpu_torch's funnel and
                                          # resolve_pack (another commit's, unpacked with
                                          # git archive into a directory of this checkout)

Phases (each prints one line; any failure raises and exits non-zero):
  0. the device, and nvidia-smi's name and power limit; nvcc builds the
     port's kernels from kart_tpu_torch/csrc into kart_tpu_torch/_build;
  1. the NW kernel against its plain PyTorch version on the card, 4,096
     random fragment pairs per tile (16, 32, 64, 128): byte-equal planes, and
     every backtrace equal to the host DP's (nw_alignment);
  2. the FM-stepper kernel against its plain version on the card, one
     mapper chunk of 4,000 reads of 150 bp at l_max 160 on the E. coli-scale
     genome: equal output;
  3. the slice: 4,000 simulated 150 bp pairs mapped by the port's CLI
     (-backend python) on the card; kernel launch counts, NW coverage and
     memo misses checked; the first 500 pairs mapped again with -cpu must
     give the same SAM records;
  4. the 13-mer funnel, expand/resolve/pack and the FM re-seed against their
     plain versions on the card at the device-pipelined mode's shape: one
     dispatch group of 32,000 reads of 150 bp at l_max 160 (1% substitutions,
     Ns in 5% of reads), stream budget 96,000 with pack16; again with hit
     budget 1 and hit_cap 16 so that lanes are flagged, on a batch smaller
     than one slab (3,000 reads), and the re-seed batch of the flagged lanes
     through the FM stepper.  The funnel and resolve_pack are timed by slope
     over CUDA graphs of 8 and 136 calls, with the per-call event window
     beside it, the funnel's cluster size and grid, the rounds run and hits
     handed out (from the plain version), and the latency of a dependent
     load, from which the log gives each kernel's bound;
  5. the gather probe (kart_tpu_torch.tools.bench_gather): every
     formulation's ns/element at its defaults, timed by slope over CUDA
     graphs of 8 and 136 calls as kart_tpu's probe times them; the row-128
     pair (table[rid] and the row-gather kernel) also at 65,536-row lists,
     with its per-call times by one event window beside the slope; the
     kernel byte-equal to table[rid] on every variant at both sizes and on
     ragged lists of 1, 15, 17 and 4,097 rows;
  6. the device-pipelined slice: 100,000 pairs of 150 bp (bench.py's read
     set, from the port's tools/simdata) mapped by the port's CLI with
     KART_SEED_MODE=device; reads/s, set-up time, groups, launches and
     flagged lanes per group; its SAM records must equal
     the port's native-mode run's (host C++ engine), and the first 2,000
     pairs mapped again with -cpu must give the same records.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device the script exits
non-zero and prints no result.  Every kernel's record carries its launches
on the main path, its time, its plain version's, the one PyTorch call's that
computes the same function where there is one, and its bound: the larger of
the bytes it must move over 3.35 TB/s and its operations over 67 T/s, counted
from this run's inputs.  Neither JAX nor kart_tpu nor bench.py is ever
imported: the port runs on its own code.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

# the port must run without JAX and without the JAX package: any import of either fails
sys.modules["jax"] = None
sys.modules["kart_tpu"] = None

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "chip_smoke_data")
TILES = (16, 32, 64, 128)
N_NW = 4096
B_FM, READ_LEN, L_MAX_FM = 4000, 150, 160  # a mapper chunk of 150 bp reads
N_PAIRS, N_CPU_PAIRS = 4000, 500
B_GROUP, L_MAX_GROUP = 32000, 160  # one device-pipelined dispatch group
B_SUB_SLAB = 3000  # a batch smaller than one slab
N_DEV_PAIRS, N_DEV_CPU_PAIRS = 100_000, 2000  # bench.py's read set
GATHER_BIG = (262144, 9_279_361, 65536)  # the gather probe's second size: h, n, runs
RAGGED_HR = (1, 15, 17, 4097)
_ACGT = np.frombuffer(b"ACGT", np.uint8)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over `reps` runs after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def fragment_pairs(rng, n: int, lm: int) -> list[tuple[bytes, bytes]]:
    """n (s1, s2) pairs of length <= lm: s2 derives from s1 by ~8%
    substitutions, deletions and insertions; about a third carry Ns."""
    pairs = []
    for _ in range(n):
        a = _ACGT[rng.integers(0, 4, int(rng.integers(1, lm + 1)))]
        b = []
        for c in a:
            u = rng.random()
            if u < 0.03:
                continue
            b.append(int(_ACGT[rng.integers(0, 4)]) if u < 0.06 else int(c))
            if rng.random() < 0.02:
                b.append(int(_ACGT[rng.integers(0, 4)]))
        a, b = bytearray(a.tobytes()), bytearray(b or [int(a[0])])[:lm]
        if rng.random() < 0.33:
            a[int(rng.integers(0, len(a)))] = ord("N")
            b[int(rng.integers(0, len(b)))] = ord("N")
        pairs.append((bytes(a), bytes(b)))
    return pairs


def phase_nw(rng) -> dict:
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops.nw import encode_tile, nw_backtrace, nw_batch_planes_plain
    from kart_tpu_torch.pipeline.conquer import nw_alignment

    from kart_tpu_torch.tools.bench_kernels import bound_ms

    ms = plain_ms = bound = 0.0
    err = 0
    parts = []
    for lm in TILES:
        pairs = fragment_pairs(rng, N_NW, lm)
        c1, c2 = (torch.from_numpy(c).cuda() for c in encode_tile(pairs, lm))
        got = kernels.nw_planes(c1, c2, lm=lm)
        want = nw_batch_planes_plain(c1, c2, lm=lm)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).flatten(1).any(1).sum())
            raise AssertionError(f"NW lm={lm}: planes of {bad} pairs differ from the plain version")
        eq = got.cpu().numpy()
        for k, (a, b) in enumerate(pairs):
            if nw_backtrace(eq[k], a, b) != nw_alignment(a, b):
                raise AssertionError(f"NW lm={lm}: pair {k} backtrace differs from nw_alignment")
        t_k = cuda_ms(lambda: kernels.nw_planes(c1, c2, lm=lm), 20)
        t_p = cuda_ms(lambda: nw_batch_planes_plain(c1, c2, lm=lm), 3)
        # both code rows in, the planes out; a dozen operations a DP cell
        t_b, by = bound_ms(c1.nbytes + c2.nbytes + got.nbytes, 12 * N_NW * lm * lm)
        ms, plain_ms, bound = ms + t_k, plain_ms + t_p, bound + t_b
        err = max(err, int((got.int() - want.int()).abs().max()))
        parts.append(f"lm={lm} kernel {t_k:.4f} ms plain {t_p:.4f} ms bound {t_b:.4f} ms ({by})")
    print(f"phase 1 nw: {N_NW} pairs per tile, planes equal, backtraces equal; " + "; ".join(parts))
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound, bound_by=by)


def build_genome_index() -> str:
    """bench.py's E. coli-scale repeat genome (seed 7) from the port's own
    generator, indexed once by the port's build_index."""
    from kart_tpu_torch.index import build_index, index_files_exist
    from kart_tpu_torch.tools import simdata

    os.makedirs(DATA, exist_ok=True)
    fa, prefix = os.path.join(DATA, "genome.fa"), os.path.join(DATA, "idx")
    if not (os.path.exists(fa) and index_files_exist(prefix) and os.path.exists(prefix + ".saf")):
        rng = np.random.default_rng(simdata.GENOME_SEED)
        simdata.write_genome_fasta(fa, simdata.make_repeat_genome(rng))
        build_index(fa, prefix, verbose=False)
    return prefix


def group_reads(gidx, rng, B: int, l_max: int) -> np.ndarray:
    """(B, l_max) int8 codes padded 4: 150 bp cut from the genome, 1%
    substitutions, one N in 5% of the reads."""
    codes = gidx.ref_codes
    starts = rng.integers(0, gidx.two_genome_size - READ_LEN, B)
    reads = np.full((B, l_max), 4, np.int8)
    reads[:, :READ_LEN] = codes[starts[:, None] + np.arange(READ_LEN)]
    sub = rng.random((B, READ_LEN)) < 0.01
    reads[:, :READ_LEN][sub] = (reads[:, :READ_LEN][sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    ns = np.nonzero(rng.random(B) < 0.05)[0]
    reads[ns, rng.integers(0, READ_LEN, len(ns))] = 4
    return reads


def fm_bound(fm, reads, rlens, out) -> tuple[float, str]:
    """Bound of one FM-stepper call: the reads in, the seeds out, and the
    index rows its backward steps touch (one step per read base, each step
    the checkpoint and BWT rows of both interval ends, 2 x 64 bytes), at most
    the whole index; some eighty operations a step and end (the popcounts)."""
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    steps = int(rlens.sum())
    index = fm.occ_cp.nbytes + fm.bwt_words.nbytes
    return bound_ms(reads.nbytes + rlens.nbytes + out.nbytes + min(128 * steps, index), 160 * steps)


def phase_fm(gidx) -> dict:
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops.fm_search import FMIndexTensors, seed_scan_plain
    from kart_tpu_torch.pipeline.mapper import compute_min_seed_length

    rng = np.random.default_rng(11)
    codes = gidx.ref_codes
    starts = rng.integers(0, gidx.two_genome_size - READ_LEN, B_FM)
    reads = np.full((B_FM, L_MAX_FM), 4, np.int32)
    reads[:, :READ_LEN] = codes[starts[:, None] + np.arange(READ_LEN)]
    sub = rng.random((B_FM, READ_LEN)) < 0.01
    reads[:, :READ_LEN][sub] = (reads[:, :READ_LEN][sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    reads[rng.random(B_FM) < 0.05, int(rng.integers(0, READ_LEN))] = 4
    rlens = np.full(B_FM, READ_LEN, np.int32)
    msl = compute_min_seed_length(gidx.two_genome_size)
    max_seeds = L_MAX_FM // (msl + 1) + 1
    fm = FMIndexTensors.from_genome_index(gidx, "cuda")
    r, rl = torch.from_numpy(reads).cuda(), torch.from_numpy(rlens).cuda()
    kw = dict(max_seeds=max_seeds, l_max=L_MAX_FM)
    got = kernels.fm_seed_scan(fm, r, rl, msl, **kw)
    want = seed_scan_plain(fm, r, rl, msl, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).any(1).sum())
        raise AssertionError(f"FM stepper: {bad} of {B_FM} reads differ from the plain version")
    t_k = cuda_ms(lambda: kernels.fm_seed_scan(fm, r, rl, msl, **kw), 20)
    t_p = cuda_ms(lambda: seed_scan_plain(fm, r, rl, msl, **kw), 3)
    t_b, by = fm_bound(fm, r, rl, got)
    print(
        f"phase 2 fm_seed_scan: B={B_FM} l_max={L_MAX_FM} max_seeds={max_seeds}"
        f" min_seed={msl}, output equal ({int(got[:, 0].sum())} seeds);"
        f" kernel {t_k:.4f} ms plain {t_p:.4f} ms bound {t_b:.4f} ms ({by})"
    )
    return dict(ms=t_k, plain_ms=t_p, err=int((got - want).abs().max()), bound_ms=t_b, bound_by=by)


def simulate_pairs(fa: str, out1: str, out2: str, n_pairs: int) -> None:
    """The first n_pairs pairs of bench.py's read set (tools/simdata)."""
    from kart_tpu_torch.tools import simdata

    simdata.simulate_reads(simdata.read_genome_fasta(fa), out1, out2, n_pairs)


def run_cli(argv: list[str]) -> str:
    from kart_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["kart-tpu-torch", *argv])
    if rc != 0:
        raise AssertionError(f"cli exited {rc}: {buf.getvalue()}")
    return buf.getvalue()


def sam_records(path: str) -> list[bytes]:
    with open(path, "rb") as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith(b"@")]


def phase_slice(prefix: str) -> dict:
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops.nw import nw_stats

    r1, r2 = os.path.join(DATA, "r1.fq"), os.path.join(DATA, "r2.fq")
    simulate_pairs(os.path.join(DATA, "genome.fa"), r1, r2, N_PAIRS)
    sam_gpu = os.path.join(DATA, "gpu.sam")

    kernels.fm_seed_scan.launches = 0
    kernels.nw_planes.launches = 0
    nw_stats.update(device=0, host=0)
    t0 = time.perf_counter()
    log = run_cli(["-i", prefix, "-f", r1, "-f2", r2, "-o", sam_gpu, "-backend", "python", "-silent"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fm_seed_scan=kernels.fm_seed_scan.launches, nw_planes=kernels.nw_planes.launches)
    nw = dict(nw_stats)

    misses = int(re.search(r"memo misses = (\d+)", log).group(1))
    sens = re.search(r"sensitivity = ([\d.]+)%", log).group(1)
    paired = re.search(r"paired sequences = \d+ \(([\d.]+)%\)", log).group(1)
    recs = sam_records(sam_gpu)
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if nw["device"] == 0 or misses != 0:
        raise AssertionError(f"NW not served by the device batch: {nw}, memo misses {misses}")
    if len(recs) != 2 * N_PAIRS:
        raise AssertionError(f"{len(recs)} SAM records for {2 * N_PAIRS} reads")
    # read 1 is the fragment's forward start: POS should be the simulated one
    near = total = 0
    for rec in recs:
        f = rec.split(b"\t")
        if int(f[1]) & 0x40 and not int(f[1]) & 0x4:
            total += 1
            near += abs(int(f[3]) - int(f[0].split(b"Pos=")[1])) <= 10
    if near < 0.9 * N_PAIRS:
        raise AssertionError(f"only {near} of {N_PAIRS} read-1 records at their simulated position")

    # the first 500 pairs again on the CPU (plain versions): same records
    r1c, r2c = os.path.join(DATA, "r1_cpu.fq"), os.path.join(DATA, "r2_cpu.fq")
    for src, dst in ((r1, r1c), (r2, r2c)):
        with open(src, "rb") as f:
            lines = f.read().split(b"\n")[: 4 * N_CPU_PAIRS]
        with open(dst, "wb") as f:
            f.write(b"\n".join(lines) + b"\n")
    sam_cpu = os.path.join(DATA, "cpu.sam")
    run_cli(["-i", prefix, "-f", r1c, "-f2", r2c, "-o", sam_cpu, "-backend", "python", "-silent", "-cpu"])
    if sam_records(sam_cpu) != recs[: 2 * N_CPU_PAIRS]:
        raise AssertionError("the -cpu SAM of the first pairs differs from the GPU run's")
    print(
        f"phase 3 slice: {2 * N_PAIRS} reads in {wall:.3f} s = {2 * N_PAIRS / wall:.1f} reads/s;"
        f" mapped {sens}%, paired {paired}%, read-1 at simulated position {near}/{total};"
        f" launches {launches}; nw_stats {nw}; memo misses {misses};"
        f" first {N_CPU_PAIRS} pairs: -cpu SAM records equal"
    )
    return launches


def require_equal(got, want, what: str) -> int:
    """Raise unless the two tensors are equal; returns the max abs error (0)."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        bad = int((got != want).reshape(got.shape[0], -1).any(1).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: differs from the plain version ({bad} rows)")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def funnel_bound(tt, inputs, out, stats, load_ns: float) -> dict:
    """Bound of one funnel call from the plain version's counters: the packed
    reads in and the seed rows out once, a 32-byte sector of table_lo per
    13-mer lookup, per hit a sector of sa_full and two of text, a sector of
    sub_tbl per lane and round on the sub-13 path (each table at most once
    whole); some 200 operations a lane and round and 100 a hit.  `chain_ms`
    is the other floor: the most rounds any slab ran times three dependent
    loads (table_lo, sa_full, text) at the measured latency."""
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    lookups = sum(sum(c["lookups"]) for c in stats)
    hits = sum(sum(c["hits"]) for c in stats)
    sub13 = sum(sum(c["sub13"]) for c in stats)
    rounds = [c["rounds"] for c in stats]
    n_bytes = (sum(t.nbytes for t in inputs) + out.nbytes
               + min(32 * lookups, tt.table_lo.nbytes) + min(32 * hits, tt.sa_full.nbytes)
               + min(64 * hits, tt.text_words.nbytes) + min(32 * sub13, tt.sub_tbl.nbytes))
    lane_rounds = sum(c["rounds"] for c in stats) * (out.shape[0] // len(stats))
    t_b, by = bound_ms(n_bytes, 200 * lane_rounds + 100 * hits)
    return dict(bound_ms=t_b, bound_by=by, bytes=n_bytes, rounds=rounds, lookups=lookups,
                hits=hits, chain_ms=max(rounds) * 3 * load_ns / 1e6)


def resolve_bound(sa_full, packed, stream, n_occ: int, load_ns: float) -> dict:
    """Bound of one resolve_pack call: the seed rows in and the stream out
    once, a sector of sa_full per occurrence in the stream; some 120
    operations an output word (the search over read_end and the seed walk).
    `chain_ms`: two launches, each a chain of about three dependent loads."""
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    n_bytes = packed.nbytes + stream.nbytes + min(32 * n_occ, sa_full.nbytes)
    t_b, by = bound_ms(n_bytes, 120 * stream.numel())
    return dict(bound_ms=t_b, bound_by=by, bytes=n_bytes, chain_ms=6 * load_ns / 1e6)


def phase_funnel(gidx, tb, compare_dir: str | None) -> dict:
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops.fm_search import FMIndexTensors, seed_scan_plain
    from kart_tpu_torch.ops.kmer_seed import (
        HIT_BUDGET, SLAB_ROWS, KmerTablesTensors, hit_cap_for, kmer_seed_scan_plain,
    )
    from kart_tpu_torch.ops.pack import pack_reads_2bit, unpack_reads_plain, unpack_stream
    from kart_tpu_torch.ops.resolve import resolve_pack_plain
    from kart_tpu_torch.pipeline.mapper import compute_min_seed_length
    from kart_tpu_torch.tools import bench_kernels
    from kart_tpu_torch.tools.bench_kernels import bound_ms, time_both

    B, L = B_GROUP, L_MAX_GROUP
    reads = group_reads(gidx, np.random.default_rng(13), B, L)
    rlens = np.full(B, READ_LEN, np.int32)
    msl = compute_min_seed_length(gidx.two_genome_size)
    ms = L // (msl + 1) + 1
    tt = KmerTablesTensors.from_tables(tb, "cuda")

    def up(words, amb_r, amb_p, rl):
        return (torch.from_numpy(words.view(np.int32)).cuda(), torch.from_numpy(amb_r).cuda(),
                torch.from_numpy(amb_p).cuda(), torch.from_numpy(rl).cuda())

    w, ar, ap, rl = up(*pack_reads_2bit(reads), rlens)
    kw = dict(max_seeds=ms, l_max=L, hit_cap=hit_cap_for(tb.max_mult), rounds=L // 10 + 4,
              slab_rows=SLAB_ROWS, hit_budget=HIT_BUDGET)

    def funnel(k=kernels, **kk):
        return k.kmer_funnel(tt, w, ar, ap, rl, msl, **kk)

    def funnel_plain(**k):
        return kmer_seed_scan_plain(tt, unpack_reads_plain(w, ar, ap, L), rl, msl, **k)

    stats: list = []
    got = funnel(**kw)
    err = require_equal(got, funnel_plain(stats=stats, **kw), "kmer_funnel")
    H = 3 * B
    rk = dict(max_seeds=ms, has_ok=True, occ_budget=H, pack16=True)
    stream = kernels.resolve_pack(tt.sa_full, got, **rk)
    err = max(err, require_equal(stream, resolve_pack_plain(tt.sa_full, got, **rk), "resolve_pack"))
    flag0 = int((got[:, 1] == 0).sum())
    n_occ = int((unpack_stream(stream.cpu().numpy(), B, H, True)[2] >= 0).sum())

    # hit budget 1 and hit_cap 16: lanes flag, and their seeds must still match
    kw1 = dict(kw, hit_cap=16, hit_budget=1)
    got1 = funnel(**kw1)
    err = max(err, require_equal(got1, funnel_plain(**kw1), "kmer_funnel (hit budget 1)"))
    err = max(err, require_equal(kernels.resolve_pack(tt.sa_full, got1, **rk),
                                 resolve_pack_plain(tt.sa_full, got1, **rk),
                                 "resolve_pack (hit budget 1)"))
    bad = torch.nonzero(got1[:, 1] == 0).flatten().cpu().numpy()
    if len(bad) == 0:
        raise AssertionError("hit budget 1 and hit_cap 16 flagged no lane")

    # a batch smaller than one slab: one slab of B_SUB_SLAB rows (the list's
    # entries of later rows are out of range there and dropped)
    ws, rls = w[:B_SUB_SLAB].contiguous(), rl[:B_SUB_SLAB].contiguous()
    for name, k in (("sub-slab batch", kw), ("sub-slab batch, hit budget 1", kw1)):
        err = max(err, require_equal(
            kernels.kmer_funnel(tt, ws, ar, ap, rls, msl, **k),
            kmer_seed_scan_plain(tt, unpack_reads_plain(ws, ar, ap, L), rls, msl, **k),
            f"kmer_funnel ({name})"))

    # the re-seed batch of the flagged lanes: unpack, FM stepper, resolve
    nb = min(len(bad), 16000)
    Bb = 2048 if nb <= 2048 else 16000
    reads_b = np.full((Bb, L), 4, np.int8)
    reads_b[:nb] = reads[bad[:nb]]
    rl_b = np.zeros(Bb, np.int32)
    rl_b[:nb] = READ_LEN
    wb, arb, apb, rlb = up(*pack_reads_2bit(reads_b), rl_b)
    ur = kernels.unpack_reads(wb, arb, apb, l_max=L)
    err_u = require_equal(ur, unpack_reads_plain(wb, arb, apb, L), "unpack_reads")
    err = max(err, err_u)
    fm = FMIndexTensors.from_genome_index(gidx, "cuda")
    fk = dict(max_seeds=ms, l_max=L)
    seeds = kernels.fm_seed_scan(fm, ur, rlb, msl, **fk)
    err_fm = require_equal(seeds, seed_scan_plain(fm, ur, rlb, msl, **fk), "fm_seed_scan (re-seed)")
    rb = dict(max_seeds=ms, has_ok=False, occ_budget=Bb * 64, pack16=True)
    stream_b = kernels.resolve_pack(tt.sa_full, seeds, **rb)
    err = max(err, require_equal(stream_b, resolve_pack_plain(tt.sa_full, seeds, **rb),
                                 "resolve_pack (re-seed)"))

    # times: the two redesigned kernels by slope over CUDA graphs and per call
    load_ns = bench_kernels.dependent_load_ns()
    t_f = time_both(lambda: funnel(**kw))
    t_r = time_both(lambda: kernels.resolve_pack(tt.sa_full, got, **rk))
    t_rb = time_both(lambda: kernels.resolve_pack(tt.sa_full, seeds, **rb))
    t_fp = cuda_ms(lambda: funnel_plain(**kw), 1)
    t_rp = cuda_ms(lambda: resolve_pack_plain(tt.sa_full, got, **rk), 3)
    t_u = cuda_ms(lambda: kernels.unpack_reads(wb, arb, apb, l_max=L), 10)
    t_up = cuda_ms(lambda: unpack_reads_plain(wb, arb, apb, L), 10)
    t_fm = cuda_ms(lambda: kernels.fm_seed_scan(fm, ur, rlb, msl, **fk), 10)
    t_fmp = cuda_ms(lambda: seed_scan_plain(fm, ur, rlb, msl, **fk), 1)
    t_rbp = cuda_ms(lambda: resolve_pack_plain(tt.sa_full, seeds, **rb), 3)
    fb = funnel_bound(tt, (w, ar, ap, rl), got, stats, load_ns)
    rbound = resolve_bound(tt.sa_full, got, stream, n_occ, load_ns)
    n_occ_b = int((unpack_stream(stream_b.cpu().numpy(), Bb, Bb * 64, True)[2] >= 0).sum())
    rbound_b = resolve_bound(tt.sa_full, seeds, stream_b, n_occ_b, load_ns)
    ub, ub_by = bound_ms(wb.nbytes + arb.nbytes + apb.nbytes + ur.nbytes, 4 * ur.numel())
    fmb, fmb_by = fm_bound(fm, ur, rlb, seeds)
    cluster = kernels.funnel_cluster()
    n_slabs = -(-B // SLAB_ROWS)
    print(
        f"phase 4 funnel: B={B} l_max={L} slab={SLAB_ROWS} hit budget {HIT_BUDGET}"
        f" hit_cap {kw['hit_cap']}: kmer_funnel equal ({int(got[:, 0].sum())} seeds,"
        f" {flag0} lanes flagged); resolve_pack H={H} pack16 equal ({n_occ} occurrences);"
        f" hit budget 1 hit_cap 16: both equal, {len(bad)} lanes flagged; sub-slab batch of"
        f" {B_SUB_SLAB} (default budgets and hit budget 1): kmer_funnel equal; re-seed batch of"
        f" {nb} at B={Bb}: unpack_reads, fm_seed_scan and resolve_pack H={Bb * 64} equal"
        f" ({n_occ_b} occurrences)"
    )
    print(
        f"phase 4 kmer_funnel: cluster {cluster}, grid {n_slabs * cluster} blocks of"
        f" {-(-SLAB_ROWS // cluster)} lanes; slope {1e3 * t_f[0]:.4f} ms, per call"
        f" {1e3 * t_f[1]:.4f} ms, plain {t_fp:.4f} ms; rounds per slab {fb['rounds']},"
        f" {fb['lookups']} 13-mer lookups, {fb['hits']} hits handed out, {fb['bytes']} bytes:"
        f" bound {fb['bound_ms']:.4f} ms ({fb['bound_by']}); dependent load {load_ns:.1f} ns,"
        f" chain {max(fb['rounds'])} rounds x 3 loads = {fb['chain_ms']:.4f} ms"
    )
    print(
        f"phase 4 resolve_pack: totals on {-(-B // 256)} blocks; group (B={B} H={H}): slope"
        f" {1e3 * t_r[0]:.4f} ms, per call {1e3 * t_r[1]:.4f} ms, plain {t_rp:.4f} ms,"
        f" {rbound['bytes']} bytes: bound {rbound['bound_ms']:.4f} ms ({rbound['bound_by']}),"
        f" chain {rbound['chain_ms']:.4f} ms; re-seed layout (B={Bb} H={Bb * 64}): slope"
        f" {1e3 * t_rb[0]:.4f} ms, per call {1e3 * t_rb[1]:.4f} ms, plain {t_rbp:.4f} ms,"
        f" bound {rbound_b['bound_ms']:.4f} ms"
    )
    print(
        f"phase 4 re-seed batch: unpack_reads kernel {t_u:.4f} ms plain {t_up:.4f} ms bound"
        f" {ub:.4f} ms ({ub_by}); fm_seed_scan B={Bb} kernel {t_fm:.4f} ms plain {t_fmp:.4f} ms"
        f" bound {fmb:.4f} ms ({fmb_by})"
    )
    for name, fn in (("kmer_funnel", lambda: funnel(**kw)),
                     ("resolve_pack group", lambda: kernels.resolve_pack(tt.sa_full, got, **rk))):
        parts = bench_kernels.device_us_by_kernel(fn)
        print(f"phase 4 {name} device us per call by launch (torch.profiler): "
              + ", ".join(f"{k.replace('(anonymous namespace)::', '').split('(')[0]} {v:.2f}"
                          for k, v in sorted(parts.items())))
    if compare_dir is not None:
        compare_builds(compare_dir, funnel, kw, tt, got, seeds, rk, rb)
    return dict(
        funnel=dict(ms=1e3 * t_f[0], plain_ms=t_fp, err=err, bound_ms=fb["bound_ms"],
                    bound_by=fb["bound_by"]),
        resolve=dict(ms=1e3 * t_r[0], plain_ms=t_rp, err=err, bound_ms=rbound["bound_ms"],
                     bound_by=rbound["bound_by"]),
        unpack=dict(ms=t_u, plain_ms=t_up, err=err_u, bound_ms=ub, bound_by=ub_by),
        fm_err=err_fm)


def compare_builds(compare_dir, funnel, kw, tt, got, seeds, rk, rb) -> None:
    """Another commit's funnel and resolve_pack beside this commit's on the
    same inputs, in turns (other, this, this, other); the other build's
    outputs must equal this one's."""
    from kart_tpu_torch import kernels
    from kart_tpu_torch.tools.bench_kernels import load_kernels_module, time_both

    other = load_kernels_module(os.path.join(compare_dir, "kart_tpu_torch", "kernels.py"),
                                "kart_tpu_torch_compared_kernels")
    other.build()
    require_equal(funnel(other, **kw), got, "kmer_funnel of the compared build")
    for name, sd, k in (("group", got, rk), ("re-seed layout", seeds, rb)):
        require_equal(other.resolve_pack(tt.sa_full, sd, **k),
                      kernels.resolve_pack(tt.sa_full, sd, **k),
                      f"resolve_pack of the compared build ({name})")
    runs = {
        "kmer_funnel": (lambda: funnel(other, **kw), lambda: funnel(**kw)),
        "resolve_pack group": (lambda: other.resolve_pack(tt.sa_full, got, **rk),
                               lambda: kernels.resolve_pack(tt.sa_full, got, **rk)),
        "resolve_pack re-seed layout": (lambda: other.resolve_pack(tt.sa_full, seeds, **rb),
                                        lambda: kernels.resolve_pack(tt.sa_full, seeds, **rb)),
    }
    for name, (theirs, ours) in runs.items():
        t = [time_both(theirs), time_both(ours), time_both(ours), time_both(theirs)]
        print(f"phase 4 compare {name}: other, this, this, other: slope ms "
              + ", ".join(f"{1e3 * a:.4f}" for a, _ in t) + "; per call ms "
              + ", ".join(f"{1e3 * b:.4f}" for _, b in t))


def phase_gather() -> dict:
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.tools import bench_gather

    kernels.row_gather.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        res, pair = bench_gather.probe()
        big, big_pair = bench_gather.probe(*GATHER_BIG, row128_only=True)
    launches = kernels.row_gather.launches
    if launches == 0:
        raise AssertionError("the gather probe never launched row_gather")
    # ragged lists, half of them padding ids (row 0)
    rng = np.random.default_rng(5)
    nr = bench_gather.N_TABLE // 128
    t2 = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(nr, 128), dtype=np.int64)
                          .astype(np.int32)).cuda()
    err = 0
    for hr in RAGGED_HR:
        rid = rng.integers(0, nr, hr).astype(np.int32)
        rid[rng.random(hr) < 0.5] = 0
        r = torch.from_numpy(rid).cuda()
        err = max(err, require_equal(kernels.row_gather(t2, r), t2[r.long()], f"row_gather HR={hr}"))
    n_rows = [next(r["gather_latencies"] for r in recs if r["formulation"] == "row_128")
              for recs in (res, big)]
    print(f"phase 5 gather: row_gather byte-equal to table[rid] on all {bench_gather.NV} variants at"
          f" {n_rows[0]} and {n_rows[1]} rows and at HR {', '.join(map(str, RAGGED_HR))};"
          f" {launches} row_gather launches (eager and in graph replays); slope ns/element: "
          + ", ".join(f"{r['formulation']} {r['ns_per_elem']}" for r in res))
    for h, hr, times in zip((16384, GATHER_BIG[0]), n_rows, (pair, big_pair)):
        print(f"phase 5 row-128 pair at {hr} rows (H {h}):"
              + ";".join(f" {f} slope {1e6 * slope} us, per call {1e6 * call} us"
                         for f, (slope, call) in times.items()))
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    # the ids in and the rows out once, and each distinct row of a list in
    # once: the probe pads every list with row 0, so about half its ids
    # repeat.  The slope is over calls that take the variants in turn, so
    # the bytes are the variants' mean.
    _, _, idx_v = bench_gather.make_variants(16384, bench_gather.N_TABLE, 4096)
    rid_v = bench_gather.row_ids(idx_v, 128)[0]
    distinct = float(np.mean([len(np.unique(r)) for r in rid_v]))
    n_bytes = n_rows[0] * (4 + 512) + distinct * 512
    t_b, by = bound_ms(n_bytes, n_rows[0])
    print(f"phase 5 row_gather bound at {n_rows[0]} rows: {distinct:.1f} distinct rows a list,"
          f" {n_bytes:.0f} bytes (ids, distinct rows in, rows out): {1e3 * t_b:.4f} us ({by});"
          f" with every listed row read afresh {n_rows[0] * (4 + 2 * 512)} bytes:"
          f" {1e3 * bound_ms(n_rows[0] * (4 + 2 * 512), 0)[0]:.4f} us")
    # table[rid] is both the plain version and the one PyTorch call for the function
    return dict(ms=pair["pallas_dma_row128x8"][0] * 1e3, plain_ms=pair["row_128"][0] * 1e3, err=err,
                launches=launches, bound_ms=t_b, bound_by=by, library_ms=pair["row_128"][0] * 1e3)


def phase_device_slice(prefix: str) -> dict:
    import torch

    from kart_tpu_torch import kernels

    r1, r2 = os.path.join(DATA, "dev_r1.fq"), os.path.join(DATA, "dev_r2.fq")
    simulate_pairs(os.path.join(DATA, "genome.fa"), r1, r2, N_DEV_PAIRS)
    sam_dev, sam_nat = os.path.join(DATA, "dev.sam"), os.path.join(DATA, "native.sam")
    names = ("kmer_funnel", "resolve_pack", "fm_seed_scan", "unpack_reads")
    for k in names:
        getattr(kernels, k).launches = 0
    os.environ["KART_SEED_MODE"] = "device"
    try:
        t0 = time.perf_counter()
        log = run_cli(["-i", prefix, "-f", r1, "-f2", r2, "-o", sam_dev, "-silent"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(kernels, k).launches for k in names}
        m = re.search(r"set-up ([\d.]+) s .*mapping ([\d.]+) s", log)
        setup_s, map_s = float(m.group(1)), float(m.group(2))
        g = re.search(r"groups on cuda = (\d+), flagged lanes = (\d+), re-seeded on the device ="
                      r" (\d+), on the host = (\d+)", log)
        groups, flagged, on_dev, on_host = (int(x) for x in g.groups())
        per_group = re.search(r"per group: (.*)", log).group(1)
        sens = re.search(r"sensitivity = ([\d.]+)%", log).group(1)
        paired = re.search(r"paired sequences = \d+ \(([\d.]+)%\)", log).group(1)
        recs = sam_records(sam_dev)
        if len(recs) != 2 * N_DEV_PAIRS:
            raise AssertionError(f"{len(recs)} SAM records for {2 * N_DEV_PAIRS} reads")
        if any(v == 0 for v in launches.values()):
            raise AssertionError(f"a kernel of the path never launched: {launches}")

        # the first pairs again with -cpu (plain versions): the same records
        r1c, r2c = os.path.join(DATA, "dev_r1_cpu.fq"), os.path.join(DATA, "dev_r2_cpu.fq")
        for src, dst in ((r1, r1c), (r2, r2c)):
            with open(src, "rb") as f:
                lines = f.read().split(b"\n")[: 4 * N_DEV_CPU_PAIRS]
            with open(dst, "wb") as f:
                f.write(b"\n".join(lines) + b"\n")
        sam_cpu = os.path.join(DATA, "dev_cpu.sam")
        run_cli(["-i", prefix, "-f", r1c, "-f2", r2c, "-o", sam_cpu, "-silent", "-cpu"])
        if sam_records(sam_cpu) != recs[: 2 * N_DEV_CPU_PAIRS]:
            raise AssertionError("the -cpu SAM of the first pairs differs from the device run's")
    finally:
        del os.environ["KART_SEED_MODE"]
    # the port's default native mode on the same reads: the host C++ engine
    t0 = time.perf_counter()
    log_nat = run_cli(["-i", prefix, "-f", r1, "-f2", r2, "-o", sam_nat, "-silent"])
    nat_wall = time.perf_counter() - t0
    nat_map = float(re.search(r"mapping ([\d.]+) s", log_nat).group(1))
    if sam_records(sam_nat) != recs:
        raise AssertionError("the device-pipelined SAM differs from the native mode's")
    print(f"phase 6 device slice: {2 * N_DEV_PAIRS} reads, KART_SEED_MODE=device on the card")
    print(f"phase 6 reads/s: {2 * N_DEV_PAIRS / map_s:.1f} (mapping {map_s:.3f} s; CLI wall {wall:.3f} s)")
    print(f"phase 6 set-up: {setup_s:.3f} s (index load, funnel tables, device arrays)")
    print(
        f"phase 6 groups {groups}; launches {launches}; flagged lanes {flagged}, re-seeded on the"
        f" card {on_dev}, on the host {on_host}; {per_group}; mapped {sens}%, paired {paired}%;"
        f" SAM records equal to the native mode's (native: mapping {nat_map:.3f} s, CLI wall"
        f" {nat_wall:.3f} s); first {N_DEV_CPU_PAIRS} pairs: -cpu SAM records equal"
    )
    return launches


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="DIR", default=None,
                    help="a checkout of another commit whose funnel and resolve_pack phase 4"
                         " times beside this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from kart_tpu_torch import kernels
    from kart_tpu_torch.index import load_index

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    log = kernels.build()
    ptxas = "; ".join(
        ln.split("ptxas info    : ")[-1] for ln in log.splitlines() if "registers" in ln or "spill" in ln
    )
    print(
        f"phase 0 device: {name} ({smi}); torch {torch.__version__} cuda {torch.version.cuda};"
        f" kernels built in {time.perf_counter() - t0:.1f} s; ptxas: {ptxas or 'up to date'}"
    )

    nw = phase_nw(np.random.default_rng(2024))
    t0 = time.perf_counter()
    prefix = build_genome_index()
    gidx = load_index(prefix)
    print(f"setup: genome {gidx.genome_size} bp indexed and loaded in {time.perf_counter() - t0:.1f} s")
    fm = phase_fm(gidx)
    launches = phase_slice(prefix)
    from kart_tpu_torch.ops.kmer_seed import build_tables

    t0 = time.perf_counter()
    tb = build_tables(gidx)
    print(f"setup: funnel tables built or loaded in {time.perf_counter() - t0:.1f} s"
          f" (max 13-mer multiplicity {tb.max_mult})")
    funnel = phase_funnel(gidx, tb, args.compare)
    del tb
    gather = phase_gather()
    dev_launches = phase_device_slice(prefix)
    loaded = sorted(m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in ("jax", "kart_tpu", "bench"))
    if loaded:
        raise AssertionError(f"the port imported {loaded}")

    def entry(name, source, replaces, n_launches, r, library_ms=None):
        return dict(name=name, route="cuda", source=f"kart_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=n_launches, max_abs_err=r["err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=library_ms)

    fm["err"] = max(fm["err"], funnel["fm_err"])
    # library_ms: table[rid] for the row gather; no one PyTorch call computes
    # an FM backward search, an NW traceback plane, the funnel's rounds, the
    # budgeted expansion into a packed stream or the 2-bit unpack
    record = {"kernels": [
        entry("fm_seed_scan", "fm_seed_scan.cu", "kart_tpu/ops/fm_search.py:165",
              launches["fm_seed_scan"] + dev_launches["fm_seed_scan"], fm),
        entry("nw_planes", "nw.cu", "kart_tpu/ops/nw.py:55 and kart_tpu/ops/nw.py:160",
              launches["nw_planes"], nw),
        entry("kmer_funnel", "kmer_funnel.cu",
              "kart_tpu/ops/kmer_seed.py:272 and kart_tpu/ops/pack.py:98",
              dev_launches["kmer_funnel"], funnel["funnel"]),
        entry("resolve_pack", "resolve_pack.cu",
              "kart_tpu/ops/resolve.py:47 and kart_tpu/ops/pack.py:161",
              dev_launches["resolve_pack"], funnel["resolve"]),
        entry("unpack_reads", "kmer_funnel.cu", "kart_tpu/ops/pack.py:98",
              dev_launches["unpack_reads"], funnel["unpack"]),
        entry("row_gather", "row_gather.cu", "tools/bench_gather.py:208", gather["launches"],
              gather, gather["library_ms"]),
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
