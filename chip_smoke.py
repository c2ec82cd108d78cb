"""Smoke run of the PyTorch/CUDA port (kart_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root
    python3 chip_smoke.py --phases 9      # phase 0, the set-up and phase 9 only (exit 4)
    python3 chip_smoke.py --compare DIR   # also time DIR/kart_tpu_torch's NW, FM stepper,
                                          # funnel, resolve_pack and SensitiveMode kernels
                                          # (another commit's, unpacked with git archive
                                          # into a directory of this checkout)

Phases (each prints one line; any failure raises and exits non-zero):
  0. the device, and nvidia-smi's name and power limit; nvcc builds the
     port's kernels from kart_tpu_torch/csrc into kart_tpu_torch/_build
     (a spill in an NW kernel fails the run);
  1. the NW kernel against its plain PyTorch version on the card, 4,097
     random fragment pairs per tile (16, 32, 64, 128): byte-equal planes, and
     every backtrace equal to the host DP's (nw_alignment); again on 1 and
     33 pairs; timed at 4,096 pairs by slope over CUDA graphs of 8 and 136
     calls, with the per-call event window beside it;
  2. the FM-stepper kernel against its plain version on the card, one
     mapper chunk of 4,000 reads of 150 bp at l_max 160 on the E. coli-scale
     genome: equal output; again on batches of 1, 127 and 4,001 reads
     with a pad lane (rlen 0), a read shorter than the minimal seed and an
     all-N read among them, and on the re-seed layout (2,048 lanes, 100 of them
     reads); timed by slope and per call, with the latency of a dependent
     load that hits L2 (a working set of the index's size), from which the
     log gives the chain bound: the longest read's steps times that latency;
  3. the python slice: 4,000 simulated 150 bp pairs mapped by the port's CLI
     (-backend python) on the card: (a) the funnel seeds (the FM stepper
     re-seeds only the lanes it flags), NW coverage and memo misses checked;
     (b) the same pairs with KART_DEVICE_CLUSTER=1 KART_DEVICE_PAIR=1, one
     cluster_illumina and one pair_candidates launch a 4,000-read chunk; (c)
     the first 500 pairs with both switches and -cpu; (d) the first 500
     pairs with KART_KMER_GATE=0 (the FM stepper seeds); (e) the first 500
     pairs with KART_HIT_BUDGET=1 KART_SLAB_ROWS=64 in a process of its own,
     so that the funnel flags lanes and the FM stepper re-seeds them: the SAM
     records of (b) to (e) equal (a)'s; reads/s are over the CLI's mapping
     seconds (the funnel's tables are built before the phase).  Both new
     kernels equal their plain versions at the chunk's shape (from run (b)'s
     own inputs) and on edge
     batches (B 1, no seeds, 9,000 chromosome keys; C2 70 and 3,100, ties
     and steals), timed by slope and per call with their bounds and chains,
     and the host seconds of their wrappers beside the host's own clustering
     and mating on the first chunk;
  4. the 13-mer funnel, expand/resolve/pack and the FM re-seed against their
     plain versions on the card at the device-pipelined mode's shape: one
     dispatch group of 32,000 reads of 150 bp at l_max 160 (1% substitutions,
     Ns in 5% of reads), stream budget 96,000 with pack16; again with hit
     budget 1 and hit_cap 16 so that lanes are flagged, on a batch smaller
     than one slab (3,000 reads), and the re-seed batch of the flagged lanes
     through the FM stepper.  The funnel, resolve_pack, the unpack and the
     FM stepper are timed by slope over CUDA graphs of 8 and 136 calls, with
     the per-call event window beside it, the funnel's cluster size and grid, the rounds run and hits
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
  7. the SensitiveMode (PacBio) kernels against their plain versions on the
     card, byte-equal: the funnel (kmer_funnel with sensitive) and the FM
     stepper (fm_sensitive_scan) on one dispatch group of 640 of simdata's
     PacBio reads (5-7 kb, 15% error) at l_max 8192, on the re-seed layout
     (16 lanes, 10 reads), on a 16-lane batch at l_max 32768 (reads of 20-30
     kb with the same error model, one of exactly 32,768 bases, an all-N
     read, a read shorter than the minimal seed, pad lanes), and on 16 reads
     cut from one copy of a repeat family, whose hits overrun the funnel's
     budget so that lanes are flagged; where the funnel says ok its seeds
     equal the stepper's; resolve_pack on both outputs in the 32-bit layout.
     The funnel's slabs by path (chased, replayed round by round): the group
     must be chased and the repeat family replayed.
     Slope and per-call times, bounds and chains as in phase 4, each new
     design's own chain beside the function's, and both kernels' launches
     by device time (torch.profiler);
  8. the PacBio slice: simdata's 1,500 PacBio reads mapped by the port's CLI
     with -pacbio: (a) KART_SEED_MODE=device on the card, whose SAM records
     must equal (b) the native mode's and (c) a -cpu device run's of the
     first 100 reads; (d) the first 320 reads with KART_KMER_GATE=0, so that
     the SensitiveMode FM stepper seeds every group; (e) -backend python on
     the first 40 reads.  Reads/s, set-up, groups, launches, flagged lanes,
     the share of reads mapped within 50 bp of their simulated position
     (as POS stands, and with the leading soft clip taken off), and
     the card's busy share of run (a) under torch.profiler.
  9. the sampled SA and the int64 index: the sa_walk kernel against its
     plain version on the stream rows of phase 4's group (96,000) and of the
     re-seed layout, on the int32 and the int64 index, with max_steps 4096
     and 8; resolve_pack through the sampled SA at the group's shape
     (pack16, also with max_steps 8 so that reads are flagged) and at int64
     (the 32-bit tuple, and through an int64 full SA); the FM stepper at
     int64 at B 4,000 and on the re-seed layout, and the SensitiveMode
     stepper at int64 on phase 7's group, each equal to its plain version
     and to the int32 result widened; each timed by slope and per call, the
     walk with its bound and chain.  Then the sampled slice through the CLI
     with KART_SA_MODE=sampled: (a) phase 6's 100,000 pairs device-pipelined
     on the card, (b) the native mode, (c) the first 10,000 pairs on an
     index forced to int64, (d) the first 1,000 pairs with -cpu, (e) the
     first 320 PacBio reads with -pacbio, device-pipelined and native: (a),
     (c) and (d) equal (b)'s SAM records, (a) equals phase 6's, (e) its
     native run's; reads/s, set-up, launches (sa_walk on the path, the
     funnel never), flagged lanes and the card's busy share of (a).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device the script exits
non-zero and prints no result.  Every kernel's record carries its launches
on the main path, its time (by slope), its plain version's, the one PyTorch
call's that computes the same function where there is one, and its bound: the
larger of the bytes it must move over 3.35 TB/s and its operations over 67
T/s, counted from this run's inputs, and for the FM stepper also its chain of
dependent index accesses.  Neither JAX nor kart_tpu nor bench.py is ever
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
RAGGED_NW = (1, 33)  # and N_NW + 1, the batch the planes and backtraces are checked on
RAGGED_FM = (1, 127, 4001)
RESEED_FM = (2048, 100)  # the re-seed batch's layout: lanes, of which reads
B_FM, READ_LEN, L_MAX_FM = 4000, 150, 160  # a mapper chunk of 150 bp reads
N_PAIRS, N_CPU_PAIRS = 4000, 500
B_GROUP, L_MAX_GROUP = 32000, 160  # one device-pipelined dispatch group
B_SUB_SLAB = 3000  # a batch smaller than one slab
N_DEV_PAIRS, N_DEV_CPU_PAIRS = 100_000, 2000  # bench.py's read set
GATHER_BIG = (262144, 9_279_361, 65536)  # the gather probe's second size: h, n, runs
RAGGED_HR = (1, 15, 17, 4097)
PB_B, PB_L = 640, 8192  # one PacBio dispatch group: 64 chunks of 10 reads
PB_LONG_L = 32768
PB_CPU_READS, PB_GATE0_READS, PB_PY_READS = 100, 320, 40
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


def compare_turns(name: str, theirs, ours) -> None:
    """Times of another build's call and this build's on the same inputs, in
    turns (other, this, this, other), by slope and per call."""
    from kart_tpu_torch.tools.bench_kernels import time_both

    t = [time_both(theirs), time_both(ours), time_both(ours), time_both(theirs)]
    print(f"compare {name}: other, this, this, other: slope ms "
          + ", ".join(f"{1e3 * a:.4f}" for a, _ in t) + "; per call ms "
          + ", ".join(f"{1e3 * b:.4f}" for _, b in t))


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


def phase_nw(rng, other=None) -> dict:
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops.nw import encode_tile, nw_backtrace, nw_batch_planes_plain
    from kart_tpu_torch.pipeline.conquer import nw_alignment

    from kart_tpu_torch.tools.bench_kernels import bound_ms, time_both

    ms = plain_ms = 0.0
    err = n_bytes = n_ops = 0
    parts = []
    for lm in TILES:
        pairs = fragment_pairs(rng, N_NW + 1, lm)
        c1, c2 = (torch.from_numpy(c).cuda() for c in encode_tile(pairs, lm))
        got = kernels.nw_planes(c1, c2, lm=lm)
        want = nw_batch_planes_plain(c1, c2, lm=lm)
        err = max(err, require_equal(got, want, f"NW lm={lm}, {N_NW + 1} pairs"))
        eq = got.cpu().numpy()
        for k, (a, b) in enumerate(pairs):
            if nw_backtrace(eq[k], a, b) != nw_alignment(a, b):
                raise AssertionError(f"NW lm={lm}: pair {k} backtrace differs from nw_alignment")
        for n in RAGGED_NW:
            require_equal(kernels.nw_planes(c1[:n], c2[:n], lm=lm), want[:n], f"NW lm={lm}, {n} pairs")
        c1, c2 = c1[:N_NW], c2[:N_NW]
        t_k, t_w = time_both(lambda: kernels.nw_planes(c1, c2, lm=lm))
        t_p = cuda_ms(lambda: nw_batch_planes_plain(c1, c2, lm=lm), 3)
        # both code rows in, the planes out; a dozen operations a DP cell
        tile_bytes, tile_ops = c1.nbytes + c2.nbytes + got[:N_NW].nbytes, 12 * N_NW * lm * lm
        t_b, by = bound_ms(tile_bytes, tile_ops)
        ms, plain_ms = ms + 1e3 * t_k, plain_ms + t_p
        n_bytes, n_ops = n_bytes + tile_bytes, n_ops + tile_ops
        parts.append(f"lm={lm} slope {1e3 * t_k:.4f} ms, per call {1e3 * t_w:.4f} ms, plain"
                     f" {t_p:.4f} ms, bound {t_b:.4f} ms ({by})")
        if other is not None:
            require_equal(other.nw_planes(c1, c2, lm=lm), want[:N_NW], f"NW lm={lm} of the compared build")
            compare_turns(f"nw_planes lm={lm} ({N_NW} pairs)",
                          lambda: other.nw_planes(c1, c2, lm=lm),
                          lambda: kernels.nw_planes(c1, c2, lm=lm))
    print(f"phase 1 nw: {N_NW + 1} pairs per tile, planes equal, backtraces equal; planes equal on "
          f"{', '.join(map(str, RAGGED_NW))} pairs; at {N_NW} pairs: " + "; ".join(parts))
    # the record's times and bound are those of one call a tile, the four tiles together
    bound, by = bound_ms(n_bytes, n_ops)
    return dict(ms=ms, plain_ms=plain_ms, err=err, bound_ms=bound, bound_by=by,
                shape=f"one call a tile, lm {', '.join(map(str, TILES))}, {N_NW} pairs each, summed")


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


def fm_bound(fm, reads, rlens, out, l2_load_ns: float) -> dict:
    """Bound of one FM-stepper call, the largest of three.  Bytes: the reads
    in, the seeds out, and the index rows its backward steps touch (one step
    per read base, each step the checkpoint and BWT rows of both interval
    ends, 2 x 64 bytes), at most the whole index.  Operations: some eighty a
    step and end (the popcounts).  Chain: a step's index access depends on
    the step before, so the longest read takes its bases times the latency of
    a dependent load, which at this index's size hits L2."""
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    steps = int(rlens.sum())
    index = fm.occ_cp.nbytes + fm.bwt_words.nbytes
    t_b, by = bound_ms(reads.nbytes + rlens.nbytes + out.nbytes + min(128 * steps, index), 160 * steps)
    chain = int(rlens.max()) * l2_load_ns / 1e6
    return dict(bound_ms=max(t_b, chain), bound_by="chain" if chain > t_b else by,
                chain_ms=chain, bytes_ms=t_b, bytes_by=by)


def fm_batch(gidx, rng, B: int, n_reads: int, edges: bool):
    """(B, L_MAX_FM) int32 codes and rlens: n_reads reads of 150 bp, then pad
    lanes (rlen 0).  With `edges`, row 1 is cut to less than the minimal
    seed, row 2 is all N and row 3 a pad lane."""
    reads = np.full((B, L_MAX_FM), 4, np.int32)
    reads[:n_reads] = group_reads(gidx, rng, n_reads, L_MAX_FM)
    rlens = np.zeros(B, np.int32)
    rlens[:n_reads] = READ_LEN
    if edges:
        rlens[1] = 11
        reads[1, 11:] = 4
        reads[2] = 4
        rlens[3] = 0
        reads[3] = 4
    return reads, rlens


def phase_fm(gidx, other=None) -> dict:
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops.fm_search import FMIndexTensors, seed_scan_plain
    from kart_tpu_torch.pipeline.mapper import compute_min_seed_length
    from kart_tpu_torch.tools.bench_kernels import dependent_load_ns, time_both

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
    kw = dict(max_seeds=max_seeds, l_max=L_MAX_FM)

    def both(rd, rls, what):
        r, rl = torch.from_numpy(rd).cuda(), torch.from_numpy(rls).cuda()
        got = kernels.fm_seed_scan(fm, r, rl, msl, **kw)
        want = seed_scan_plain(fm, r, rl, msl, **kw)
        return r, rl, got, require_equal(got, want, f"FM stepper, {what}")

    r, rl, got, err = both(reads, rlens, f"{B_FM} reads")
    seeds_ragged = []
    for B in RAGGED_FM:
        g = both(*fm_batch(gidx, rng, B, B, B > 3), f"{B} reads")[2]
        seeds_ragged.append(int(g[:, 0].sum()))
        if B > 3 and int(g[1:4].abs().sum()) != 0:
            raise AssertionError("FM stepper: a short, an all-N or a pad lane has seeds")
    rr, rrl, got_r, _ = both(*fm_batch(gidx, rng, *RESEED_FM, False), "re-seed layout")
    if int(got_r[RESEED_FM[1]:].abs().sum()) != 0:
        raise AssertionError("FM stepper: a pad lane of the re-seed layout has seeds")

    l2_ns = dependent_load_ns(working_set_bytes=fm.occ_cp.nbytes + fm.bwt_words.nbytes)
    t_k, t_w = time_both(lambda: kernels.fm_seed_scan(fm, r, rl, msl, **kw))
    t_rk, t_rw = time_both(lambda: kernels.fm_seed_scan(fm, rr, rrl, msl, **kw))
    t_p = cuda_ms(lambda: seed_scan_plain(fm, r, rl, msl, **kw), 3)
    fb = fm_bound(fm, r, rl, got, l2_ns)
    fb_r = fm_bound(fm, rr, rrl, got_r, l2_ns)
    print(
        f"phase 2 fm_seed_scan: B={B_FM} l_max={L_MAX_FM} max_seeds={max_seeds}"
        f" min_seed={msl}, output equal ({int(got[:, 0].sum())} seeds); equal on batches of "
        + ", ".join(f"{B} ({n} seeds)" for B, n in zip(RAGGED_FM, seeds_ragged))
        + f" with short, all-N and pad lanes, and on the re-seed layout B={RESEED_FM[0]} with"
        f" {RESEED_FM[1]} reads ({int(got_r[:, 0].sum())} seeds); B={B_FM}: slope {1e3 * t_k:.4f} ms,"
        f" per call {1e3 * t_w:.4f} ms, plain {t_p:.4f} ms; re-seed layout: slope {1e3 * t_rk:.4f} ms,"
        f" per call {1e3 * t_rw:.4f} ms, bound {fb_r['bound_ms']:.4f} ms ({fb_r['bound_by']});"
        f" dependent load that hits L2 {l2_ns:.1f} ns, chain"
        f" {int(rl.max())} steps = {fb['chain_ms']:.4f} ms, bytes and operations"
        f" {fb['bytes_ms']:.4f} ms ({fb['bytes_by']}): bound {fb['bound_ms']:.4f} ms ({fb['bound_by']})"
    )
    if other is not None:
        require_equal(other.fm_seed_scan(fm, r, rl, msl, **kw), got, "FM stepper of the compared build")
        compare_turns(f"fm_seed_scan B={B_FM}",
                      lambda: other.fm_seed_scan(fm, r, rl, msl, **kw),
                      lambda: kernels.fm_seed_scan(fm, r, rl, msl, **kw))
        compare_turns(f"fm_seed_scan re-seed layout B={RESEED_FM[0]}",
                      lambda: other.fm_seed_scan(fm, rr, rrl, msl, **kw),
                      lambda: kernels.fm_seed_scan(fm, rr, rrl, msl, **kw))
    # ms, plain_ms and the bound are the mapper chunk's (the python backend's
    # batch); the device-pipelined mode's re-seed layout stands beside them
    return dict(ms=1e3 * t_k, plain_ms=t_p, err=err, bound_ms=fb["bound_ms"],
                bound_by=fb["bound_by"], l2_ns=l2_ns,
                shape=f"B {B_FM}, l_max {L_MAX_FM}, {READ_LEN} bp reads",
                reseed_layout=dict(shape=f"B {RESEED_FM[0]}, of which {RESEED_FM[1]} reads",
                                   ms=1e3 * t_rk, bound_ms=fb_r["bound_ms"],
                                   bound_by=fb_r["bound_by"]))


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


def head_fastq(src: str, dst: str, n: int) -> str:
    """The first n records of a FASTQ file as a file of their own; returns dst."""
    with open(src, "rb") as f:
        lines = f.read().split(b"\n")[: 4 * n]
    with open(dst, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
    return dst


class Spy:
    """Stands in for `attr` of `module` inside the block: calls the original,
    keeps `keep(args)` of the first call, hands every result to `on_out` and
    sums the calls' host seconds."""

    def __init__(self, module, attr: str, keep=None, on_out=None):
        self.module, self.attr, self.keep, self.on_out = module, attr, keep, on_out
        self.first, self.seconds = None, 0.0

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.attr)

        def spy(*a, **k):
            if self.first is None and self.keep is not None:
                self.first = self.keep(a)
            t0 = time.perf_counter()
            out = orig(*a, **k)
            self.seconds += time.perf_counter() - t0
            if self.on_out is not None:
                self.on_out(out)
            return out

        setattr(self.module, self.attr, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


@contextlib.contextmanager
def environ(**env):
    """os.environ with `env` set (None: unset) inside the block."""
    old = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


PATH_KERNELS = ("fm_seed_scan", "nw_planes", "kmer_funnel", "cluster_illumina", "pair_candidates")


def slice_run(prefix, r1, r2, sam, extra=(), **env) -> tuple[str, dict, list, float]:
    """One run of the python backend through the CLI with `env`: its log, the
    launches of the path's kernels (every count set to 0 just before), the
    lanes the funnel flagged in each chunk, and the wall seconds (the log
    splits them into set-up and mapping, see cli_seconds)."""
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.pipeline import mapper as tm

    flags: list[int] = []
    for name in PATH_KERNELS:
        getattr(kernels, name).launches = 0
    t0 = time.perf_counter()
    with environ(**env), Spy(tm, "kmer_seed_scan",
                             on_out=lambda out: flags.append(int((out[:, 1] == 0).sum()))):
        log = run_cli(["-i", prefix, "-f", r1, "-f2", r2, "-o", sam, "-backend", "python",
                       "-silent", *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return log, {n: getattr(kernels, n).launches for n in PATH_KERNELS}, flags, wall


def cli_seconds(log: str) -> tuple[float, float]:
    """The set-up and the mapping seconds that the CLI's log gives."""
    m = re.search(r"set-up ([\d.]+) s .*mapping ([\d.]+) s", log)
    return float(m.group(1)), float(m.group(2))


# run (e) of phase 3 in a process of its own: the funnel module reads
# KART_HIT_BUDGET and KART_SLAB_ROWS where it is imported
_SMALL_BUDGET_RUN = """
import json, sys
import chip_smoke
_, launches, flags, _ = chip_smoke.slice_run(*sys.argv[1:5])
print(json.dumps(dict(launches=launches, flags=flags)))
"""


def small_budget_run(prefix, r1, r2, sam) -> dict:
    """The python backend with a hit budget of 1 and slabs of 64 rows, so that
    the funnel flags lanes and the FM stepper re-seeds them: its launches and
    the lanes flagged by chunk, from a child process."""
    env = dict(os.environ, KART_HIT_BUDGET="1", KART_SLAB_ROWS="64")
    for k in ("KART_KMER_GATE", "KART_DEVICE_CLUSTER", "KART_DEVICE_PAIR"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", _SMALL_BUDGET_RUN, prefix, r1, r2, sam],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"(e) exited {proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def cluster_edges(rng, args):
    """Edge batches of the clustering beside the run's chunk: its first read
    alone, reads without a seed, and 64 reads of 100 slots on 9,000
    chromosome keys, some with a negative starting threshold."""
    import torch

    keys, pd, gp, ln, n, thr0 = args
    out = {"B 1": (keys, pd[:1], gp[:1], ln[:1], n[:1], thr0[:1]),
           "no seeds": (keys, pd[:50], gp[:50], ln[:50], torch.zeros_like(n[:50]), thr0[:50])}
    B, S = 64, 100
    many = np.sort(rng.choice(10**8, 9000, replace=False)).astype(np.int32)
    p = np.sort(rng.integers(-3, 10**8, (B, S)), axis=1).astype(np.int32)
    p[:, 1::2] = p[:, ::2] + rng.integers(0, 8, (B, S // 2))
    g = (p + rng.integers(0, 100, (B, S))).astype(np.int32)
    g[:, 5] = many[rng.integers(0, 9000, B)]
    t = np.full(B, 20, np.int32)
    t[::7] = -60
    out["9,000 keys, S 100"] = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).cuda()
        for a in (many, p, g, rng.integers(13, 40, (B, S)).astype(np.int32),
                  rng.integers(0, S + 1, B).astype(np.int32), t))
    return out


def pair_edges(rng):
    """Edge batches of the mating: C2 > 32 with few distinct scores (ties and
    steals), and pairs of 40 + 3,100 slots."""
    import torch

    out = {}
    for name, (P, C1, C2, top, span, est) in {"C1 40, C2 70": (256, 40, 70, 4, 400, 100),
                                              "C1 40, C2 3,100": (8, 40, 3100, 10**5, 5000, 60)}.items():
        out[name] = tuple(torch.from_numpy(a).cuda() for a in (
            rng.integers(0, 4, (P, C1)).astype(np.int32),
            rng.integers(0, span, (P, C1)).astype(np.int32),
            rng.integers(0, top, (P, C2)).astype(np.int32),
            rng.integers(0, span, (P, C2)).astype(np.int32))) + (est,)
    # kart_tpu's tie and steal cases
    s1, d1 = [[10, 20], [10, 0], [10, 30]], [[100, 100], [100, 0], [100, 100]]
    s2, d2 = [[30, 0], [30, 30], [7, 9]], [[200, 0], [200, 300], [200, 400]]
    out["ties and steals"] = tuple(torch.tensor(a, dtype=torch.int32).cuda()
                                   for a in (s1, d1, s2, d2)) + (1500,)
    return out


def phase_slice(prefix: str, gidx, l2_load_ns: float) -> dict:
    import copy

    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops import cluster as ops_cluster
    from kart_tpu_torch.ops import pairing as ops_pairing
    from kart_tpu_torch.ops.nw import nw_stats
    from kart_tpu_torch.pipeline import mapper as tm
    from kart_tpu_torch.pipeline.candidates import gen_candidates_illumina
    from kart_tpu_torch.pipeline.pairing import check_paired_candidates
    from kart_tpu_torch.tools.bench_kernels import bound_ms, time_both

    r1, r2 = os.path.join(DATA, "r1.fq"), os.path.join(DATA, "r2.fq")
    simulate_pairs(os.path.join(DATA, "genome.fa"), r1, r2, N_PAIRS)
    sam_gpu = os.path.join(DATA, "gpu.sam")
    stages = dict(KART_DEVICE_CLUSTER="1", KART_DEVICE_PAIR="1")

    # (a) the funnel seeds, the host clusters and mates
    nw_stats.update(device=0, host=0)
    log, launches, flags, wall = slice_run(prefix, r1, r2, sam_gpu, KART_KMER_GATE=None,
                                           KART_DEVICE_CLUSTER=None, KART_DEVICE_PAIR=None)
    nw = dict(nw_stats)
    misses = int(re.search(r"memo misses = (\d+)", log).group(1))
    sens = re.search(r"sensitivity = ([\d.]+)%", log).group(1)
    paired = re.search(r"paired sequences = \d+ \(([\d.]+)%\)", log).group(1)
    setup_a, map_a = cli_seconds(log)
    recs = sam_records(sam_gpu)
    n_chunks = -(-2 * N_PAIRS // 4000)
    want = dict(fm_seed_scan=sum(1 for f in flags if f), nw_planes=launches["nw_planes"],
                kmer_funnel=n_chunks, cluster_illumina=0, pair_candidates=0)
    if launches != want or launches["nw_planes"] == 0 or len(flags) != n_chunks:
        raise AssertionError(f"(a): launches {launches}, expected {want} (flagged lanes {flags})")
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

    # (b) the same pairs with both device stages; the kernels' inputs and the
    # wrappers' host inputs of the first chunk are kept
    def clone(a):
        return tuple(x.clone() if torch.is_tensor(x) else x for x in a)

    sam_dev = os.path.join(DATA, "gpu_stages.sam")
    with Spy(ops_cluster, "cluster_illumina", clone) as k_cl, \
            Spy(ops_pairing, "pair_candidates", clone) as k_pr, \
            Spy(tm, "cluster_batch_to_candidates",
                lambda a: (copy.deepcopy(a[1]), list(a[2]), a[3])) as w_cl, \
            Spy(tm, "pair_chunk_on_device", copy.deepcopy) as w_pr:
        log_b, launches_b, _, _ = slice_run(prefix, r1, r2, sam_dev, KART_KMER_GATE=None, **stages)
    setup_b, map_b = cli_seconds(log_b)
    if sam_records(sam_dev) != recs:
        raise AssertionError("(b): the SAM records with the device stages differ from (a)'s")
    if (launches_b["cluster_illumina"], launches_b["pair_candidates"]) != (n_chunks, n_chunks):
        raise AssertionError(f"(b): launches {launches_b}, expected one of each new kernel a chunk")

    # (c) the first pairs with both stages on the CPU, (d) with the funnel's gate closed
    r1c = head_fastq(r1, os.path.join(DATA, "r1_cpu.fq"), N_CPU_PAIRS)
    r2c = head_fastq(r2, os.path.join(DATA, "r2_cpu.fq"), N_CPU_PAIRS)
    for tag, extra, env in (("c", ["-cpu"], dict(KART_KMER_GATE=None, **stages)),
                            ("d", [], dict(KART_KMER_GATE="0", KART_DEVICE_CLUSTER=None,
                                           KART_DEVICE_PAIR=None))):
        sam = os.path.join(DATA, f"slice_{tag}.sam")
        _, l_run, _, _ = slice_run(prefix, r1c, r2c, sam, extra, **env)
        if sam_records(sam) != recs[: 2 * N_CPU_PAIRS]:
            raise AssertionError(f"({tag}): the SAM records of the first pairs differ from (a)'s")
        if tag == "c" and any(l_run.values()):
            raise AssertionError(f"(c): a kernel launched in the -cpu run: {l_run}")
        if tag == "d" and (l_run["kmer_funnel"] or not l_run["fm_seed_scan"]):
            raise AssertionError(f"(d): the FM stepper did not seed alone: {l_run}")
        if tag == "d":
            launches_d = l_run
    # (e) the first pairs with a hit budget of 1 and slabs of 64 rows: the
    # funnel flags lanes and the FM stepper re-seeds them
    sam_e = os.path.join(DATA, "slice_e.sam")
    small = small_budget_run(prefix, r1c, r2c, sam_e)
    l_e, flags_e = small["launches"], small["flags"]
    if sam_records(sam_e) != recs[: 2 * N_CPU_PAIRS]:
        raise AssertionError("(e): the SAM records of the first pairs differ from (a)'s")
    if not any(flags_e) or l_e["fm_seed_scan"] != sum(1 for f in flags_e if f) \
            or l_e["kmer_funnel"] != len(flags_e):
        raise AssertionError(f"(e): launches {l_e}, flagged lanes by chunk {flags_e}: the FM"
                             " stepper must re-seed each chunk whose lanes the funnel flags")

    # the two kernels against their plain versions at the chunk's shape and on edges
    rng = np.random.default_rng(909)
    cl_args, mg, S = k_cl.first[:6], k_cl.first[6], k_cl.first[1].shape[1]
    err = 0
    for what, args in {f"chunk B {cl_args[1].shape[0]} S {S}": cl_args,
                       **cluster_edges(rng, cl_args)}.items():
        s_ = args[1].shape[1]
        got = kernels.cluster_illumina(*args, mg, max_seeds=s_)
        ref = ops_cluster.cluster_illumina_plain(*args, mg, max_seeds=s_)
        for g, w, part in zip(got, ref, ("cluster_id", "accept", "scores")):
            err = max(err, require_equal(g, w, f"cluster_illumina {part}, {what}"))
    pr_args = k_pr.first
    pr_err = 0
    for what, args in {f"chunk P {pr_args[0].shape[0]} C1 {pr_args[0].shape[1]} C2"
                       f" {pr_args[2].shape[1]}": pr_args, **pair_edges(rng)}.items():
        got = kernels.pair_candidates(*args)
        ref = ops_pairing.pair_candidates_plain(*args)
        for g, w, part in zip(got, ref, ("paired1", "paired2", "pairing")):
            pr_err = max(pr_err, require_equal(g, w, f"pair_candidates {part}, {what}"))

    # times, bounds and chains at the chunk's shape
    t_ck, t_cw = time_both(lambda: kernels.cluster_illumina(*cl_args, mg, max_seeds=S))
    t_cp = cuda_ms(lambda: ops_cluster.cluster_illumina_plain(*cl_args, mg, max_seeds=S), 3)
    t_pk, t_pw = time_both(lambda: kernels.pair_candidates(*pr_args))
    t_pp = cuda_ms(lambda: ops_pairing.pair_candidates_plain(*pr_args), 3)
    B = cl_args[1].shape[0]
    # the keys and three (B, S) arrays and two (B,) in, two (B, S) int32 and one
    # (B, S) byte array out; some twenty operations a slot
    c_bytes = cl_args[0].nbytes + 3 * B * S * 4 + 2 * B * 4 + B * S * 9
    c_bound, c_by = bound_ms(c_bytes, 20 * B * S)
    P, C1 = pr_args[0].shape
    C2 = pr_args[2].shape[1]
    live = int((pr_args[0] > 0).sum())  # read-1 slots that sweep C2 (a slot of score 0 is skipped)
    p_bytes = 2 * P * C1 * 4 + 2 * P * C2 * 4 + P * (C1 + C2) * 4 + P
    p_bound, p_by = bound_ms(p_bytes, 10 * live * C2)
    c_steps, p_steps = S, int((pr_args[0] > 0).sum(dim=1).max())
    cluster = dict(ms=1e3 * t_ck, plain_ms=t_cp, err=err, bound_ms=c_bound, bound_by=c_by,
                   chain_steps=c_steps, chain_ms=c_steps * l2_load_ns / 1e6,
                   shape=f"B {B}, S {S} (the first chunk of run (b))")
    pair = dict(ms=1e3 * t_pk, plain_ms=t_pp, err=pr_err, bound_ms=p_bound, bound_by=p_by,
                chain_steps=p_steps, chain_ms=p_steps * l2_load_ns / 1e6,
                shape=f"P {P}, C1 {C1}, C2 {C2} (the first chunk of run (b))")

    # the wrappers' host seconds beside the host's own clustering and mating,
    # on the first chunk's seeds and candidates
    seeds_lists, rlens, _ = w_cl.first
    dev_c, host_c = copy.deepcopy(seeds_lists), copy.deepcopy(seeds_lists)
    t0 = time.perf_counter()
    dev_c = ops_cluster.cluster_batch_to_candidates(gidx, dev_c, rlens, mg, device="cuda")
    t_wc = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_c = [gen_candidates_illumina(rl, s, gidx, mg) for rl, s in zip(rlens, host_c)]
    t_hc = time.perf_counter() - t0
    if [[(c.score, c.posdiff, len(c.seeds)) for c in x] for x in dev_c] != [
            [(c.score, c.posdiff, len(c.seeds)) for c in x] for x in host_c]:
        raise AssertionError("the device clustering's candidates differ from the host's")
    est, pairs = w_pr.first
    dev_p, host_p = copy.deepcopy(pairs), copy.deepcopy(pairs)
    t0 = time.perf_counter()
    flags_dev = ops_pairing.pair_chunk_on_device(est, dev_p, device="cuda")
    t_wp = time.perf_counter() - t0
    t0 = time.perf_counter()
    flags_host = [check_paired_candidates(est, a, b) for a, b in host_p]
    t_hp = time.perf_counter() - t0
    if flags_dev != flags_host or [[c.paired_idx for c in a + b] for a, b in dev_p] != [
            [c.paired_idx for c in a + b] for a, b in host_p]:
        raise AssertionError("the device mating differs from the host's")

    print(
        f"phase 3 slice: {2 * N_PAIRS} reads, mapping {map_a:.3f} s = {2 * N_PAIRS / map_a:.1f}"
        f" reads/s (set-up {setup_a:.3f} s, CLI wall {wall:.3f} s);"
        f" mapped {sens}%, paired {paired}%, read-1 at simulated position {near}/{total};"
        f" (a) launches {launches}, lanes the funnel flagged by chunk {flags}; nw_stats {nw};"
        f" memo misses {misses}; (b) KART_DEVICE_CLUSTER=1 KART_DEVICE_PAIR=1: mapping"
        f" {map_b:.3f} s = {2 * N_PAIRS / map_b:.1f} reads/s (set-up {setup_b:.3f} s), launches"
        f" {launches_b}, SAM records equal (a)'s; (c) first {N_CPU_PAIRS} pairs with both"
        f" stages and -cpu, (d) with KART_KMER_GATE=0 on the card (launches {launches_d}),"
        f" (e) with KART_HIT_BUDGET=1 KART_SLAB_ROWS=64 (launches {l_e}, lanes flagged by chunk"
        f" {flags_e}): SAM records equal"
    )
    print(
        f"phase 3 cluster_illumina: equal to the plain version at the chunk's shape ({cluster['shape']})"
        f" and on B 1, no seeds, 9,000 keys; slope {cluster['ms']:.4f} ms, per call"
        f" {1e3 * t_cw:.4f} ms, plain {t_cp:.4f} ms, bound {c_bound:.4f} ms ({c_by}), chain"
        f" {c_steps} steps x {l2_load_ns:.1f} ns = {cluster['chain_ms']:.4f} ms; host seconds of the"
        f" chunk: wrapper {t_wc:.4f} s (run (b), both chunks: {w_cl.seconds:.4f} s), host"
        f" gen_candidates_illumina {t_hc:.4f} s"
    )
    print(
        f"phase 3 pair_candidates: equal to the plain version at the chunk's shape ({pair['shape']})"
        f" and on C2 70, C2 3,100, ties and steals; slope {pair['ms']:.4f} ms, per call"
        f" {1e3 * t_pw:.4f} ms, plain {t_pp:.4f} ms, bound {p_bound:.4f} ms ({p_by}), chain"
        f" {p_steps} steps x {l2_load_ns:.1f} ns = {pair['chain_ms']:.4f} ms; host seconds of the"
        f" chunk: wrapper {t_wp:.4f} s (run (b), both chunks: {w_pr.seconds:.4f} s), host"
        f" check_paired_candidates {t_hp:.4f} s"
    )
    return dict(launches=launches, launches_b=launches_b, cluster=cluster, pair=pair)


def require_equal(got, want, what: str) -> int:
    """Raise unless the two tensors are equal; returns the max abs error (0)."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        bad = int((got != want).reshape(got.shape[0], -1).any(1).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{what}: differs from the plain version ({bad} rows)")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def funnel_bound(tt, inputs, out, stats, load_ns: float, l2_load_ns: float = 0.0) -> dict:
    """Bound of one funnel call from the plain version's counters: the packed
    reads in and the seed rows out once, a 32-byte sector of table_lo per
    13-mer lookup, per hit a sector of sa_full and two of text, a sector of
    sub_tbl per lane and round on the sub-13 path (each table at most once
    whole); some 200 operations a lane and round and 100 a hit.  `chain_ms`
    is the other floor: the most rounds any slab ran times three dependent
    loads (table_lo, sa_full, text) at the measured latency.
    `design_chain_ms`, the SensitiveMode design's own chain: one position's
    three dependent loads, then one load that hits L2 (`l2_load_ns`) per
    round of the chase."""
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
                hits=hits, chain_ms=max(rounds) * 3 * load_ns / 1e6,
                design_chain_ms=(3 * load_ns + max(rounds) * l2_load_ns) / 1e6)


def resolve_bound(sa_full, packed, stream, n_occ: int, load_ns: float) -> dict:
    """Bound of one resolve_pack call: the seed rows in and the stream out
    once, a sector of sa_full per occurrence in the stream; some 120
    operations an output word (the search over read_end and the seed walk).
    `chain_ms`: two launches, each a chain of about three dependent loads."""
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    n_bytes = packed.nbytes + stream.nbytes + min(32 * n_occ, sa_full.nbytes)
    t_b, by = bound_ms(n_bytes, 120 * stream.numel())
    return dict(bound_ms=t_b, bound_by=by, bytes=n_bytes, chain_ms=6 * load_ns / 1e6)


def phase_funnel(gidx, tb, other, l2_load_ns: float) -> dict:
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
    t_u = time_both(lambda: kernels.unpack_reads(wb, arb, apb, l_max=L))
    t_up = cuda_ms(lambda: unpack_reads_plain(wb, arb, apb, L), 10)
    t_fm = time_both(lambda: kernels.fm_seed_scan(fm, ur, rlb, msl, **fk))
    t_fmp = cuda_ms(lambda: seed_scan_plain(fm, ur, rlb, msl, **fk), 1)
    t_rbp = cuda_ms(lambda: resolve_pack_plain(tt.sa_full, seeds, **rb), 3)
    fb = funnel_bound(tt, (w, ar, ap, rl), got, stats, load_ns)
    rbound = resolve_bound(tt.sa_full, got, stream, n_occ, load_ns)
    n_occ_b = int((unpack_stream(stream_b.cpu().numpy(), Bb, Bb * 64, True)[2] >= 0).sum())
    rbound_b = resolve_bound(tt.sa_full, seeds, stream_b, n_occ_b, load_ns)
    ub, ub_by = bound_ms(wb.nbytes + arb.nbytes + apb.nbytes + ur.nbytes, 4 * ur.numel())
    fmb = fm_bound(fm, ur, rlb, seeds, l2_load_ns)
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
        f"phase 4 re-seed batch: unpack_reads slope {1e3 * t_u[0]:.4f} ms, per call"
        f" {1e3 * t_u[1]:.4f} ms, plain {t_up:.4f} ms, bound {ub:.4f} ms ({ub_by}); fm_seed_scan"
        f" B={Bb} ({nb} reads): slope {1e3 * t_fm[0]:.4f} ms, per call {1e3 * t_fm[1]:.4f} ms, plain"
        f" {t_fmp:.4f} ms, chain {fmb['chain_ms']:.4f} ms, bytes and operations"
        f" {fmb['bytes_ms']:.4f} ms: bound {fmb['bound_ms']:.4f} ms ({fmb['bound_by']})"
    )
    for name, fn in (("kmer_funnel", lambda: funnel(**kw)),
                     ("resolve_pack group", lambda: kernels.resolve_pack(tt.sa_full, got, **rk))):
        parts = bench_kernels.device_us_by_kernel(fn)
        print(f"phase 4 {name} device us per call by launch (torch.profiler): "
              + ", ".join(f"{k.replace('(anonymous namespace)::', '').split('(')[0]} {v:.2f}"
                          for k, v in sorted(parts.items())))
    if other is not None:
        compare_builds(other, funnel, kw, tt, got, seeds, rk, rb)
        require_equal(other.fm_seed_scan(fm, ur, rlb, msl, **fk), seeds,
                      "fm_seed_scan of the compared build (re-seed)")
        compare_turns(f"fm_seed_scan B={Bb} ({nb} reads)",
                      lambda: other.fm_seed_scan(fm, ur, rlb, msl, **fk),
                      lambda: kernels.fm_seed_scan(fm, ur, rlb, msl, **fk))
    return dict(
        funnel=dict(ms=1e3 * t_f[0], plain_ms=t_fp, err=err, bound_ms=fb["bound_ms"],
                    bound_by=fb["bound_by"]),
        resolve=dict(ms=1e3 * t_r[0], plain_ms=t_rp, err=err, bound_ms=rbound["bound_ms"],
                     bound_by=rbound["bound_by"]),
        unpack=dict(ms=1e3 * t_u[0], plain_ms=t_up, err=err_u, bound_ms=ub, bound_by=ub_by),
        fm_err=err_fm)


def compare_builds(other, funnel, kw, tt, got, seeds, rk, rb) -> None:
    """Another commit's funnel and resolve_pack beside this commit's on the
    same inputs, in turns; the other build's outputs must equal this one's."""
    from kart_tpu_torch import kernels

    require_equal(funnel(other, **kw), got, "kmer_funnel of the compared build")
    for name, sd, k in (("group", got, rk), ("re-seed layout", seeds, rb)):
        require_equal(other.resolve_pack(tt.sa_full, sd, **k),
                      kernels.resolve_pack(tt.sa_full, sd, **k),
                      f"resolve_pack of the compared build ({name})")
    compare_turns("kmer_funnel", lambda: funnel(other, **kw), lambda: funnel(**kw))
    compare_turns("resolve_pack group", lambda: other.resolve_pack(tt.sa_full, got, **rk),
                  lambda: kernels.resolve_pack(tt.sa_full, got, **rk))
    compare_turns("resolve_pack re-seed layout",
                  lambda: other.resolve_pack(tt.sa_full, seeds, **rb),
                  lambda: kernels.resolve_pack(tt.sa_full, seeds, **rb))


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
        r1c = head_fastq(r1, os.path.join(DATA, "dev_r1_cpu.fq"), N_DEV_CPU_PAIRS)
        r2c = head_fastq(r2, os.path.join(DATA, "dev_r2_cpu.fq"), N_DEV_CPU_PAIRS)
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


def fastq_codes(path: str, n: int) -> list[np.ndarray]:
    """The first n reads of a FASTQ file as int8 codes (ambiguous 4)."""
    from kart_tpu_torch.index.format import NT4_TABLE

    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [NT4_TABLE[np.frombuffer(lines[4 * i + 1], np.uint8)].astype(np.int8) for i in range(n)]


def pad_batch(seqs: list[np.ndarray], B: int, l_max: int):
    """(B, l_max) int8 codes padded 4 and (B,) rlens; lanes past the reads are pads."""
    reads = np.full((B, l_max), 4, np.int8)
    rlens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        reads[i, : len(s)] = s
        rlens[i] = len(s)
    return reads, rlens


def repeat_window(gidx, tb, span: int) -> int:
    """Start of the forward-strand window of `span` bases whose 13-mers occur
    most often (each counted at most 8 times, so that a 40-base motif with
    hundreds of copies does not outweigh a long repeat): a copy of the
    genome's 5 kb repeat family."""
    codes = gidx.ref_codes[: gidx.genome_size].astype(np.int64)
    km = np.zeros(len(codes) - 12, np.int64)
    for i in range(13):
        km = (km << 2) | codes[i : i + len(km)]
    c = np.concatenate([[0], np.cumsum(np.minimum(np.diff(tb.table_lo_np)[km], 8))])
    return int(np.argmax(c[span:] - c[:-span]))


def sens_fm_bound(fm, codes, rl, out, stats, l2_load_ns: float) -> dict:
    """Bound of one SensitiveMode FM-stepper call: the reads in and the seed
    rows out once, the index rows of this run's extension steps (at most the
    whole index), 160 operations a step.  Beside it two chains: the serial
    loop's (the trips of the lane that ran most of them times the latency of
    a dependent load that hits L2), which the position-parallel design does
    not have to follow, and that design's own."""
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    steps, trips = int(stats["steps"].sum()), int(stats["trips"].max())
    index = fm.occ_cp.nbytes + fm.bwt_words.nbytes
    t_b, by = bound_ms(codes.nbytes + rl.nbytes + out.nbytes + min(128 * steps, index), 160 * steps)
    chain = trips * l2_load_ns / 1e6
    # the design's own chain: the longest extension's 29 dependent steps,
    # then the chase's one dependent load per extension of the read that
    # started most of them (its scratch hits L2)
    starts = int(stats["starts"].max())
    design = (29 + starts) * l2_load_ns / 1e6
    return dict(bound_ms=t_b, bound_by=by, chain_ms=chain, bytes_ms=t_b, bytes_by=by, steps=steps,
                trips=trips, starts=starts, design_chain_ms=design)


def phase_sensitive(gidx, tb, pb: str, l2_load_ns: float, other=None) -> dict:
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops.fm_search import FMIndexTensors, sensitive_scan_plain
    from kart_tpu_torch.ops.kmer_seed import (
        HIT_BUDGET, SLAB_ROWS, KmerTablesTensors, hit_cap_for, kmer_seed_scan_plain,
    )
    from kart_tpu_torch.ops.pack import pack_reads_2bit, unpack_reads_plain
    from kart_tpu_torch.ops.resolve import resolve_pack_plain
    from kart_tpu_torch.pipeline.mapper import compute_min_seed_length
    from kart_tpu_torch.tools import bench_kernels, simdata
    from kart_tpu_torch.tools.bench_kernels import time_both

    from kart_tpu_torch.native.post import load_postlib

    load_postlib()  # built before the packer is timed
    msl = compute_min_seed_length(gidx.two_genome_size)
    tt = KmerTablesTensors.from_tables(tb, "cuda")
    fm = FMIndexTensors.from_genome_index(gidx, "cuda")
    load_ns = bench_kernels.dependent_load_ns()
    genome = simdata.read_genome_fasta(os.path.join(DATA, "genome.fa"))
    to_code = np.full(256, 4, np.int8)
    to_code[_ACGT] = np.arange(4)

    def case(name, reads_i8, rlens, l_max, timed=False):
        """Both kernels and resolve_pack on one batch against their plain
        versions; the funnel's ok lanes must carry the stepper's seeds."""
        B = reads_i8.shape[0]
        ms, H = l_max // msl + 2, B * max(64, l_max // 24)
        t0 = time.perf_counter()
        words, amb_r, amb_p = pack_reads_2bit(reads_i8)
        pack_s = time.perf_counter() - t0
        w, ar, ap, rl = (torch.from_numpy(words.view(np.int32)).cuda(), torch.from_numpy(amb_r).cuda(),
                         torch.from_numpy(amb_p).cuda(), torch.from_numpy(rlens).cuda())
        ka = dict(max_seeds=ms, l_max=l_max, hit_cap=hit_cap_for(tb.max_mult),
                  rounds=l_max // msl + 8, slab_rows=SLAB_ROWS, hit_budget=HIT_BUDGET, sensitive=True)
        kb = dict(max_seeds=ms, l_max=l_max)
        codes = kernels.unpack_reads(w, ar, ap, l_max=l_max)
        err = require_equal(codes, unpack_reads_plain(w, ar, ap, l_max), f"unpack_reads ({name})")
        st_a: list = []
        st_b: dict = {}
        kernels.funnel_slab_paths(w.device, reset=True)
        got_a = kernels.kmer_funnel(tt, w, ar, ap, rl, msl, **ka)
        paths = kernels.funnel_slab_paths(w.device, reset=True)
        err = max(err, require_equal(got_a, kmer_seed_scan_plain(tt, codes, rl, msl, stats=st_a, **ka),
                                     f"SensitiveMode kmer_funnel ({name})"))
        got_b = kernels.fm_sensitive_scan(fm, codes, rl, msl, **kb)
        err_b = require_equal(got_b, sensitive_scan_plain(fm, codes, rl, msl, stats=st_b, **kb),
                              f"fm_sensitive_scan ({name})")
        ok = got_a[:, 1] != 0
        if not torch.equal(torch.cat([got_a[:, :1], got_a[:, 2:]], dim=1)[ok], got_b[ok]):
            raise AssertionError(f"{name}: a lane the funnel calls ok differs from the FM stepper's")
        n_occ = []
        for packed, has_ok in ((got_a, True), (got_b, False)):
            rk = dict(max_seeds=ms, has_ok=has_ok, occ_budget=H, pack16=False)
            stream = kernels.resolve_pack(tt.sa_full, packed, **rk)
            err = max(err, require_equal(stream, resolve_pack_plain(tt.sa_full, packed, **rk),
                                         f"resolve_pack ({name}, has_ok {has_ok})"))
            n_occ.append(int((stream[B + H:] >= 0).sum()))
        res = dict(err=err, err_b=err_b, flagged=int((~ok).sum()), seeds=int(got_b[:, 0].sum()),
                   n_amb=len(amb_r), n_occ=n_occ, B=B, l_max=l_max, H=H, pack_s=pack_s, paths=paths)
        print(f"phase 7 {name}: B={B} l_max={l_max} max_seeds={ms}: kmer_funnel, fm_sensitive_scan"
              f" and resolve_pack (H={H}, 32-bit) equal their plain versions;"
              f" {int(got_a[:, 0].sum())} funnel seeds, {res['seeds']} stepper seeds, {res['flagged']}"
              f" lanes flagged, {n_occ[0]} and {n_occ[1]} occurrences, {res['n_amb']} ambiguity entries"
              f" (the host packer took {1e3 * pack_s:.3f} ms); funnel slabs: {paths[0]} chased,"
              f" {paths[1]} replayed")
        if other is not None and timed:
            require_equal(other.kmer_funnel(tt, w, ar, ap, rl, msl, **ka), got_a,
                          f"SensitiveMode kmer_funnel of the compared build ({name})")
            require_equal(other.fm_sensitive_scan(fm, codes, rl, msl, **kb), got_b,
                          f"fm_sensitive_scan of the compared build ({name})")
            compare_turns(f"kmer_funnel (sensitive) {name} B={B}",
                          lambda: other.kmer_funnel(tt, w, ar, ap, rl, msl, **ka),
                          lambda: kernels.kmer_funnel(tt, w, ar, ap, rl, msl, **ka))
            compare_turns(f"fm_sensitive_scan {name} B={B}",
                          lambda: other.fm_sensitive_scan(fm, codes, rl, msl, **kb),
                          lambda: kernels.fm_sensitive_scan(fm, codes, rl, msl, **kb))
        if timed:
            reps = dict(reps=8, n_small=4, n_big=36)
            rk = dict(max_seeds=ms, has_ok=True, occ_budget=H, pack16=False)
            t_a = time_both(lambda: kernels.kmer_funnel(tt, w, ar, ap, rl, msl, **ka), **reps)
            t_b = time_both(lambda: kernels.fm_sensitive_scan(fm, codes, rl, msl, **kb), **reps)
            t_r = time_both(lambda: kernels.resolve_pack(tt.sa_full, got_a, **rk))
            t_u = time_both(lambda: kernels.unpack_reads(w, ar, ap, l_max=l_max))
            res.update(
                t_a=t_a, t_b=t_b, t_r=t_r, t_u=t_u,
                p_a=once_ms(lambda: kmer_seed_scan_plain(tt, codes, rl, msl, **ka)),
                # the plain stepper runs for half a minute whatever the batch: timed once
                p_b=(once_ms(lambda: sensitive_scan_plain(fm, codes, rl, msl, **kb))
                     if timed == "with plain" else None),
                p_r=cuda_ms(lambda: resolve_pack_plain(tt.sa_full, got_a, **rk), 2),
                b_a=funnel_bound(tt, (w, ar, ap, rl), got_a, st_a, load_ns, l2_load_ns),
                b_b=sens_fm_bound(fm, codes, rl, got_b, st_b, l2_load_ns),
                b_r=resolve_bound(tt.sa_full, got_a, kernels.resolve_pack(tt.sa_full, got_a, **rk),
                                  n_occ[0], load_ns))
            # both kernels in one profiler session, their launches told apart by name
            parts = bench_kernels.device_us_by_kernel(
                lambda: (kernels.kmer_funnel(tt, w, ar, ap, rl, msl, **ka),
                         kernels.fm_sensitive_scan(fm, codes, rl, msl, **kb)), reps=3)
            for key, mine in (("parts_a", lambda k: "fm_" not in k), ("parts_b", lambda k: "fm_" in k)):
                res[key] = ", ".join(f"{short(k)} {v:.2f}" for k, v in sorted(parts.items()) if mine(k))
            res["parts_a"] += " (the memsets of both calls)"
        return res

    seqs = fastq_codes(pb, PB_B)
    group = case("group", *pad_batch(seqs, PB_B, PB_L), PB_L, timed="with plain")
    reseed = case("re-seed layout", *pad_batch(seqs[:10], 16, PB_L), PB_L, timed="kernels")

    # l_max 32768: long reads with the same error model, one of exactly
    # 32,768 bases, an all-N read, a read below the minimal seed, pad lanes
    rng = np.random.default_rng(77)
    long_reads = []
    for i in range(8):
        rl = PB_LONG_L if i == 0 else int(rng.integers(20000, 30001))
        p0 = int(rng.integers(0, len(genome) - 2 * rl))
        long_reads.append(to_code[np.frombuffer(
            simdata.noisy_copy(rng, genome[p0 : p0 + int(rl * 1.3)], rl), np.uint8)])
    long_reads += [np.full(900, 4, np.int8), long_reads[1][: msl - 1]]
    if len(long_reads[0]) != PB_LONG_L:
        raise AssertionError("the first long read is not of exactly l_max bases")
    longc = case("l_max 32768", *pad_batch(long_reads, 16, PB_LONG_L), PB_LONG_L)

    # 16 reads of 3 kb from one copy of a repeat family: each round's hits
    # overrun the budget of 4 a lane, so lanes are flagged
    p0 = repeat_window(gidx, tb, 4000)
    rep_reads = [to_code[np.frombuffer(simdata.noisy_copy(
        rng, genome[p0 + 40 * i : p0 + 40 * i + 3900], 3000, err=0.05), np.uint8)] for i in range(16)]
    flagged = case("repeat family", *pad_batch(rep_reads, 16, 4096), 4096)
    if flagged["flagged"] == 0:
        raise AssertionError("the repeat-family batch flagged no lane")
    # which path each batch's slabs took: the group's rounds fit the budget
    # (chased exactly), the repeat family's overrun it (replayed round by round)
    if group["paths"] != (1, 0) or flagged["paths"] != (0, 1):
        raise AssertionError(f"funnel paths: group {group['paths']}, repeat family {flagged['paths']}"
                             " (expected (1, 0) and (0, 1): chased, replayed)")
    if longc["seeds"] == 0 or group["seeds"] == 0:
        raise AssertionError("a SensitiveMode batch has no seeds")

    for r in (group, reseed):
        a, b = r["b_a"], r["b_b"]
        print(
            f"phase 7 times B={r['B']} l_max={r['l_max']}: kmer_funnel (sensitive) slope"
            f" {1e3 * r['t_a'][0]:.4f} ms, per call {1e3 * r['t_a'][1]:.4f} ms, plain {r['p_a']:.4f} ms;"
            f" rounds {a['rounds']}, {a['lookups']} 13-mer lookups, {a['hits']} hits, {a['bytes']} bytes:"
            f" bound {a['bound_ms']:.4f} ms ({a['bound_by']}); dependent load {load_ns:.1f} ns, chain"
            f" {max(a['rounds'])} rounds x 3 loads = {a['chain_ms']:.4f} ms; this design's chain: 3"
            f" loads, then {max(a['rounds'])} rounds x one load that hits L2 ({l2_load_ns:.1f} ns) ="
            f" {a['design_chain_ms']:.4f} ms; by launch (torch.profiler, us): {r['parts_a']}"
        )
        print(
            f"phase 7 times B={r['B']} l_max={r['l_max']}: fm_sensitive_scan slope"
            f" {1e3 * r['t_b'][0]:.4f} ms, per call {1e3 * r['t_b'][1]:.4f} ms, plain"
            f" {'not timed' if r['p_b'] is None else format(r['p_b'], '.4f') + ' ms'};"
            f" {b['steps']} extension steps, longest lane {b['trips']} trips; bytes and operations:"
            f" bound {b['bound_ms']:.4f} ms ({b['bound_by']}); dependent load that hits L2"
            f" {l2_load_ns:.1f} ns: the serial loop's chain {b['chain_ms']:.4f} ms;"
            f" this design's chain: 29 steps, then {b['starts']} extensions a read ="
            f" {b['design_chain_ms']:.4f} ms; by launch (torch.profiler, us): {r['parts_b']}"
        )
        print(
            f"phase 7 times B={r['B']} l_max={r['l_max']}: resolve_pack H={r['H']} 32-bit slope"
            f" {1e3 * r['t_r'][0]:.4f} ms, per call {1e3 * r['t_r'][1]:.4f} ms, plain {r['p_r']:.4f} ms,"
            f" bound {r['b_r']['bound_ms']:.4f} ms ({r['b_r']['bound_by']}); unpack_reads"
            f" ({r['n_amb']} ambiguity entries) slope {1e3 * r['t_u'][0]:.4f} ms, per call"
            f" {1e3 * r['t_u'][1]:.4f} ms"
        )
    err = max(c["err"] for c in (group, reseed, longc, flagged))
    err_b = max(c["err_b"] for c in (group, reseed, longc, flagged))

    def rec(r, t, p, b, e):
        return dict(ms=1e3 * r[t][0], plain_ms=r[p], err=e, bound_ms=r[b]["bound_ms"],
                    bound_by=r[b]["bound_by"], design_chain_ms=r[b]["design_chain_ms"])

    shape = f"B {PB_B}, l_max {PB_L}, simulated PacBio reads of 5-7 kb"
    lay = f"B 16, of which 10 reads, l_max {PB_L}"
    return dict(
        funnel=dict(rec(group, "t_a", "p_a", "b_a", err), shape=shape,
                    chain_ms=group["b_a"]["chain_ms"], slab_paths={
                        c: list(r["paths"]) for c, r in (("group", group), ("re-seed layout", reseed),
                                                         ("l_max 32768", longc),
                                                         ("repeat family", flagged))},
                    reseed_layout=dict(rec(reseed, "t_a", "p_a", "b_a", err), shape=lay)),
        fm=dict(rec(group, "t_b", "p_b", "b_b", err_b), shape=shape, chain_ms=group["b_b"]["chain_ms"],
                reseed_layout=dict(rec(reseed, "t_b", "p_b", "b_b", err_b), shape=lay)))


def short(kernel_name: str) -> str:
    """A profiler's kernel name without its namespace and argument list; a
    copy keeps its direction."""
    if kernel_name.startswith("Mem"):
        return kernel_name
    return kernel_name.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]


def once_ms(fn) -> float:
    """Device time of one fn() in ms, no warm-up: for plain versions that run
    for seconds."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


PB_KERNELS = ("kmer_funnel", "resolve_pack", "fm_sensitive_scan", "unpack_reads", "fm_seed_scan",
              "nw_planes")


def phase_pacbio_slice(prefix: str, pb: str) -> dict:
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.tools import simdata
    from kart_tpu_torch.tools.bench_kernels import busy_seconds, device_spans

    n_all = simdata.PB_N_READS
    sam = {k: os.path.join(DATA, f"pb_{k}.sam") for k in ("dev", "nat", "cpu", "gate0", "py", "prof")}
    base = ["-i", prefix, "-pacbio", "-silent"]

    def device_run(reads, out, extra=()):
        """One CLI run with the launch counts set to 0 just before it and
        read just after: (log, launches)."""
        for k in PB_KERNELS:
            getattr(kernels, k).launches = 0
        log = run_cli([*base, "-f", reads, "-o", out, *extra])
        torch.cuda.synchronize()
        return log, {k: getattr(kernels, k).launches for k in PB_KERNELS}

    def counts(log, dev):
        g = re.search(rf"groups on {dev} = (\d+), flagged lanes = (\d+), re-seeded on the device ="
                      r" (\d+), on the host = (\d+)", log)
        return tuple(int(x) for x in g.groups())

    def times(log):
        m = re.search(r"set-up ([\d.]+) s .*mapping ([\d.]+) s", log)
        return float(m.group(1)), float(m.group(2))

    os.environ["KART_SEED_MODE"] = "device"
    try:
        log, launches = device_run(pb, sam["dev"])  # (a)
        setup_s, map_s = times(log)
        groups, flagged, on_dev, on_host = counts(log, "cuda")
        per_group = re.search(r"per group: (.*)", log).group(1)
        sens = re.search(r"sensitivity = ([\d.]+)%", log).group(1)
        recs = sam_records(sam["dev"])
        if len(recs) != n_all:
            raise AssertionError(f"{len(recs)} SAM records for {n_all} PacBio reads")
        # (c) the first reads again with -cpu (plain versions)
        run_cli([*base, "-f", head_fastq(pb, os.path.join(DATA, "pb_cpu.fq"), PB_CPU_READS),
                 "-o", sam["cpu"], "-cpu"])
        if sam_records(sam["cpu"]) != recs[:PB_CPU_READS]:
            raise AssertionError("PacBio: the -cpu SAM of the first reads differs from the device run's")
        # (d) the FM stepper as the seeder: the funnel's gate refuses every genome
        os.environ["KART_KMER_GATE"] = "0"
        try:
            log0, launches0 = device_run(
                head_fastq(pb, os.path.join(DATA, "pb_gate0.fq"), PB_GATE0_READS), sam["gate0"])
        finally:
            del os.environ["KART_KMER_GATE"]
        g0 = counts(log0, "cuda")
        map0 = times(log0)[1]
        if sam_records(sam["gate0"]) != recs[:PB_GATE0_READS]:
            raise AssertionError("PacBio: the SAM with KART_KMER_GATE=0 differs from the funnel run's")
        if launches0["kmer_funnel"] != 0 or launches0["fm_sensitive_scan"] == 0:
            raise AssertionError(f"KART_KMER_GATE=0 did not seed with the FM stepper: {launches0}")
        # run (a) again under the profiler: the card's busy share
        cpu_fq = os.path.join(DATA, "pb_cpu.fq")
        prof_log: list = []
        spans = device_spans(lambda: prof_log.append(run_cli([*base, "-f", pb, "-o", sam["prof"]])),
                             warm=lambda: run_cli([*base, "-f", cpu_fq, "-o", sam["cpu"] + ".warm"]))
        prof_map = times(prof_log[0])[1]
    finally:
        del os.environ["KART_SEED_MODE"]
    if launches["kmer_funnel"] == 0 or launches["resolve_pack"] == 0:
        raise AssertionError(f"a kernel of the PacBio path never launched: {launches}")
    if sam_records(sam["prof"]) != recs:
        raise AssertionError("PacBio: the profiled run's SAM differs")
    # (b) the native mode on the same reads
    t0 = time.perf_counter()
    log_nat = run_cli([*base, "-f", pb, "-o", sam["nat"]])
    nat_wall = time.perf_counter() - t0
    nat_setup, nat_map = times(log_nat)
    if sam_records(sam["nat"]) != recs:
        raise AssertionError("PacBio: the device-pipelined SAM differs from the native mode's")
    # (e) the python backend on the first reads
    for k in PB_KERNELS:
        getattr(kernels, k).launches = 0
    t0 = time.perf_counter()
    log_py = run_cli([*base, "-f", head_fastq(pb, os.path.join(DATA, "pb_py.fq"), PB_PY_READS),
                      "-o", sam["py"], "-backend", "python"])
    py_wall = time.perf_counter() - t0
    launches_py = {k: getattr(kernels, k).launches for k in PB_KERNELS}
    if sam_records(sam["py"]) != recs[:PB_PY_READS]:
        raise AssertionError("PacBio: the python backend's SAM differs from the native mode's")
    if launches_py["fm_sensitive_scan"] == 0:
        raise AssertionError(f"the python backend did not seed on the card: {launches_py}")
    # POS is the first aligned base: the read's simulated start is POS less
    # the leading soft clip (the engine clips a noisy head)
    near = near_raw = mapped = 0
    for rec in recs:
        f = rec.split(b"\t")
        if not int(f[1]) & 0x4:
            mapped += 1
            clip = re.match(rb"(\d+)S", f[5])
            d = int(f[3]) - int(f[0].split(b"Pos=")[1])
            near_raw += abs(d) <= 50
            near += abs(d - (int(clip.group(1)) if clip else 0)) <= 50
    if near < 0.9 * n_all:
        raise AssertionError(f"only {near} of {n_all} PacBio reads within 50 bp of their position")
    total = {k: launches[k] + launches0[k] for k in PB_KERNELS}
    if total["kmer_funnel"] == 0 or total["fm_sensitive_scan"] == 0:
        raise AssertionError(f"a SensitiveMode kernel never launched on the PacBio path: {total}")
    # the mapping begins with the first group's pinned upload; what the device
    # ran before it is the set-up's (the tables' pageable uploads)
    first = next((k for k, sp in enumerate(spans) if "Pinned -> Device" in sp[2]), None)
    if first is None:
        raise AssertionError("the profile holds no pinned upload of a group")
    setup_busy = busy_seconds(spans[:first])[0] if first else 0.0
    busy_s, span_s = busy_seconds(spans[first:])
    by_name: dict = {}
    for t0, t1, name in spans[first:]:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + t1 - t0, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    # every SensitiveMode funnel call launches the evaluation (a tile at a time)
    seen = sum(n for k, (_, n) in by_name.items() if "funnel_eval_kernel" in k)
    whole = "" if seen >= launches["kmer_funnel"] else (
        f" PROFILE INCOMPLETE: {seen} funnel kernels seen for {launches['kmer_funnel']} calls;")
    print(f"phase 8 pacbio slice: {n_all} reads of 5-7 kb, -pacbio KART_SEED_MODE=device on the card")
    print(f"phase 8 reads/s: {n_all / map_s:.1f} (mapping {map_s:.3f} s); set-up {setup_s:.3f} s;"
          f" native mode: {n_all / nat_map:.1f} reads/s (mapping {nat_map:.3f} s, set-up"
          f" {nat_setup:.3f} s, CLI wall {nat_wall:.3f} s)")
    print(f"phase 8 groups {groups}; launches {launches}; flagged lanes {flagged}, re-seeded on the"
          f" card {on_dev}, on the host {on_host}; {per_group}; mapped {sens}%, POS within 50 bp of the"
          f" simulated position {near_raw}/{mapped}, with the leading soft clip taken off"
          f" {near}/{mapped}; SAM records equal to the native mode's; first"
          f" {PB_CPU_READS} reads: -cpu SAM records equal")
    print(f"phase 8 KART_KMER_GATE=0, first {PB_GATE0_READS} reads: groups {g0[0]}, launches"
          f" {launches0}, flagged {g0[1]}, mapping {map0:.3f} s, SAM records equal")
    print(f"phase 8 -backend python, first {PB_PY_READS} reads: {py_wall:.3f} s, launches"
          f" {launches_py}, SAM records equal; {re.search(r'# of NW fragments.*', log_py).group(0)}")
    print(f"phase 8 device busy (torch.profiler over run (a) again, mapping {prof_map:.3f} s):"
          f" {1e3 * busy_s:.3f} ms busy = {100 * busy_s / prof_map:.4f}% of the mapping time, within"
          f" {span_s:.3f} s from the first group's upload to the last device activity"
          f" (the set-up's uploads before it: {1e3 * setup_busy:.3f} ms);"
          f"{whole}"
          " device ms by name (launches): "
          + ", ".join(f"{short(k)} {us / 1e3:.3f} ({n})" for k, (us, n) in top))
    return total


N_I64_PAIRS, N_SAMPLED_CPU_PAIRS, PB_SAMPLED_READS = 10_000, 1000, 320
SAMPLED_KERNELS = ("sa_walk", "resolve_pack", "fm_seed_scan", "fm_sensitive_scan", "unpack_reads",
                   "kmer_funnel")


def fm_int64(fm):
    """The int64 twin of an FMIndexTensors on the card (the BWT words shared),
    without the full SA: the index an int64 GenomeIndex gives."""
    from kart_tpu_torch.ops.fm_search import FMIndexTensors

    return FMIndexTensors(occ_cp=fm.occ_cp.long(), bwt_words=fm.bwt_words,
                          sa_samples=fm.sa_samples.long(), L2=fm.L2.long(), primary=fm.primary,
                          seq_len=fm.seq_len)


def stream_rows(seeds, max_seeds: int, H: int):
    """The SA row of every slot of the resolved stream of a packed FM-stepper
    array (row 1 past the last fitting read), as expand_resolve walks them."""
    import torch

    from kart_tpu_torch.ops.resolve import expand_resolve_plain, seed_fields

    seen = []

    def lookup(rows):
        seen.append(rows)
        return rows, torch.ones_like(rows, dtype=torch.bool)

    o = seed_fields(seeds, max_seeds, False)
    expand_resolve_plain(lookup, o["n_seeds"], o["rpos"], o["slen"], o["k0"], o["freq"], o["ok"],
                         occ_budget=H)
    return seen[0].contiguous()


def walk_bound(fm, rows, steps, l2_load_ns: float) -> dict:
    """Bound of one sa_walk call: the rows in and (pos, done) out once, per
    step the checkpoint row and the block's eight BWT words (48 bytes, 64 on
    an int64 index) and per row its sample, the index read at most once
    whole; some 60 operations a step.  `chain_ms`: the longest walk's steps
    and its sample, each a dependent load that hits L2."""
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    n_steps, isz = int(steps.sum()), fm.occ_cp.element_size()
    index = fm.occ_cp.nbytes + fm.bwt_words.nbytes + fm.sa_samples.nbytes
    n_bytes = rows.numel() * (2 * isz + 1) + min((16 + 4 * isz) * n_steps + isz * rows.numel(),
                                                 index)
    t_b, by = bound_ms(n_bytes, 60 * n_steps)
    longest = int(steps.max())
    return dict(bound_ms=t_b, bound_by=by, chain_ms=(longest + 1) * l2_load_ns / 1e6,
                longest=longest, mean=float(steps.float().mean()), bytes=n_bytes)


def phase_sampled_kernels(gidx, pb: str, l2_load_ns: float) -> dict:
    """Phase 9's kernels against their plain versions on the card, byte-equal,
    timed by slope and per call with their bounds."""
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops.fm_search import (
        FMIndexTensors, sa_walk_plain, seed_scan_plain, sensitive_scan_plain,
    )
    from kart_tpu_torch.ops.pack import pack_reads_2bit
    from kart_tpu_torch.ops.resolve import resolve_pack_plain
    from kart_tpu_torch.pipeline.mapper import compute_min_seed_length
    from kart_tpu_torch.tools.bench_kernels import time_both

    msl = compute_min_seed_length(gidx.two_genome_size)
    fm = FMIndexTensors.from_genome_index(gidx, "cuda")
    fm64 = fm_int64(fm)
    sa32 = fm.sa_full.cuda()
    L, ms = L_MAX_GROUP, L_MAX_GROUP // (msl + 1) + 1
    lines, rec = [], {}

    def up(reads_i8, rlens):
        words, amb_r, amb_p = pack_reads_2bit(reads_i8)
        w, ar, ap = (torch.from_numpy(x).cuda() for x in (words.view(np.int32), amb_r, amb_p))
        return kernels.unpack_reads(w, ar, ap, l_max=reads_i8.shape[1]), torch.from_numpy(rlens).cuda()

    # the FastMode stepper at int64: phase 2's chunk shape (with short, all-N
    # and pad lanes), the re-seed layout, and phase 4's group
    rng = np.random.default_rng(29)
    fk = dict(max_seeds=ms, l_max=L)
    fm_cases = {}
    for name, (B, n) in (("B 4000", (B_FM, B_FM)), ("re-seed layout", RESEED_FM)):
        reads, rlens = fm_batch(gidx, rng, B, n, name == "B 4000")
        r, rl = torch.from_numpy(reads).cuda(), torch.from_numpy(rlens).cuda()
        got = kernels.fm_seed_scan(fm64, r, rl, msl, **fk)
        narrow = kernels.fm_seed_scan(fm, r, rl, msl, **fk)
        require_equal(got, seed_scan_plain(fm64, r, rl, msl, **fk), f"fm_seed_scan int64 ({name})")
        require_equal(got, narrow.long(), f"fm_seed_scan int64 against int32 widened ({name})")
        t64, t32 = time_both(lambda: kernels.fm_seed_scan(fm64, r, rl, msl, **fk)), time_both(
            lambda: kernels.fm_seed_scan(fm, r, rl, msl, **fk))
        fm_cases[name] = dict(t64=t64, t32=t32, plain=cuda_ms(
            lambda: seed_scan_plain(fm64, r, rl, msl, **fk), 1), seeds=int(got[:, 0].sum()))
        lines.append(f"fm_seed_scan int64 {name}: equal to the plain version and to int32 widened"
                     f" ({fm_cases[name]['seeds']} seeds); slope {1e3 * t64[0]:.4f} ms, per call"
                     f" {1e3 * t64[1]:.4f} ms (int32: slope {1e3 * t32[0]:.4f} ms, per call"
                     f" {1e3 * t32[1]:.4f} ms), plain {fm_cases[name]['plain']:.4f} ms")
    rec["fm_seed_scan_i64"] = fm_cases

    # phase 4's group of 32,000 reads, seeded by the FM stepper: its stream's
    # rows for the walk, and resolve_pack through the sampled SA
    B, H = B_GROUP, 3 * B_GROUP
    reads = group_reads(gidx, np.random.default_rng(13), B, L)
    ur, rl = up(reads, np.full(B, READ_LEN, np.int32))
    seeds = kernels.fm_seed_scan(fm, ur, rl, msl, **fk)
    seeds64 = seeds.long()
    Bb, nb = RESEED_FM
    rr, rrl = fm_batch(gidx, rng, Bb, nb, False)
    seeds_r = kernels.fm_seed_scan(fm, torch.from_numpy(rr).cuda(), torch.from_numpy(rrl).cuda(),
                                   msl, **fk)
    walks, walk_err = {}, 0
    for name, rows in (("group", stream_rows(seeds, ms, H)),
                       ("re-seed layout", stream_rows(seeds_r, ms, Bb * 64))):
        for dt, f in (("int32", fm), ("int64", fm64)):
            k = rows if dt == "int32" else rows.long()
            for steps_max in (4096, 8):
                st: dict = {}
                want = sa_walk_plain(f, k, max_steps=steps_max, stats=st)
                got = kernels.sa_walk(f, k, max_steps=steps_max)
                walk_err = max(walk_err, require_equal(
                    got[0], want[0], f"sa_walk pos ({name}, {dt}, max_steps {steps_max})"),
                    require_equal(got[1], want[1], f"sa_walk done ({name}, {dt}, max_steps {steps_max})"))
                if steps_max == 4096:
                    if not bool(want[1].all()):
                        raise AssertionError(f"sa_walk ({name}): a walk of 4,096 steps not done")
                    walks[(name, dt)] = dict(steps=st["steps"], rows=k, f=f)
                elif bool(want[1].all()):
                    raise AssertionError(f"sa_walk ({name}): max_steps 8 cut no walk")
    for (name, dt), wk in walks.items():
        k, f = wk["rows"], wk["f"]
        t = time_both(lambda: kernels.sa_walk(f, k))
        plain = cuda_ms(lambda: sa_walk_plain(f, k), 1)
        b = walk_bound(f, k, wk["steps"], l2_load_ns)
        wk.update(t=t, plain=plain, b=b)
        lines.append(f"sa_walk {name} {dt}: {k.numel()} rows, (pos, done) equal at max_steps 4096"
                     f" and 8; steps mean {b['mean']:.2f}, longest {b['longest']}; slope"
                     f" {1e3 * t[0]:.4f} ms, per call {1e3 * t[1]:.4f} ms, plain {plain:.4f} ms;"
                     f" {b['bytes']} bytes: bound {b['bound_ms']:.4f} ms ({b['bound_by']}); chain"
                     f" {b['longest'] + 1} loads x {l2_load_ns:.1f} ns = {b['chain_ms']:.4f} ms")
    rec["walks"], rec["walk_err"] = walks, walk_err

    # resolve_pack through the sampled SA: the group's pack16 stream (walks
    # whole, and cut at 8 steps so that reads are flagged) and its int64 tuple
    rk = dict(max_seeds=ms, has_ok=False, occ_budget=H)
    full16 = kernels.resolve_pack(sa32, seeds, pack16=True, **rk)
    res = {}
    for name, args, kw in (
            ("pack16", (None, seeds), dict(pack16=True, fm=fm)),
            ("pack16, max_steps 8", (None, seeds), dict(pack16=True, fm=fm, max_steps=8)),
            ("int64", (None, seeds64), dict(pack16=False, fm=fm64)),
            ("int64 full SA", (sa32.long(), seeds64), dict(pack16=False))):
        got = kernels.resolve_pack(*args, **rk, **kw)
        want = resolve_pack_plain(*args, **rk, **kw)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            require_equal(g, w, f"resolve_pack ({name})")
        if name == "pack16":
            require_equal(got, full16, "resolve_pack sampled against full SA (pack16)")
        if name == "int64":
            require_equal(got[2], full16[B // 2 + H // 2:].long(), "resolve_pack int64 positions")
            cnts = got[0]
        if name == "pack16, max_steps 8":
            cw = got[: B // 2].cpu().numpy().view(np.int16)
            flagged = int((cw < 0).sum())
            if flagged == 0:
                raise AssertionError("resolve_pack with max_steps 8 flagged no read")
        res[name] = dict(args=args, kw=kw)
    for name in ("pack16", "int64"):
        args, kw = res[name]["args"], res[name]["kw"]
        res[name].update(t=time_both(lambda: kernels.resolve_pack(*args, **rk, **kw)),
                         plain=cuda_ms(lambda: resolve_pack_plain(*args, **rk, **kw), 1))
    t_full = time_both(lambda: kernels.resolve_pack(sa32, seeds, pack16=True, **rk))
    n_occ = int((cnts.clamp(min=0)).sum())
    wb = walks[("group", "int32")]["b"]
    lines.append(f"resolve_pack sampled B={B} H={H}: pack16, and int64 (32-bit, tuple) and int64"
                 f" through the full SA equal their plain versions; the sampled streams equal the"
                 f" full SA's ({n_occ} occurrences); max_steps 8: {flagged} reads flagged, equal;"
                 f" pack16 slope {1e3 * res['pack16']['t'][0]:.4f} ms, per call"
                 f" {1e3 * res['pack16']['t'][1]:.4f} ms, plain {res['pack16']['plain']:.4f} ms;"
                 f" int64 slope {1e3 * res['int64']['t'][0]:.4f} ms, per call"
                 f" {1e3 * res['int64']['t'][1]:.4f} ms, plain {res['int64']['plain']:.4f} ms;"
                 f" through the full SA (pack16) slope {1e3 * t_full[0]:.4f} ms; the walk's chain"
                 f" {wb['chain_ms']:.4f} ms")
    rec["resolve"] = dict(res, t_full=t_full)

    # the SensitiveMode stepper at int64: phase 7's group
    codes_i8, rl8 = pad_batch(fastq_codes(pb, PB_B), PB_B, PB_L)
    cr, crl = up(codes_i8, rl8)
    kb = dict(max_seeds=PB_L // msl + 2, l_max=PB_L)
    got = kernels.fm_sensitive_scan(fm64, cr, crl, msl, **kb)
    require_equal(got, kernels.fm_sensitive_scan(fm, cr, crl, msl, **kb).long(),
                  "fm_sensitive_scan int64 against int32 widened")
    t0 = time.perf_counter()
    require_equal(got, sensitive_scan_plain(fm64, cr, crl, msl, **kb), "fm_sensitive_scan int64")
    plain_s = time.perf_counter() - t0
    reps = dict(reps=8, n_small=4, n_big=36)
    t64 = time_both(lambda: kernels.fm_sensitive_scan(fm64, cr, crl, msl, **kb), **reps)
    t32 = time_both(lambda: kernels.fm_sensitive_scan(fm, cr, crl, msl, **kb), **reps)
    lines.append(f"fm_sensitive_scan int64 B={PB_B} l_max={PB_L}: equal to the plain version (which"
                 f" took {plain_s:.1f} s of host wall time) and to int32 widened"
                 f" ({int(got[:, 0].sum())} seeds); slope {1e3 * t64[0]:.4f} ms, per call"
                 f" {1e3 * t64[1]:.4f} ms (int32: slope {1e3 * t32[0]:.4f} ms, per call"
                 f" {1e3 * t32[1]:.4f} ms)")
    rec["sens_i64"] = dict(t64=t64, t32=t32)
    for ln in lines:
        print("phase 9 " + ln)
    return rec


def walk_record(rec: dict) -> dict:
    """The kernels record's sa_walk entry: the group's int32 rows; the int64
    walk, the re-seed layout and resolve_pack's sampled and int64 times
    beside them."""
    w = rec["walks"][("group", "int32")]
    r = rec["resolve"]
    return dict(ms=1e3 * w["t"][0], plain_ms=w["plain"], err=rec["walk_err"], bound_ms=w["b"]["bound_ms"],
                bound_by=w["b"]["bound_by"], chain_ms=w["b"]["chain_ms"],
                shape=f"the stream rows of a {B_GROUP}-read group, H {3 * B_GROUP}, int32",
                int64=dict(ms=1e3 * rec["walks"][("group", "int64")]["t"][0],
                           bound_ms=rec["walks"][("group", "int64")]["b"]["bound_ms"]),
                reseed_layout=dict(ms=1e3 * rec["walks"][("re-seed layout", "int32")]["t"][0],
                                   shape=f"B {RESEED_FM[0]}, of which {RESEED_FM[1]} reads, H"
                                         f" {RESEED_FM[0] * 64}"),
                resolve_pack_sampled_ms=1e3 * r["pack16"]["t"][0],
                resolve_pack_int64_ms=1e3 * r["int64"]["t"][0],
                resolve_pack_full_ms=1e3 * r["t_full"][0],
                fm_seed_scan_int64_ms=1e3 * rec["fm_seed_scan_i64"]["B 4000"]["t64"][0],
                fm_sensitive_scan_int64_ms=1e3 * rec["sens_i64"]["t64"][0])


def phase_sampled_slice(prefix: str, pb: str, full_sam: str | None) -> dict:
    """Phase 9's sampled slice: KART_SA_MODE=sampled through the CLI in the
    device-pipelined mode on the card, the native mode, an int64 index, -cpu,
    and PacBio reads."""
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.index import loader
    from kart_tpu_torch.tools.bench_kernels import busy_seconds, device_spans

    r1, r2 = os.path.join(DATA, "dev_r1.fq"), os.path.join(DATA, "dev_r2.fq")
    if not os.path.exists(r2):
        simulate_pairs(os.path.join(DATA, "genome.fa"), r1, r2, N_DEV_PAIRS)
    sam = {k: os.path.join(DATA, f"sampled_{k}.sam")
           for k in ("dev", "nat", "i64", "cpu", "prof", "pb_dev", "pb_nat")}
    base = ["-i", prefix, "-silent"]

    def run(args, out):
        """One CLI run with the launch counts set to 0 just before it and
        read just after: (log, launches)."""
        for k in SAMPLED_KERNELS:
            getattr(kernels, k).launches = 0
        log = run_cli([*base, *args, "-o", out])
        torch.cuda.synchronize()
        return log, {k: getattr(kernels, k).launches for k in SAMPLED_KERNELS}

    def times(log):
        m = re.search(r"set-up ([\d.]+) s .*mapping ([\d.]+) s", log)
        return float(m.group(1)), float(m.group(2))

    def counts(log, dev):
        g = re.search(rf"groups on {dev} = (\d+), flagged lanes = (\d+), re-seeded on the device ="
                      r" (\d+), on the host = (\d+)", log)
        return tuple(int(x) for x in g.groups())

    pe = ["-f", r1, "-f2", r2]
    total = {k: 0 for k in SAMPLED_KERNELS}
    os.environ["KART_SA_MODE"] = "sampled"
    try:
        log_nat, _ = run(pe, sam["nat"])  # (b) the C++ FM seeder
        nat_setup, nat_map = times(log_nat)
        want = sam_records(sam["nat"])
        os.environ["KART_SEED_MODE"] = "device"
        try:
            log, launches = run(pe, sam["dev"])  # (a)
            setup_s, map_s = times(log)
            groups, flagged, on_dev, on_host = counts(log, "cuda")
            recs = sam_records(sam["dev"])
            if recs != want:
                raise AssertionError("sampled: the device-pipelined SAM differs from the native mode's")
            if full_sam is not None and recs != sam_records(full_sam):
                raise AssertionError("sampled: the device-pipelined SAM differs from phase 6's (full SA)")
            if launches["sa_walk"] == 0 or launches["resolve_pack"] == 0 or launches["fm_seed_scan"] == 0:
                raise AssertionError(f"sampled: a kernel of the path never launched: {launches}")
            if launches["kmer_funnel"] != 0:
                raise AssertionError(f"sampled: the funnel ran, so its tables were built: {launches}")
            # (c) the first pairs on an int64 index
            i1 = head_fastq(r1, os.path.join(DATA, "i64_r1.fq"), N_I64_PAIRS)
            i2 = head_fastq(r2, os.path.join(DATA, "i64_r2.fq"), N_I64_PAIRS)
            dtype = loader.GenomeIndex.index_dtype
            loader.GenomeIndex.index_dtype = property(lambda self: np.int64)
            try:
                log_i64, launches_i64 = run(["-f", i1, "-f2", i2], sam["i64"])
            finally:
                loader.GenomeIndex.index_dtype = dtype
            if sam_records(sam["i64"]) != want[: 2 * N_I64_PAIRS]:
                raise AssertionError("sampled: the int64 index's SAM differs from the native mode's")
            if launches_i64["sa_walk"] == 0:
                raise AssertionError(f"sampled int64: the walk never launched: {launches_i64}")
            # (d) the first pairs with -cpu (plain versions)
            c1 = head_fastq(r1, os.path.join(DATA, "sampled_r1_cpu.fq"), N_SAMPLED_CPU_PAIRS)
            c2 = head_fastq(r2, os.path.join(DATA, "sampled_r2_cpu.fq"), N_SAMPLED_CPU_PAIRS)
            run(["-f", c1, "-f2", c2, "-cpu"], sam["cpu"])
            if sam_records(sam["cpu"]) != want[: 2 * N_SAMPLED_CPU_PAIRS]:
                raise AssertionError("sampled: the -cpu SAM differs from the native mode's")
            # (e) PacBio reads
            pbh = head_fastq(pb, os.path.join(DATA, "pb_sampled.fq"), PB_SAMPLED_READS)
            log_pb, launches_pb = run(["-f", pbh, "-pacbio"], sam["pb_dev"])
            pb_map = times(log_pb)[1]
            # run (a) again under the profiler: the card's busy share
            prof_log: list = []
            spans = device_spans(lambda: prof_log.append(run_cli([*base, *pe, "-o", sam["prof"]])),
                                 warm=lambda: run_cli([*base, "-f", c1, "-f2", c2, "-o",
                                                       sam["cpu"] + ".warm"]))
            prof_map = times(prof_log[0])[1]
        finally:
            del os.environ["KART_SEED_MODE"]
        run(["-f", pbh, "-pacbio"], sam["pb_nat"])
        if sam_records(sam["pb_dev"]) != sam_records(sam["pb_nat"]):
            raise AssertionError("sampled PacBio: the device-pipelined SAM differs from the native mode's")
        if launches_pb["sa_walk"] == 0 or launches_pb["fm_sensitive_scan"] == 0:
            raise AssertionError(f"sampled PacBio: a kernel never launched: {launches_pb}")
    finally:
        del os.environ["KART_SA_MODE"]
    if sam_records(sam["prof"]) != recs:
        raise AssertionError("sampled: the profiled run's SAM differs")
    for lc in (launches, launches_i64, launches_pb):
        for k in SAMPLED_KERNELS:
            total[k] += lc[k]
    first = next((k for k, sp in enumerate(spans) if "Pinned -> Device" in sp[2]), None)
    if first is None:
        raise AssertionError("the profile holds no pinned upload of a group")
    busy_s, span_s = busy_seconds(spans[first:])
    by_name: dict = {}
    for t0, t1, name in spans[first:]:
        us, n = by_name.get(name, (0.0, 0))
        by_name[name] = (us + t1 - t0, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    n_reads = 2 * N_DEV_PAIRS
    print(f"phase 9 sampled slice: {n_reads} reads, KART_SA_MODE=sampled KART_SEED_MODE=device on the card")
    print(f"phase 9 reads/s: {n_reads / map_s:.1f} (mapping {map_s:.3f} s); set-up {setup_s:.3f} s;"
          f" native mode, sampled: {n_reads / nat_map:.1f} reads/s (mapping {nat_map:.3f} s, set-up"
          f" {nat_setup:.3f} s)")
    print(f"phase 9 groups {groups}; launches {launches}; flagged lanes {flagged}, re-seeded on the"
          f" card {on_dev}, on the host {on_host}; SAM records equal to the native mode's"
          + ("" if full_sam is None else " and to phase 6's (full SA)")
          + f"; int64 index, first {N_I64_PAIRS} pairs: launches {launches_i64}, mapping"
          f" {times(log_i64)[1]:.3f} s, SAM records equal; first {N_SAMPLED_CPU_PAIRS} pairs:"
          f" -cpu SAM records equal")
    print(f"phase 9 PacBio, first {PB_SAMPLED_READS} reads, -pacbio sampled: launches {launches_pb},"
          f" mapping {pb_map:.3f} s, SAM records equal to the native mode's")
    print(f"phase 9 device busy (torch.profiler over run (a) again, mapping {prof_map:.3f} s):"
          f" {1e3 * busy_s:.3f} ms busy = {100 * busy_s / prof_map:.4f}% of the mapping time, within"
          f" {span_s:.3f} s; device ms by name (launches): "
          + ", ".join(f"{short(k)} {us / 1e3:.3f} ({n})" for k, (us, n) in top))
    return total


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="DIR", default=None,
                    help="a checkout of another commit whose NW, FM stepper, funnel and"
                         " resolve_pack phases 1, 2 and 4, and whose SensitiveMode funnel and FM"
                         " stepper phase 7, time beside this one's")
    ap.add_argument("--phases", metavar="LIST", default=None,
                    help="run only these phases beside phase 0 and the set-up, e.g. 7,8 (a partial"
                         " run prints no kernels record and no result line, and exits 4)")
    args = ap.parse_args(argv)
    only = None if args.phases is None else {int(x) for x in args.phases.split(",")}

    def want(n: int) -> bool:
        return only is None or n in only
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
    entry_fn = ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry_fn = ln
        elif "spill" in ln and "nw_planes" in entry_fn and "0 bytes spill stores, 0 bytes spill loads" not in ln:
            raise AssertionError(f"an NW kernel spills: {entry_fn} {ln}")
    print(
        f"phase 0 device: {name} ({smi}); torch {torch.__version__} cuda {torch.version.cuda};"
        f" kernels built in {time.perf_counter() - t0:.1f} s; ptxas: {ptxas or 'up to date'}"
    )

    other = None
    if args.compare is not None:
        from kart_tpu_torch.tools.bench_kernels import load_kernels_module

        other = load_kernels_module(os.path.join(args.compare, "kart_tpu_torch", "kernels.py"),
                                    "kart_tpu_torch_compared_kernels")
        other.build()
    if want(1):
        nw = phase_nw(np.random.default_rng(2024), other)
    t0 = time.perf_counter()
    prefix = build_genome_index()
    gidx = load_index(prefix)
    print(f"setup: genome {gidx.genome_size} bp indexed and loaded in {time.perf_counter() - t0:.1f} s")
    if want(2):
        fm = phase_fm(gidx, other)
    else:
        from kart_tpu_torch.tools.bench_kernels import dependent_load_ns

        fm = dict(l2_ns=dependent_load_ns(working_set_bytes=3 * gidx.seq_len // 8))
    from kart_tpu_torch.ops.kmer_seed import build_tables
    from kart_tpu_torch.tools import simdata

    t0 = time.perf_counter()
    tb = build_tables(gidx)  # and its .kmt sidecar, which the CLI runs load
    print(f"setup: funnel tables built or loaded in {time.perf_counter() - t0:.1f} s"
          f" (max 13-mer multiplicity {tb.max_mult})")
    if want(3):
        slice3 = phase_slice(prefix, gidx, fm["l2_ns"])
    if want(4):
        funnel = phase_funnel(gidx, tb, other, fm["l2_ns"])
    del tb
    if want(5):
        gather = phase_gather()
    if want(6):
        dev_launches = phase_device_slice(prefix)
    t0 = time.perf_counter()
    pb = os.path.join(DATA, "pb.fq")
    simdata.simulate_pacbio_reads(simdata.read_genome_fasta(os.path.join(DATA, "genome.fa")), pb)
    print(f"setup: {simdata.PB_N_READS} PacBio reads simulated in {time.perf_counter() - t0:.1f} s")
    if want(7):
        sens = phase_sensitive(gidx, build_tables(gidx), pb, fm["l2_ns"], other)
    if want(8):
        pb_launches = phase_pacbio_slice(prefix, pb)
    if want(9):
        sampled = phase_sampled_kernels(gidx, pb, fm["l2_ns"])
        sampled_launches = phase_sampled_slice(
            prefix, pb, os.path.join(DATA, "dev.sam") if want(6) else None)
    loaded = sorted(m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in ("jax", "kart_tpu", "bench"))
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    if only is not None:
        print(f"partial run (phases {sorted(only)}): no kernels record, no result")
        return 4

    def entry(name, source, replaces, n_launches, r, library_ms=None):
        # shape, reseed_layout: what a record's times refer to, where phase lines alone do not say
        extra = {k: r[k] for k in ("shape", "reseed_layout", "chain_ms", "chain_steps",
                                   "design_chain_ms",
                                   "slab_paths", "int64", "resolve_pack_sampled_ms",
                                   "resolve_pack_int64_ms", "resolve_pack_full_ms",
                                   "fm_seed_scan_int64_ms", "fm_sensitive_scan_int64_ms")
                 if k in r}
        return dict(name=name, route="cuda", source=f"kart_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=n_launches, max_abs_err=r["err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=library_ms, **extra)

    fm["err"] = max(fm["err"], funnel["fm_err"])
    # library_ms: table[rid] for the row gather; no one PyTorch call computes
    # an FM backward search (windowed or not), an NW traceback plane, the
    # funnel's rounds in either mode, the budgeted expansion into a packed
    # stream, the 2-bit unpack, an inverse-Psi walk, a clustering whose
    # breaks and threshold run in order along the seeds, or a mate choice
    # that steals in order along the candidates
    launches, launches_b = slice3["launches"], slice3["launches_b"]
    record = {"kernels": [
        entry("fm_seed_scan", "fm_seed_scan.cu", "kart_tpu/ops/fm_search.py:165",
              launches["fm_seed_scan"] + dev_launches["fm_seed_scan"]
              + sampled_launches["fm_seed_scan"], fm),
        entry("nw_planes", "nw.cu", "kart_tpu/ops/nw.py:55 and kart_tpu/ops/nw.py:160",
              launches["nw_planes"], nw),
        entry("kmer_funnel", "kmer_funnel.cu",
              "kart_tpu/ops/kmer_seed.py:272 and kart_tpu/ops/pack.py:98",
              dev_launches["kmer_funnel"] + launches["kmer_funnel"], funnel["funnel"]),
        entry("kmer_funnel_sensitive", "kmer_funnel.cu",
              "kart_tpu/ops/kmer_seed.py:327 (sensitive=True) and kart_tpu/ops/pack.py:98",
              pb_launches["kmer_funnel"], sens["funnel"]),
        entry("fm_sensitive_scan", "fm_seed_scan.cu", "kart_tpu/ops/fm_search.py:287",
              pb_launches["fm_sensitive_scan"] + sampled_launches["fm_sensitive_scan"], sens["fm"]),
        entry("resolve_pack", "resolve_pack.cu",
              "kart_tpu/ops/resolve.py:47 and kart_tpu/ops/pack.py:161",
              dev_launches["resolve_pack"] + pb_launches["resolve_pack"]
              + sampled_launches["resolve_pack"], funnel["resolve"]),
        entry("unpack_reads", "kmer_funnel.cu", "kart_tpu/ops/pack.py:98",
              dev_launches["unpack_reads"] + pb_launches["unpack_reads"]
              + sampled_launches["unpack_reads"], funnel["unpack"]),
        entry("sa_walk", "sa_walk.cu", "kart_tpu/ops/fm_search.py:420",
              sampled_launches["sa_walk"], walk_record(sampled)),
        entry("row_gather", "row_gather.cu", "tools/bench_gather.py:208", gather["launches"],
              gather, gather["library_ms"]),
        entry("cluster_illumina", "cluster.cu", "kart_tpu/ops/cluster.py:27",
              launches_b["cluster_illumina"], slice3["cluster"]),
        entry("pair_candidates", "pairing.cu", "kart_tpu/ops/pairing.py:22",
              launches_b["pair_candidates"], slice3["pair"]),
    ]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
