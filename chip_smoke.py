"""Smoke run of the PyTorch/CUDA port (kart_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repository root
    python3 chip_smoke.py --phases 9      # phase 0, the set-up and phase 9 only (exit 4)
    python3 chip_smoke.py --phases 13     # the bench and the smoke test, each in its own process
    python3 chip_smoke.py --compare DIR   # also time DIR/kart_tpu_torch's NW, FM stepper,
                                          # clustering, mating, funnel, resolve_pack,
                                          # SensitiveMode kernels, walk, cross-device scan,
                                          # resident walk and resolve, F and the candidate
                                          # tail (another
                                          # commit's, unpacked with git archive into a
                                          # directory of this checkout)

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
     the keys read where they lie (L1) against staged in shared memory
     (CLUSTER_KEYS_PROBE, also on 9,000 keys), with --compare the other
     build's two kernels in turns with these, and the host seconds of their
     wrappers beside the host's own clustering and mating on the first chunk;
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
     walk with its bound, its chain and its ns a step beside the L2 load
     (with --compare, the other commit's walk in turns on the group's and
     the re-seed layout's rows, int32 and int64).  Then the sampled slice
     through the CLI
     with KART_SA_MODE=sampled: (a) phase 6's 100,000 pairs device-pipelined
     on the card, (b) the native mode, (c) the first 10,000 pairs on an
     index forced to int64, (d) the first 1,000 pairs with -cpu, (e) the
     first 320 PacBio reads with -pacbio, device-pipelined and native: (a),
     (c) and (d) equal (b)'s SAM records, (a) equals phase 6's, (e) its
     native run's; reads/s, set-up, launches (sa_walk on the path, the
     funnel never), flagged lanes and the card's busy share of (a).
 10. the port's tools (kart_tpu_torch/tools): (a) profile_device's stage
     table of one group of phase 6's reads (8 chunks, B 32,000, l_max 160)
     for the funnel, the FM stepper (KART_KMER_GATE=0) and the FM stepper
     with the sampled SA (KART_SA_MODE=sampled), the scan and scan+resolve
     timed by slope over CUDA graphs, the copies by event windows, each
     profiled stream equal to the mapper's own dispatch of the group (the
     tables are loaded from the .kmt sidecar that phase 6's run loads); (b)
     analyze_trace's top 10 device ops of one funnel group (3 reps under
     torch.profiler, the tool's command in a process of its own, once)
     beside (a)'s scan_resolve_dev; (c) simulate_reads' 2,000
     pairs of 125 bp on the bench genome (err 0.015, mut 0.002, seed 99, as
     tests/test_accuracy.py) mapped with KART_SEED_MODE=device on the card and
     with -cpu: evaluate_sam's two score dicts must be equal.
 11. the sharded index (-idx-shards; kart_tpu_torch/parallel/), all shards
     on cuda:0, int32 and int64, at 1, 2 and 4 shards, every kernel
     byte-equal to its plain version: (a) the resident scan (the whole
     FastMode scan in one launch through the shard table) of 16,000 of phase
     6's reads (l_max 160), also equal to fm_seed_scan and to the
     cross-device loop with the shards split into two groups, in which G1
     (the table occ4, whole-device and each group) and the fused step (the
     stepping group's occ4, the other group's part, the scan step: G2) are
     held at step 40, the fused step byte-equal to its plain composition, and
     whose launches a step are counted (one G1 a group past the first and the
     fused step: 2 in two groups); the resident walk of phase 4's 96,000 stream rows, also
     equal to sa_walk and sa_walk_plain, whole and cut at 8 steps, and to the
     cross-device walk; G3 (the table inverse-Psi step, whole-device and each
     group) at the rows and after 10 steps; G4 (the table gather, whole-
     device and each group, full SA and samples); the resolved stream (full:
     resident through the table, with no G4 launch, and in two groups;
     sampled) equal to resolve_pack's; each kernel timed by slope at 2
     shards with its bound (bytes by distinct 32-byte sector) and chain,
     beside the whole scan and walk per call at 1, 2 and 4 shards, resident
     and cross-device; G4 at 4 shards, and int64 with its owner by the
     two-step reciprocal against a 64-bit division; the resident full-SA
     resolve at 2 and 4 shards against resolve_pack on the flat full SA
     (with --compare, the cross-device scan at 2 shards in two groups, the
     resident walk at 2 shards, and the resolve, sharded_seed_scan_resolved
     less the resident scan, in turns with the other commit's); (b) the CLI (native
     backend, the python reader) with -idx-shards 2 and 4, the shards where
     default_shard_devices puts them (all on cuda:0 of one card), over phase
     6's 200,000 reads, full SA and KART_SA_MODE=sampled: one resident scan a sharded
     call (and one resident walk in the sampled runs), no G1, G2, G3 or G4
     launch; then 2 shards split into two groups, sampled (the cross-device
     path: G1, the fused step as many times as G1, G3, G4 and no resident
     launch); SAM records equal to the
     native mode's; reads/s, set-up, launches, flagged lanes; (c) two
     processes on cuda:0 (the gloo group of init_distributed, an all_gather,
     the TCP stat relay, map_shard with 2 shards each) over 16,000 pairs:
     merged records equal to a single process's.
 12. the multi-device front half (kart_tpu_torch/parallel/dp.py), every mesh
     position on cuda:0: (a) F, the PosDiff sort (csrc/sorted_occ.cu),
     byte-equal to its plain version on the resolved stream of phase 6's
     first 32,000 reads (16,000 pairs, mate 2 reverse-complemented as the
     reader loads it; budget 128,000, s_occ 16; int32 and
     the int64 copy, equal to each other) and on tools/simdata's edge
     streams (a flagged read's entries, slen 32768, reads past s_occ, past
     H, ties, invalid slots), timed by slope with its bound counted from the
     stream's own entries, its launches a call by torch.profiler (one kernel,
     no memset); with --compare, the other commit's F in turns and, where it
     is the two-launch design, each of its launches alone by slope; H, the
     candidate tail (csrc/cluster.cu's kart_candidate_tail: clustering, the
     glue and mating in one launch) against candidate_tail_plain on F's
     int32 and int64 outputs of those reads and on tools/simdata's edges,
     timed by slope with its bound beside the plain version and the eager
     composition (the glue's torch ops around cluster_illumina and
     pair_candidates), split by phase with clock64 (TAIL_STAMP_PROBE), the
     device kernels of one block from F on by torch.profiler in a process
     of its own (F and the tail), cluster_illumina and pair_candidates
     alone at this block's shape;
     with --compare, the other build's tail (its own kernel, or its eager
     composition) and its two kernels in turns with this one's; (b)
     make_full_mapping_step on
     those reads over five meshes (data 1 full SA, data 4, data 2 sampled,
     data x idx 2 x 2 full and sampled): data 1 equal to the plain
     composition of the same step on the card (which launches no kernel),
     every other mesh's per-read streams, clusters and mates equal to data
     1's; ms a step (event window), reads/s, flagged reads (those over the
     budget, which must be a suffix of each block, and those of a cut walk)
     and the launches of each kernel (candidate_tail once a block,
     cluster_illumina and pair_candidates never); (c) graft_entry's dry run on [cuda:0] * 4,
     entry() equal to its CPU run, and bench_scaling's lines (one card: the
     mesh positions share it, so they measure overhead, not scaling).
 13. the port's bench and smoke test, each in a process of its own: (a)
     python -m kart_tpu_torch.tools.bench on phase 6's genome, index and
     100,000 pairs and phase 8's PacBio reads (bench.py's data): its three
     lines in bench.py's order, each with a value and phase 0's nvidia-smi
     line as its device, and the funnel and resolve_pack launched in its
     timed device passes; (b) bash kart_tpu_torch/run_test.sh (its own
     index of the seed-7 uniform genome, whose .bwt must be 4,639,752
     bytes, 1,000 simulated pairs mapped in the native mode and scored by
     the evaluator, and mapped again with KART_SEED_MODE=device on the
     card: the same SAM bytes).
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
T_START = time.monotonic()
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


def compare_turns(name: str, theirs, ours) -> list[float]:
    """Times of another build's call and this build's on the same inputs, in
    turns (other, this, this, other), by slope and per call; returns the
    slopes in ms."""
    from kart_tpu_torch.tools.bench_kernels import time_both

    t = [time_both(theirs), time_both(ours), time_both(ours), time_both(theirs)]
    print(f"compare {name}: other, this, this, other: slope ms "
          + ", ".join(f"{1e3 * a:.4f}" for a, _ in t) + "; per call ms "
          + ", ".join(f"{1e3 * b:.4f}" for _, b in t))
    return [1e3 * a for a, _ in t]


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


def phase_slice(prefix: str, gidx, l2_load_ns: float, other=None) -> dict:
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
    cl_edges = cluster_edges(rng, cl_args)
    for what, args in {f"chunk B {cl_args[1].shape[0]} S {S}": cl_args, **cl_edges}.items():
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
    # where the chromosome keys are read best: L1 (the kernel) or shared memory
    keys_ms = keys_placement_times({f"the chunk's {cl_args[0].numel()} keys": cl_args,
                                    "9,000 keys, S 100": cl_edges["9,000 keys, S 100"]}, mg)
    cluster["keys_ms"] = keys_ms
    if other is not None:
        cluster["compare_ms"] = compare_turns(
            f"cluster_illumina phase 3 chunk (B {B}, S {S})",
            lambda: other.cluster_illumina(*cl_args, mg, max_seeds=S),
            lambda: kernels.cluster_illumina(*cl_args, mg, max_seeds=S))
        pair["compare_ms"] = compare_turns(
            f"pair_candidates phase 3 chunk (P {P}, C1 {C1}, C2 {C2})",
            lambda: other.pair_candidates(*pr_args), lambda: kernels.pair_candidates(*pr_args))

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
        f" gen_candidates_illumina {t_hc:.4f} s; the keys read from L1 (the kernel) against"
        f" staged in shared memory, slope ms: "
        + "; ".join(f"{k}: {a:.4f} against {b:.4f}" for k, (a, b) in keys_ms.items())
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


# This build's clustering with the chromosome keys staged in shared memory
# (launch_cluster<true>), beside the kernel's reads from L1
CLUSTER_KEYS_PROBE = """#include "%s"
extern "C" int kart_probe_cluster_smem_keys(const void* chr_keys, int K, const void* pd,
                                            const void* gp, const void* ln, const void* n_seeds,
                                            const void* thr0, int max_gaps, int B, int S,
                                            void* cluster_id, void* accept, void* scores,
                                            void* stream) {
  return launch_cluster<true>(chr_keys, K, pd, gp, ln, n_seeds, thr0, max_gaps, B, S, cluster_id,
                              accept, scores, static_cast<cudaStream_t>(stream));
}
"""


def keys_placement_times(cases: dict, max_gaps: int) -> dict:
    """name -> (slope ms of kernels.cluster_illumina, which reads the keys
    where they lie (L1), slope ms with the keys staged in shared memory
    (CLUSTER_KEYS_PROBE)), each byte-equal to the plain version."""
    import ctypes

    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops import cluster as ops_cluster
    from kart_tpu_torch.tools.bench_kernels import time_both

    lib = probe_library("probe_cluster_keys", CLUSTER_KEYS_PROBE % os.path.join(
        ROOT, "kart_tpu_torch", "csrc", "cluster.cu"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kart_probe_cluster_smem_keys.argtypes = [p, i, p, p, p, p, p, i, i, i, p, p, p, p]
    out = {}
    for name, args in cases.items():
        keys, pd = args[0], args[1]
        B, S = pd.shape
        res = [torch.empty((B, S), dtype=dt, device=pd.device)
               for dt in (torch.int32, torch.bool, torch.int32)]

        def staged(args=args, res=res, B=B, S=S):
            if lib.kart_probe_cluster_smem_keys(
                    args[0].data_ptr(), args[0].numel(), *(a.data_ptr() for a in args[1:]),
                    max_gaps, B, S, *(r.data_ptr() for r in res),
                    torch.cuda.current_stream(pd.device).cuda_stream):
                raise RuntimeError("the cluster keys probe failed to launch")

        staged()
        for g, w, nm in zip(res, ops_cluster.cluster_illumina_plain(*args, max_gaps, max_seeds=S),
                            ("cluster_id", "accept", "scores")):
            require_equal(g, w, f"cluster_illumina with staged keys, {nm}, {name}")
        out[name] = (1e3 * time_both(lambda: kernels.cluster_illumina(*args, max_gaps,
                                                                      max_seeds=S))[0],
                     1e3 * time_both(staged)[0])
    return out


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
        # run (a) again under the profiler: the card's busy share (a lost
        # record would only shrink it, so the session need not hold every launch)
        cpu_fq = os.path.join(DATA, "pb_cpu.fq")
        prof_log: list = []
        spans = device_spans(lambda: prof_log.append(run_cli([*base, "-f", pb, "-o", sam["prof"]])),
                             warm=lambda: run_cli([*base, "-f", cpu_fq, "-o", sam["cpu"] + ".warm"]),
                             exact=False)
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


def phase_sampled_kernels(gidx, pb: str, l2_load_ns: float, other=None) -> dict:
    """Phase 9's kernels against their plain versions on the card, byte-equal,
    timed by slope and per call with their bounds, the walk also in ns a
    step; with `other` (another build's kernels module), its walk in turns
    with this build's."""
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
        wk["ns_a_step"] = 1e9 * t[0] / (b["longest"] + 1)
        lines.append(f"sa_walk {name} {dt}: {k.numel()} rows, (pos, done) equal at max_steps 4096"
                     f" and 8; steps mean {b['mean']:.2f}, longest {b['longest']}; slope"
                     f" {1e3 * t[0]:.4f} ms, per call {1e3 * t[1]:.4f} ms, plain {plain:.4f} ms;"
                     f" {wk['ns_a_step']:.1f} ns a step beside a dependent load that hits L2 of"
                     f" {l2_load_ns:.1f} ns; {b['bytes']} bytes: bound {b['bound_ms']:.4f} ms"
                     f" ({b['bound_by']}); chain {b['longest'] + 1} loads x {l2_load_ns:.1f} ns ="
                     f" {b['chain_ms']:.4f} ms")
        if other is not None:
            require_equal(other.sa_walk(f, k)[0], kernels.sa_walk(f, k)[0],
                          f"sa_walk of the compared build ({name}, {dt})")
            compare_turns(f"sa_walk {name} {dt} ({k.numel()} rows)", lambda: other.sa_walk(f, k),
                          lambda: kernels.sa_walk(f, k))
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
                bound_by=w["b"]["bound_by"], chain_ms=w["b"]["chain_ms"], ns_a_step=w["ns_a_step"],
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
            # run (a) again under the profiler: the card's busy share (not exact,
            # as in phase 8)
            prof_log: list = []
            spans = device_spans(lambda: prof_log.append(run_cli([*base, *pe, "-o", sam["prof"]])),
                                 warm=lambda: run_cli([*base, "-f", c1, "-f2", c2, "-o",
                                                       sam["cpu"] + ".warm"]), exact=False)
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


PROFILE_ENGINES = ("kmer", "fm", "fm_sampled")
PROFILE_GROUP, PROFILE_REPS, TRACE_REPS, TRACE_TOP = 8, 5, 3, 10
ACC_PAIRS = 2000  # phase 10's accuracy reads, with tests/test_accuracy.py's settings


def phase_tools(gidx, prefix: str) -> dict:
    """Phase 10: the port's tools on the card.  (a) profile_device's stage
    table of one group of phase 6's reads for each engine; (b) analyze_trace's
    top device ops of one funnel group beside (a)'s scan_resolve_dev; (c)
    simulate_reads' pairs mapped device-pipelined on the card and with -cpu,
    scored by evaluate_sam: equal dicts."""
    import shutil

    import torch

    from kart_tpu_torch.tools import analyze_trace, evaluate_sam, profile_device, simulate_reads

    r1, r2 = os.path.join(DATA, "dev_r1.fq"), os.path.join(DATA, "dev_r2.fq")
    if not os.path.exists(r2):
        simulate_pairs(os.path.join(DATA, "genome.fa"), r1, r2, N_DEV_PAIRS)
    reports = {}
    for engine in PROFILE_ENGINES:
        t0 = time.perf_counter()
        mapper = profile_device.make_mapper(gidx, engine, "cuda")
        setup = time.perf_counter() - t0
        rep, _ = profile_device.profile(mapper, r1, r2, group=PROFILE_GROUP, reps=PROFILE_REPS)
        der, st = rep["derived"], rep["stages_s"]
        if (der["B"], der["l_max"]) != (PROFILE_GROUP * 4000, L_MAX_GROUP):
            raise AssertionError(f"profile_device {engine}: B {der['B']} l_max {der['l_max']}")
        if any(st[k] is None or rep["timing"][k] not in ("slope", "window")
               for k in ("h2d_words", "scan_dev", "scan_resolve_dev", "d2h_stream")):
            raise AssertionError(f"profile_device {engine}: a device stage was not timed on the"
                                 f" card: {rep['timing']}")
        with open(os.path.join(DATA, f"profile_{engine}.json"), "w") as f:
            json.dump(rep, f, indent=1)
        reports[engine] = rep
        print(f"phase 10 profile_device {engine} ({der['engine']}), B {der['B']} l_max"
              f" {der['l_max']}, mapper set-up {setup:.3f} s: "
              + ", ".join(f"{k} {1e3 * v:.4f} ms ({rep['timing'][k]})" for k, v in st.items())
              + f"; per read {1e6 * st['group_serial'] / der['B']:.4f} us serial;"
              f" flagged {der['flagged_lanes']}, re-seeded on the card {der['reseeded_device']};"
              f" upload {der['upload_bytes']} bytes, stream {der['stream_bytes']} bytes;"
              f" scan+resolve window"
              f" {1e3 * der['scan_resolve_dev_window_s']:.4f} ms; the stream equals the"
              f" mapper's own")
        del mapper
        torch.cuda.empty_cache()

    # (b) one funnel group under torch.profiler, 3 reps, by the tool's own
    # command in a process of its own, once; device_trace refuses a trace
    # that lost the device's records (PERF.md, section 7)
    trace_dir = os.path.join(DATA, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "kart_tpu_torch.tools.analyze_trace", "--top", str(TRACE_TOP),
           "--reps", str(TRACE_REPS), "--dir", trace_dir, "--group", str(PROFILE_GROUP),
           "--index", prefix, "--reads", r1, r2]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"analyze_trace exited {proc.returncode}: {proc.stderr[-2000:]}")
    with contextlib.redirect_stdout(io.StringIO()):
        top = analyze_trace.analyze(trace_dir, TRACE_TOP, TRACE_REPS)
    funnel = [n for name, n, _, _ in (top or {"rows": ()})["rows"] if "funnel" in name]
    if funnel != [TRACE_REPS]:
        raise AssertionError(f"analyze_trace: funnel kernel calls {funnel} in the trace, not"
                             f" [{TRACE_REPS}]: {top}")
    sr, reps = reports["kmer"]["stages_s"]["scan_resolve_dev"], TRACE_REPS
    print(f"phase 10 analyze_trace, one funnel group x {reps} (its own process): {top['events']}"
          f" events, device"
          f" {top['device_us'] / reps:.2f} us a rep (busy {top['busy_us'] / reps:.2f}) beside (a)'s"
          f" kmer scan_resolve_dev {1e6 * sr:.2f} us by slope; top {TRACE_TOP} (us a rep, calls): "
          + "; ".join(f"{name.replace('(anonymous namespace)::', '').split('(')[0]} {per:.2f}"
                      f" ({n})" for name, n, _, per in top["rows"]))

    # (c) accuracy: the wgsim-equivalent reads scored against their truth
    fa = os.path.join(DATA, "genome.fa")
    a1, a2 = os.path.join(DATA, "acc_r1.fq"), os.path.join(DATA, "acc_r2.fq")
    t0 = time.perf_counter()
    simulate_reads.simulate(fa, a1, a2, n_reads=2 * ACC_PAIRS, read_len=125, err=0.015,
                            mut=0.002, seed=99)
    t_sim = time.perf_counter() - t0
    scores = {}
    with environ(KART_SEED_MODE="device"):
        for tag, extra in (("device", []), ("cpu", ["-cpu"])):
            sam = os.path.join(DATA, f"acc_{tag}.sam")
            run_cli(["-i", prefix, "-f", a1, "-f2", a2, "-o", sam, "-silent", *extra])
            with contextlib.redirect_stderr(io.StringIO()):
                scores[tag] = evaluate_sam.evaluate(sam)
    if scores["device"] != scores["cpu"]:
        raise AssertionError(f"evaluate_sam: device {scores['device']} != -cpu {scores['cpu']}")
    if scores["device"]["reads"] != ACC_PAIRS or scores["device"]["mapped"] == 0:
        raise AssertionError(f"evaluate_sam: {scores['device']}")
    print(f"phase 10 accuracy: {ACC_PAIRS} pairs of 125 bp (simulate_reads, err 0.015, mut 0.002,"
          f" seed 99; {t_sim:.1f} s), KART_SEED_MODE=device on the card {scores['device']},"
          f" -cpu {scores['cpu']}: equal")
    return dict(reports=reports, top=top, scores=scores)


SHARD_COUNTS = (1, 2, 4)  # shards of phase 11, all on cuda:0
SHARD_B = 16000  # a sharded call of the mapper: four reader chunks
SHARD_SNAP = 40  # the scan step whose G1 and G2 launches are held against their plain versions
SHARD_TIMED = 2  # the shard count whose kernels are timed
SHARD_MH_PAIRS = 16000  # (c): eight reader chunks, past the 1,000-pair threshold
RESIDENT_KERNELS = ("sharded_seed_scan", "sharded_sa_walk")
STEP_KERNELS = ("sharded_occ4", "sharded_fused_step", "sharded_inv_psi")
SHARDED_KERNELS = RESIDENT_KERNELS + STEP_KERNELS + ("sharded_gather", "resolve_pack")


def sectors(offsets) -> int:
    """The distinct 32-byte sectors that the byte offsets fall in."""
    import torch

    return int(torch.unique(offsets >> 5).numel())


def sharded_bounds(sfm, kind: str, rows, touched: int, l2_load_ns: float) -> dict:
    """Bound of one whole-device launch of G1, G3 or G4:
    the rows in and the results out once, and `touched`, the index bytes
    the launch reads: each distinct 32-byte sector of the BWT words,
    checkpoint rows (G1, G3) or slab rows (G4) it loads, once
    (`touched_bytes`); G3 also reads and writes the step count of each row
    not at a sample.  Some 60 operations a row (G1, G3: the popcounts), 4 a
    row (G4).  `chain_ms`: the dependent loads of one row: k, then the block
    (G1, G3: two, the table read in shared memory beside them), the slab row
    (G4: two)."""
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    isz = sfm.L2.element_size()
    n = rows.numel()
    if kind == "occ4":
        n_bytes, ops = n * isz + 4 * n * isz + touched, 60 * n
    elif kind == "inv_psi":
        n_steps = int(((rows & 31) != 0).sum())
        n_bytes, ops = 2 * n * isz + 8 * n_steps + touched, 60 * n
    else:  # the gather
        n_bytes, ops = 2 * n * isz + touched, 4 * n
    t_b, by = bound_ms(n_bytes, ops)
    return dict(bound_ms=t_b, bound_by=by, bytes=n_bytes, chain_ms=2 * l2_load_ns / 1e6)


def fused_step_bound(sfm, own, k, n_parts: int, l2_load_ns: float) -> dict:
    """Bound of one fused step of B lanes (k, (2B,) rows): the rows in, the
    stepping group's index sectors that its rows' blocks touch, once
    (`touched_bytes` of the rows it owns), the n_parts parts ((2B, 4) each),
    one column of codes and the read lengths, the state in and out, the next
    rows and the seed counts out; some 60 operations a row (occ4's
    popcounts) and 40 a lane (the step).  `chain_ms`: k, then the block (two
    dependent loads; the parts load beside the block)."""
    import torch

    from kart_tpu_torch.tools.bench_kernels import bound_ms

    isz = sfm.L2.element_size()
    B = k.numel() // 2
    kk = k - (k >= sfm.primary).to(k.dtype)
    mine = torch.isin((kk >> 7) // sfm.nb_local,
                      torch.tensor([s.index for s in own], dtype=k.dtype, device=k.device))
    n_bytes = (2 * B * isz + touched_bytes(sfm, "occ4", k[mine]) + n_parts * 2 * B * 4 * isz
               + 2 * B * 4 + 2 * (3 * B * 4 + 3 * B * isz) + 2 * B * isz + B * isz)
    t_b, by = bound_ms(n_bytes, 60 * 2 * B + 40 * B)
    return dict(bound_ms=t_b, bound_by=by, bytes=n_bytes, chain_ms=2 * l2_load_ns / 1e6)


def touched_bytes(sfm, kind: str, rows) -> int:
    """The index bytes that a whole-device launch of G1 (kind occ4), G3
    (inv_psi) or G4 (gather, full SA) reads for `rows`: 32 bytes for each
    distinct sector of the rows' blocks (eight BWT words, a sector each) and
    checkpoint rows (16 or 32 bytes), or of each slab's rows.  G3 loads
    nothing for a row at a sample."""
    isz = sfm.L2.element_size()
    if kind == "gather":  # each slab's rows, by distinct sector of the slab
        own = (rows // sfm.ns_local).long()
        local = (rows - own * sfm.ns_local).long()
        return sum(32 * sectors(isz * local[own == s.index]) for s in sfm.shards)
    if kind == "inv_psi":
        rows = rows[(rows & 31) != 0]
    blk = ((rows - (rows >= sfm.primary).to(rows.dtype)) >> 7).long()
    return 32 * (sectors(32 * blk) + sectors(4 * isz * blk))


def block_sector_bytes(blocks, isz: int) -> int:
    """32 bytes for each distinct 32-byte sector of the index that a list of
    block-number tensors touches: a block's eight BWT words (a sector) and
    its checkpoint row (4 * isz bytes)."""
    import torch

    blk = torch.unique(torch.cat(blocks)).long()
    return 32 * (blk.numel() + sectors(4 * isz * blk))


def resident_bounds(fm, kind: str, n_bytes_io: int, blocks, samples, n_steps: int,
                    longest: int, l2_load_ns: float) -> dict:
    """Bound of one resident scan (kind "scan") or walk ("walk"): the
    inputs and outputs once (n_bytes_io), and the index sectors the run
    touches once (`block_sector_bytes` of every step's blocks; the walk also
    its end rows' samples, by distinct sector); some 160 operations a scan
    step (two occ4s), 60 a walk step.  `chain_ms`, beside it: the longest
    read's steps (scan) or walk's steps and its sample (walk), each a
    dependent load that hits L2."""
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    isz = fm.occ_cp.element_size()
    n_bytes = n_bytes_io + block_sector_bytes(blocks, isz)
    if samples is not None:
        n_bytes += 32 * sectors(isz * samples.long())
    t_b, by = bound_ms(n_bytes, (160 if kind == "scan" else 60) * n_steps)
    chain = (longest + (kind == "walk")) * l2_load_ns / 1e6
    return dict(bound_ms=t_b, bound_by=by, bytes=n_bytes, chain_ms=chain)


def walk_trace(fm, rows):
    """The blocks each step of the walk of `rows` reads (a list, one tensor a
    step), the sample rows read at the walks' ends, the steps taken in all,
    and the longest walk's steps: the plain walk, step by step."""
    import torch

    from kart_tpu_torch.ops import fm_search as tfm

    k = rows.clone()
    blocks, n_steps, longest = [], 0, 0
    for it in range(tfm.SA_WALK_MAX_STEPS):
        walking = torch.nonzero((k & 31) != 0).flatten()
        if not walking.numel():
            break
        kw = k[walking]
        blocks.append((kw - (kw >= fm.primary).to(kw.dtype)) >> 7)
        k[walking] = tfm.inv_psi(fm, kw)
        n_steps, longest = n_steps + walking.numel(), it + 1
    return blocks, k >> 5, n_steps, longest


def two_groups(sfm) -> list:
    """The shards split into two groups on their one device (the first half,
    with shard 0, and the rest): the cross-device formulation."""
    half = (len(sfm.shards) + 1) // 2
    return [g for g in (sfm.shards[:half], sfm.shards[half:]) if g]


def phase_sharded_kernels(gidx, l2_load_ns: float, other_si=None) -> dict:
    """Phase 11 (a): the sharded index's kernels against their plain versions
    on cuda:0, byte for byte, int32 and int64, at 1, 2 and 4 shards: the
    resident scan of a 16,000-read group of phase 6's reads (l_max 160),
    also against fm_seed_scan and the cross-device loop over two groups, whose
    G1 (whole-device and each group) and G2 are held at step SHARD_SNAP; the
    resident walk of phase 4's stream rows against sa_walk, sa_walk_plain and
    the cross-device walk, whole and cut at 8 steps; G3 at the rows and
    after 10 steps (whole-device and each group); G4, the sample and full-SA
    gathers; the resolved stream, full and sampled, against resolve_pack's.
    Each kernel timed by slope at SHARD_TIMED shards (int32) with its bound,
    beside the replicated fm_seed_scan and sa_walk on the same inputs, and
    the cross-device scan's launches a step; with `other_si` (another
    build's parallel/sharded_index.py), its cross-device scan in the same
    two groups and its resident walk at 2 shards in turns with this
    build's."""
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.ops import fm_search as tfm
    from kart_tpu_torch.parallel import sharded_index as tsi
    from kart_tpu_torch.pipeline.mapper import compute_min_seed_length
    from kart_tpu_torch.tools.bench_kernels import time_both

    msl = compute_min_seed_length(gidx.two_genome_size)
    L, ms = L_MAX_GROUP, L_MAX_GROUP // (msl + 1) + 1
    dev = torch.device("cuda", 0)
    r1, r2 = os.path.join(DATA, "dev_r1.fq"), os.path.join(DATA, "dev_r2.fq")
    if not os.path.exists(r2):
        simulate_pairs(os.path.join(DATA, "genome.fa"), r1, r2, N_DEV_PAIRS)
    half = SHARD_B // 2
    seqs = [s for pair in zip(fastq_codes(r1, half), fastq_codes(r2, half)) for s in pair]
    reads_i8, rl = pad_batch(seqs, SHARD_B, L)
    reads = torch.from_numpy(reads_i8.astype(np.int32)).to(dev)
    rlens = torch.from_numpy(rl).to(dev)
    fm32 = tfm.FMIndexTensors.from_genome_index(gidx, dev)
    # phase 4's group, seeded by the FM stepper: its stream's rows
    g_reads = torch.from_numpy(group_reads(gidx, np.random.default_rng(13), B_GROUP, L).astype(
        np.int32)).to(dev)
    g_seeds = kernels.fm_seed_scan(fm32, g_reads, torch.full((B_GROUP,), READ_LEN, dtype=torch.int32,
                                                             device=dev), msl, max_seeds=ms, l_max=L)
    rows32 = stream_rows(g_seeds, ms, 3 * B_GROUP)
    sa32 = fm32.sa_full.to(dev)
    lines, timed = [], {}
    for dtype in ("int32", "int64"):
        g = gidx if dtype == "int32" else tsi.index_int64(gidx)
        fm = fm32 if dtype == "int32" else fm_int64(fm32)
        rows = rows32 if dtype == "int32" else rows32.long()
        want_seeds = kernels.fm_seed_scan(fm, reads, rlens, msl, max_seeds=ms, l_max=L)
        want_walk = {steps: (kernels.sa_walk(fm, rows, max_steps=steps),
                             tfm.sa_walk_plain(fm, rows, max_steps=steps))
                     for steps in (4096, 8)}
        for n in SHARD_COUNTS:
            what = f"{n} shards {dtype}"
            sfm = tsi.build_sharded_fm(g, [dev] * n, "full")
            groups = two_groups(sfm)
            snap: dict = {}
            calls = [0]

            # the resident scan, against fm_seed_scan and its plain version
            got = tsi.sharded_seed_scan(sfm, reads, rlens, msl, max_seeds=ms, l_max=L)
            require_equal(got, want_seeds, f"resident scan against fm_seed_scan ({what})")
            require_equal(got, tsi.resident_seed_scan_plain(sfm, reads, rlens, msl, max_seeds=ms,
                                                            l_max=L),
                          f"resident scan against its plain version ({what})")

            # the cross-device loop over two groups: G1 (each group and the
            # whole device) and the fused step held at step SHARD_SNAP
            fused_kernel = kernels.sharded_fused_step

            def fused_held(table, nb, L2, primary, seq_len, k, parts, ptrs, p, codes_t, rl_, m, s_,
                           state, state_out, out, k_next, sfm=sfm, groups=groups, snap=snap):
                # the blocks the step reads (an idle lane's row 0 among them)
                snap.setdefault("blocks", []).append(
                    torch.unique((k - (k >= sfm.primary).to(k.dtype)) >> 7))
                args = (table, nb, L2, primary, seq_len, k, parts, ptrs, p, codes_t, rl_, m, s_,
                        state, state_out, out, k_next)
                if p != SHARD_SNAP:
                    return fused_kernel(*args)
                for grp in groups + [sfm.shards]:
                    require_equal(tsi.table_occ4(sfm, grp, k), tsi.table_occ4_plain(sfm, grp, k),
                                  f"G1 ({what}, shards {[s.index for s in grp]})")
                snap.update(k=k.clone(), step=(p, codes_t, rl_, m, s_, tuple(x.clone() for x in state),
                                               out.clone(), [x.clone() for x in parts]))
                want_out = out.clone()
                want_state, want_k = tsi.fused_step_plain(sfm, groups[0], k, parts, p, codes_t,
                                                          rl_, m, s_, state, want_out)
                fused_kernel(*args)
                for a, b, nm in ((state_out[0], want_state[0], "ist"),
                                 (state_out[1], want_state[1], "tst"), (k_next, want_k, "rows"),
                                 (out, want_out, "seeds")):
                    require_equal(a, b, f"fused step {nm} against its plain composition ({what},"
                                        f" step {p})")

            fused_held.launches = 0
            with replaced(kernels, sharded_fused_step=fused_held):
                stepwise = tsi._stepwise_seed_scan(sfm, reads, rlens, msl, max_seeds=ms, l_max=L,
                                                   groups=groups)
            require_equal(stepwise, got, f"cross-device scan (two groups) against the resident"
                                         f" scan ({what})")
            require_equal(stepwise, want_seeds, f"cross-device scan (two groups) against"
                                                f" fm_seed_scan ({what})")

            # G3 at the stream rows: a step at the rows and after 10 steps
            k = rows
            for it in range(11):
                if it in (0, 10):
                    for grp in groups + [sfm.shards]:
                        add_k = torch.zeros(k.numel(), dtype=torch.int32, device=dev)
                        add_p = add_k.clone()
                        require_equal(tsi.table_inv_psi(sfm, grp, k, add_k),
                                      tsi.table_inv_psi_plain(sfm, grp, k, add_p),
                                      f"G3 ({what}, shards {[s.index for s in grp]}, step {it})")
                        require_equal(add_k, add_p, f"G3 steps ({what}, step {it})")
                k = tsi.sharded_inv_psi_batch(sfm, k, groups=groups)
            # the resident walk, whole and cut
            for steps in (4096, 8):
                w = tsi.sharded_sa_walk(sfm, rows, max_steps=steps)
                kern, plain = want_walk[steps]
                for a, b, r, c, d in zip(w, kern, plain,
                                         tsi.resident_sa_walk_plain(sfm, rows, max_steps=steps),
                                         tsi._stepwise_sa_walk(sfm, rows, max_steps=steps,
                                                               groups=groups)):
                    require_equal(a, b, f"resident walk against sa_walk ({what}, {steps} steps)")
                    require_equal(a, r, f"resident walk against sa_walk_plain ({what}, {steps})")
                    require_equal(a, c, f"resident walk against its plain version ({what},"
                                        f" {steps})")
                    require_equal(a, d, f"resident walk against the cross-device walk ({what},"
                                        f" {steps})")
                if bool(w[1].all()) != (steps == 4096):
                    raise AssertionError(f"resident walk ({what}): max_steps {steps} cut"
                                         f" {int((~w[1]).sum())} walks")
            for grp in groups + [sfm.shards]:
                for shift, nm in ((0, "full SA"), (5, "samples")):
                    require_equal(tsi.table_gather(sfm, grp, rows, shift),
                                  tsi.table_gather_plain(sfm, grp, rows, shift),
                                  f"G4 {nm} ({what}, shards {[s.index for s in grp]})")
            require_equal(tsi.sharded_sa_gather(sfm, rows), sa32[rows.long()].to(rows.dtype),
                          f"sharded full-SA gather ({what})")
            require_equal(tsi.resident_sa_gather_plain(sfm, rows), sa32[rows.long()].to(rows.dtype),
                          f"the resident gather's plain version ({what})")

            # the resolved stream, full and sampled, against resolve_pack
            H = 3 * SHARD_B
            full = kernels.resolve_pack(sa32.to(fm.index_dtype), want_seeds, max_seeds=ms,
                                        has_ok=False, occ_budget=H, pack16=False)
            full = full if isinstance(full, tuple) else (full[:SHARD_B], full[SHARD_B:SHARD_B + H],
                                                         full[SHARD_B + H:])
            for mode in ("full", "sampled"):
                sf = sfm if mode == "full" else tsi.build_sharded_fm(g, [dev] * n, "sampled")
                kernels.sharded_gather.launches = 0
                res = tsi.sharded_seed_scan_resolved(sf, reads, rlens, msl, max_seeds=ms, l_max=L,
                                                     occ_budget=H)
                torch.cuda.synchronize()
                if kernels.sharded_gather.launches:
                    raise AssertionError(f"the resident resolve ({what}, {mode}) launched G4")
                for a, b, nm in zip(res, full, ("cnts", "meta", "gpos")):
                    require_equal(a, b, f"sharded resolved {nm} ({what}, {mode})")
            # the cross-device full-SA resolve (two groups on the one card)
            with replaced(tsi, shard_groups=two_groups):
                res = tsi.sharded_seed_scan_resolved(sfm, reads, rlens, msl, max_seeds=ms, l_max=L,
                                                     occ_budget=H)
            for a, b, nm in zip(res, full, ("cnts", "meta", "gpos")):
                require_equal(a, b, f"sharded resolved {nm} ({what}, full, two groups)")
            lines.append(f"{what}: the resident scan ({int(got[:, 0].sum())} seeds) equal to"
                         f" fm_seed_scan, its plain version and the cross-device loop in"
                         f" {len(groups)} groups (G1 whole and in each group, the fused step byte-"
                         f"equal to its plain composition, at step {SHARD_SNAP}); the resident"
                         f" walk of {rows.numel()} rows (4096 and 8 steps) equal to sa_walk,"
                         f" sa_walk_plain, its plain version and the cross-device walk; G3 at"
                         f" steps 0 and 10, G4 (full SA, samples; whole and in each group),"
                         f" the resolved stream (full: resident through the table with no G4"
                         f" launch, and in two groups; sampled) equal")
            if n == SHARD_TIMED and dtype == "int32":
                timed = dict(sfm=sfm, snap=snap, rows=rows, want_seeds=want_seeds)
    # times at SHARD_TIMED shards, int32: each kernel's launch on the device
    sfm, snap, rows = timed["sfm"], timed["snap"], timed["rows"]
    k2 = snap["k"]
    p, codes_t, rl_, m, s_, state, out, parts = snap["step"]
    own = two_groups(sfm)[0]
    own_table, ptrs = tsi.shard_table(sfm, own), kernels.part_pointers(parts)
    state_out, k_next = tuple(torch.empty_like(x) for x in state), torch.empty_like(k2)
    add = torch.zeros(rows.numel(), dtype=torch.int32, device=dev)
    cases = {
        "sharded_seed_scan": ("scan", None, lambda: tsi.sharded_seed_scan(
            sfm, reads, rlens, msl, max_seeds=ms, l_max=L),
            lambda: tsi.resident_seed_scan_plain(sfm, reads, rlens, msl, max_seeds=ms, l_max=L)),
        "sharded_sa_walk": ("walk", None, lambda: tsi.sharded_sa_walk(sfm, rows),
                            lambda: tsi.resident_sa_walk_plain(sfm, rows)),
        "sharded_occ4": ("occ4", k2, lambda: tsi.table_occ4(sfm, sfm.shards, k2),
                         lambda: tsi.table_occ4_plain(sfm, sfm.shards, k2)),
        "sharded_fused_step": ("step", k2, lambda: kernels.sharded_fused_step(
            own_table, sfm.nb_local, sfm.L2, sfm.primary, sfm.seq_len, k2, parts, ptrs, p, codes_t,
            rl_, m, s_, state, state_out, out, k_next),
            lambda: tsi.fused_step_plain(sfm, own, k2, parts, p, codes_t, rl_, m, s_, state,
                                         out.clone())),
        "sharded_inv_psi": ("inv_psi", rows, lambda: tsi.table_inv_psi(sfm, sfm.shards, rows, add),
                            lambda: tsi.table_inv_psi_plain(sfm, sfm.shards, rows, add.clone())),
        "sharded_gather": ("gather", rows, lambda: tsi.table_gather(sfm, sfm.shards, rows),
                           lambda: tsi.table_gather_plain(sfm, sfm.shards, rows)),
    }
    # G4's yardstick: one gather of the same rows from the flat full SA
    library = {"sharded_gather": lambda: sa32[rows.long()]}
    rec = {}
    for name, (kind, r, fn, plain_fn) in cases.items():
        t = time_both(fn)
        plain = cuda_ms(plain_fn, 1 if kind in ("scan", "walk") else 3)
        lib = None if name not in library else time_both(library[name])[0] * 1e3
        if kind == "scan":
            out_s = timed["want_seeds"]
            b = resident_bounds(fm32, "scan", reads.nbytes + rlens.nbytes + out_s.nbytes,
                                snap["blocks"], None, int(rlens.sum()), int(rlens.max()),
                                l2_load_ns)
            shape = f"{SHARD_B} reads, l_max {L}, {SHARD_TIMED} shards on one card, int32"
        elif kind == "walk":
            blocks, samples, n_steps, longest = walk_trace(fm32, rows)
            b = resident_bounds(fm32, "walk", rows.numel() * (2 * rows.element_size() + 1),
                                blocks, samples, n_steps, longest, l2_load_ns)
            shape = f"{rows.numel()} stream rows, {SHARD_TIMED} shards on one card, int32"
        elif kind == "step":
            b = fused_step_bound(sfm, own, r, len(parts), l2_load_ns)
            shape = (f"{r.numel() // 2} lanes, step {p}, own shards {[x.index for x in own]} of"
                     f" {SHARD_TIMED} and {len(parts)} part, int32")
        else:
            b = sharded_bounds(sfm, kind, r, touched_bytes(sfm, kind, r), l2_load_ns)
            shape = (f"one launch for the {SHARD_TIMED} shards of one card, {r.numel()} rows,"
                     f" int32" + (", the full SA" if kind == "gather" else ""))
        rec[name] = dict(ms=1e3 * t[0], per_call_ms=1e3 * t[1], plain_ms=plain, err=0,
                         bound_ms=b["bound_ms"], bound_by=b["bound_by"], chain_ms=b["chain_ms"],
                         library_ms=lib, shape=shape)
        lines.append(f"{name} ({shape}): slope {1e3 * t[0]:.4f} ms, per call {1e3 * t[1]:.4f} ms,"
                     f" plain {plain:.4f} ms"
                     + ("" if lib is None else f", library call {lib:.4f} ms")
                     + f"; {b['bytes']} bytes: bound {b['bound_ms']:.4f} ms ({b['bound_by']}),"
                     f" chain {b['chain_ms']:.4f} ms")
    for n in SHARD_COUNTS:
        sf = tsi.build_sharded_fm(gidx, [dev] * n, "full")
        grp = two_groups(sf)
        scan_ms = cuda_ms(lambda: tsi.sharded_seed_scan(sf, reads, rlens, msl, max_seeds=ms,
                                                        l_max=L), 3)
        walk_ms = cuda_ms(lambda: tsi.sharded_sa_walk(sf, rows), 3)
        step_scan_ms = cuda_ms(lambda: tsi._stepwise_seed_scan(sf, reads, rlens, msl, max_seeds=ms,
                                                               l_max=L, groups=grp), 3)
        step_walk_ms = cuda_ms(lambda: tsi._stepwise_sa_walk(sf, rows, max_steps=4096,
                                                             groups=grp), 3)
        for k in ("sharded_occ4", "sharded_fused_step"):
            getattr(kernels, k).launches = 0
        tsi._stepwise_seed_scan(sf, reads, rlens, msl, max_seeds=ms, l_max=L, groups=grp)
        torch.cuda.synchronize()
        per_step = (kernels.sharded_occ4.launches + kernels.sharded_fused_step.launches) / (L + 1)
        if per_step != len(grp) or kernels.sharded_fused_step.launches != L + 1:
            raise AssertionError(f"cross-device scan at {n} shards in {len(grp)} groups:"
                                 f" {per_step} launches a step, expected {len(grp)}")
        lines.append(f"{n} shards int32, per call (event window): the resident scan of"
                     f" {SHARD_B} reads {scan_ms:.4f} ms, the resident walk of {rows.numel()}"
                     f" rows {walk_ms:.4f} ms; cross-device in {len(grp)} groups: the scan"
                     f" {step_scan_ms:.4f} ms ({L + 1} steps, launches a step {per_step:g}:"
                     f" {len(grp) - 1} G1 + the fused step), the walk {step_walk_ms:.4f} ms")
        rec[f"launches_a_step_{n}"] = per_step
        rec[f"scan_{n}_ms"], rec[f"walk_{n}_ms"] = scan_ms, walk_ms
        rec[f"stepwise_scan_{n}_ms"], rec[f"stepwise_walk_{n}_ms"] = step_scan_ms, step_walk_ms
    t_scan = time_both(lambda: kernels.fm_seed_scan(fm32, reads, rlens, msl, max_seeds=ms,
                                                    l_max=L))
    t_walk = time_both(lambda: kernels.sa_walk(fm32, rows))
    rec["fm_seed_scan_ms"], rec["sa_walk_ms"] = 1e3 * t_scan[0], 1e3 * t_walk[0]
    lines += resident_resolve_times(gidx, reads, rlens, msl, ms, L, timed["want_seeds"], rows,
                                    sa32, rec, other_si)
    lines.append(f"replicated, on the same inputs: fm_seed_scan of the {SHARD_B} reads slope"
                 f" {1e3 * t_scan[0]:.4f} ms (per call {1e3 * t_scan[1]:.4f}), sa_walk of the rows"
                 f" slope {1e3 * t_walk[0]:.4f} ms (per call {1e3 * t_walk[1]:.4f})")
    for ln in lines:
        print("phase 11 " + ln)
    if other_si is not None:
        # the other commit's cross-device scan (the same two groups) and
        # resident walk at 2 shards on cuda:0 beside this one's
        theirs = other_si.build_sharded_fm(gidx, [dev] * 2, "full")
        ours = tsi.build_sharded_fm(gidx, [dev] * 2, "full")
        scan = (lambda: other_si._stepwise_seed_scan(theirs, reads, rlens, msl, max_seeds=ms,
                                                     l_max=L, groups=two_groups(theirs)),
                lambda: tsi._stepwise_seed_scan(ours, reads, rlens, msl, max_seeds=ms, l_max=L,
                                                groups=two_groups(ours)))
        require_equal(scan[1](), scan[0](), "cross-device scan against the compared build's")
        t = [cuda_ms(scan[0], 3), cuda_ms(scan[1], 3), cuda_ms(scan[1], 3), cuda_ms(scan[0], 3)]
        rec["compare_stepwise_scan_ms"] = t
        print("compare the cross-device scan at 2 shards in two groups on cuda:0 (other: its"
              " _stepwise_seed_scan; this: the fused step): other, this, this, other: ms a call"
              " (event window) " + ", ".join(f"{x:.4f}" for x in t))
        for a, b in zip(other_si.resident_sa_walk(theirs, rows), tsi.resident_sa_walk(ours, rows)):
            require_equal(b, a, "resident walk against the compared build's")
        compare_turns(f"resident_sa_walk at 2 shards ({rows.numel()} stream rows)",
                      lambda: other_si.resident_sa_walk(theirs, rows),
                      lambda: tsi.resident_sa_walk(ours, rows))
    return rec


def probe_library(name: str, text: str):
    """A library of its own, kart_tpu_torch/_build/lib<name>.so, built by
    kernels.build from `text`: a CUDA source that includes a source of this
    checkout or of a compared one (its anonymous namespace is then the
    probe's own), to launch pieces of it alone."""
    import ctypes

    from kart_tpu_torch import kernels

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    src = os.path.join(kernels.BUILD_DIR, name + ".cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(kernels.BUILD_DIR, f"lib{name}.so")
    kernels.build(lib, [src])
    return ctypes.CDLL(lib)


# G4's owner by a 64-bit division, beside the two-step reciprocal that
# fm_index.cuh's ShardedSa takes: the same kernel, another accessor
DIVIDE_PROBE = """#include "%s"
namespace {
struct DivSa : ShardedSa<long long> {
  __device__ __forceinline__ long long at(long long q) const {
    const unsigned long long r = static_cast<unsigned long long>(q), s = r / n_local;
    const long long* p = slab(s);
    return p ? __ldg(p + (r - s * n_local)) : 0;
  }
};
}  // namespace
extern "C" int kart_probe_gather_div_i64(const void* table, int n_shards, long long n_local,
                                         const void* rows, int n, void* out, void* stream) {
  DivSa sa;
  static_cast<ShardedSa<long long>&>(sa) = table_sa<long long>(table, n_shards, n_local, 0);
  return launch_gather<long long>(sa, rows, n, 0, out, stream);
}
"""


def divide_times(gidx, rows, sa32, rec) -> list[str]:
    """G4 int64 at 2 shards on rows' device, the owner by ShardedSa's
    two-step reciprocal and by a 64-bit division (DIVIDE_PROBE), byte-equal,
    in turns by slope."""
    import ctypes

    import torch

    from kart_tpu_torch.parallel import sharded_index as tsi
    from kart_tpu_torch.tools.bench_kernels import time_both

    dev = rows.device
    lines = []
    sf64 = tsi.build_sharded_fm(tsi.index_int64(gidx), [dev] * 2, "full")
    r64 = rows.long()
    probe = probe_library("probe_divide", DIVIDE_PROBE % os.path.join(
        ROOT, "kart_tpu_torch", "csrc", "sharded_fm.cu"))
    p_, i_, ll_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    probe.kart_probe_gather_div_i64.argtypes = [p_, i_, ll_, p_, i_, p_, p_]
    tab64 = tsi.shard_table(sf64, sf64.shards)
    out64 = torch.empty_like(r64)

    def divided():
        rc = probe.kart_probe_gather_div_i64(tab64.data_ptr(), 2, sf64.ns_local, r64.data_ptr(),
                                             r64.numel(), out64.data_ptr(),
                                             torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"divide probe: cudaError {rc}")
        return out64

    require_equal(divided(), sa32[rows.long()].long(), "G4 int64 with a 64-bit division")
    require_equal(tsi.table_gather(sf64, sf64.shards, r64), sa32[rows.long()].long(),
                  "G4 int64 (two-step reciprocal)")
    t_two = [time_both(lambda: tsi.table_gather(sf64, sf64.shards, r64))[0],
             time_both(divided)[0]]
    t_two += [time_both(divided)[0], time_both(lambda: tsi.table_gather(sf64, sf64.shards,
                                                                       r64))[0]]
    rec["sharded_gather"]["int64_two_step_vs_divide_ms"] = [1e3 * x for x in t_two]
    lines.append("sharded_gather int64 at 2 shards, the owner by the two-step reciprocal and by"
                 " a 64-bit division (two-step, division, division, two-step): slope ms "
                 + ", ".join(f"{1e3 * x:.4f}" for x in t_two))
    return lines


def resident_resolve_times(gidx, reads, rlens, msl: int, ms: int, L: int, seeds, rows, sa32, rec,
                           other_si=None) -> list[str]:
    """Phase 11 (a)'s times of the G4 redesign, int32 on cuda:0 unless
    named: the table gather at 4 shards against its plain composition; the
    resident full-SA resolve (resolve_pack.cu through the table, `seeds` the
    resident scan's) at 2 and 4 shards against resolve_pack on the flat full
    SA, and sharded_seed_scan_resolved less sharded_seed_scan by slope; with
    `other_si` (another build's sharded_index), that difference of the other
    build's in turns with this one's, and G4 at 2 shards int64 with its
    owner by the two-step reciprocal against a 64-bit division
    (DIVIDE_PROBE)."""
    from kart_tpu_torch import kernels
    from kart_tpu_torch.parallel import sharded_index as tsi
    from kart_tpu_torch.tools.bench_kernels import time_both

    dev = rows.device
    H = 3 * SHARD_B
    lines = []
    sf4 = tsi.build_sharded_fm(gidx, [dev] * 4, "full")
    t4 = time_both(lambda: tsi.table_gather(sf4, sf4.shards, rows))
    p4 = cuda_ms(lambda: tsi.table_gather_plain(sf4, sf4.shards, rows), 3)
    rec["sharded_gather"]["ms_4_shards"] = 1e3 * t4[0]
    lines.append(f"sharded_gather at 4 shards (one launch, {rows.numel()} rows, int32): slope"
                 f" {1e3 * t4[0]:.4f} ms, per call {1e3 * t4[1]:.4f} ms, plain composition"
                 f" {p4:.4f} ms")
    kw = dict(max_seeds=ms, occ_budget=H)
    t_flat = time_both(lambda: kernels.resolve_pack(sa32, seeds, has_ok=False, pack16=False,
                                                    **kw))
    rec["resolve_flat_ms"] = 1e3 * t_flat[0]
    lines.append(f"resolve_pack on the flat full SA ({SHARD_B} reads, H {H}): slope"
                 f" {1e3 * t_flat[0]:.4f} ms, per call {1e3 * t_flat[1]:.4f} ms")
    for n in (2, 4):
        sf = tsi.build_sharded_fm(gidx, [dev] * n, "full")
        table = tsi.shard_table(sf, sf.shards)
        t_res = time_both(lambda: kernels.resolve_stream_table(table, sf.ns_local, seeds, **kw))
        whole = time_both(lambda: tsi.sharded_seed_scan_resolved(sf, reads, rlens, msl,
                                                                 max_seeds=ms, l_max=L,
                                                                 occ_budget=H))
        scan = time_both(lambda: tsi.sharded_seed_scan(sf, reads, rlens, msl, max_seeds=ms,
                                                       l_max=L))
        rec[f"resolve_table_{n}_ms"] = 1e3 * t_res[0]
        rec[f"resolved_less_scan_{n}_ms"] = 1e3 * (whole[0] - scan[0])
        lines.append(f"the resident full-SA resolve at {n} shards: resolve_stream_table slope"
                     f" {1e3 * t_res[0]:.4f} ms (per call {1e3 * t_res[1]:.4f}),"
                     f" {t_res[0] / t_flat[0]:.3f}x the flat resolve_pack;"
                     f" sharded_seed_scan_resolved {1e3 * whole[0]:.4f} ms less the resident scan"
                     f" {1e3 * scan[0]:.4f} ms = {1e3 * (whole[0] - scan[0]):.4f} ms")
        if other_si is None:
            continue
        theirs = other_si.build_sharded_fm(gidx, [dev] * n, "full")
        for a, b in zip(other_si.sharded_seed_scan_resolved(theirs, reads, rlens, msl, max_seeds=ms,
                                                            l_max=L, occ_budget=H),
                        tsi.sharded_seed_scan_resolved(sf, reads, rlens, msl, max_seeds=ms,
                                                       l_max=L, occ_budget=H)):
            require_equal(b, a, f"the resolved stream against the compared build's ({n} shards)")
        builds = {"other": (other_si, theirs), "this": (tsi, sf)}
        diffs = []
        for who in ("other", "this", "this", "other"):
            mod, x = builds[who]
            w = time_both(lambda: mod.sharded_seed_scan_resolved(x, reads, rlens, msl, max_seeds=ms,
                                                                 l_max=L, occ_budget=H))[0]
            sc = time_both(lambda: mod.sharded_seed_scan(x, reads, rlens, msl, max_seeds=ms,
                                                         l_max=L))[0]
            diffs.append(1e3 * (w - sc))
        rec[f"compare_resolved_less_scan_{n}_ms"] = diffs
        lines.append(f"compare the resident full-SA resolve at {n} shards (sharded_seed_scan_"
                     f"resolved less sharded_seed_scan, by slope; other: G4 a shard, the sum, the"
                     f" copies): other, this, this, other: ms "
                     + ", ".join(f"{x:.4f}" for x in diffs))
    if other_si is not None:
        lines += divide_times(gidx, rows, sa32, rec)
    return lines


MH_WORKER = os.path.join(ROOT, "tests", "torch_mh_worker.py")


def two_process_run(prefix: str, r1: str, r2: str, want: list[bytes]) -> dict:
    """Phase 11 (c): two processes of MH_WORKER, both on cuda:0, each with the
    index in two slabs there: the gloo group (an all_gather), the TCP stat relay and
    map_shard over the first SHARD_MH_PAIRS pairs; the merged records must
    equal `want`, a single process's."""
    import socket

    from kart_tpu_torch.parallel.stats_sync import StatRelayServer, chunk_aligned_ranges

    recs = {}
    for k, path in (("1", r1), ("2", r2)):
        with open(path, "rb") as f:
            lines = f.read().split(b"\n")[: 4 * SHARD_MH_PAIRS]
        recs[k] = [b"\n".join(lines[4 * i: 4 * i + 4]) + b"\n" for i in range(SHARD_MH_PAIRS)]
    ranges = chunk_aligned_ranges(SHARD_MH_PAIRS, 2)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    server = StatRelayServer()
    procs, outs = [], []
    t0 = time.perf_counter()
    try:
        for pid, (lo, hi, first) in enumerate(ranges):
            files = []
            for k in ("1", "2"):
                p = os.path.join(DATA, f"mh{pid}_r{k}.fq")
                with open(p, "wb") as f:
                    f.write(b"".join(recs[k][lo:hi]))
                files.append(p)
            out = os.path.join(DATA, f"mh{pid}.sam")
            outs.append(out)
            cfg = os.path.join(DATA, f"mh{pid}.json")
            with open(cfg, "w") as f:
                json.dump(dict(repo=ROOT, coordinator=f"127.0.0.1:{port}", nprocs=2, pid=pid,
                               prefix=prefix, r1=files[0], r2=files[1],
                               relay_host=server.address[0], relay_port=server.address[1],
                               first_chunk=first, out=out, device="cuda:0", idx_shards=2), f)
            env = {k: v for k, v in os.environ.items()
                   if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
            procs.append(subprocess.Popen([sys.executable, MH_WORKER, cfg], cwd=ROOT, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        logs = []
        for p in procs:
            sout, serr = p.communicate(timeout=300)
            if p.returncode != 0 or "WORKER_OK" not in sout:
                raise AssertionError(f"(c) worker exited {p.returncode}: {serr[-3000:]}")
            logs.append(json.loads(sout.split("WORKER_OK", 1)[1].split(" ", 2)[2]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.close()
    wall = time.perf_counter() - t0
    merged = [r for out in outs for r in sam_records(out)]
    if merged != want:
        raise AssertionError("(c) the two processes' merged SAM differs from a single process's")
    return dict(wall=wall, workers=logs)


def phase_sharded_slice(prefix: str) -> dict:
    """Phase 11 (b) and (c): the mapper's sharded path end to end through the
    CLI (-idx-shards N, the shards where default_shard_devices puts them:
    every one on cuda:0 of a one-card machine) at 2 and 4 shards over phase
    6's reads, full SA and KART_SA_MODE=sampled (the resident path: one
    resident scan a sharded call, one resident walk a call in the sampled
    runs, no step kernel), then 2 shards split into two groups, sampled (the
    cross-device path: the step kernels, no resident launch); each SAM equal
    to the native mode's; then the two-process run."""
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.parallel import sharded_index as tsi
    from kart_tpu_torch.pipeline.mapper import TorchKartMapper

    r1, r2 = os.path.join(DATA, "dev_r1.fq"), os.path.join(DATA, "dev_r2.fq")
    if not os.path.exists(r2):
        simulate_pairs(os.path.join(DATA, "genome.fa"), r1, r2, N_DEV_PAIRS)
    sam_nat = os.path.join(DATA, "native.sam")
    if not os.path.exists(sam_nat):
        run_cli(["-i", prefix, "-f", r1, "-f2", r2, "-o", sam_nat, "-silent"])
    want = sam_records(sam_nat)
    total, runs = {k: 0 for k in SHARDED_KERNELS}, {}
    plans = [(n, mode, "resident") for mode in ("full", "sampled") for n in SHARD_COUNTS[1:]]
    plans.append((2, "sampled", "two groups"))
    for n, mode, path in plans:
        out = os.path.join(DATA, f"sharded_{n}_{mode}_{path.replace(' ', '_')}.sam")
        grouping = replaced(tsi, shard_groups=two_groups) if path == "two groups" else \
            contextlib.nullcontext()
        for k in SHARDED_KERNELS:
            getattr(kernels, k).launches = 0
        with environ(KART_SA_MODE=mode, KART_SEED_MODE=None), grouping, \
                Spy(TorchKartMapper, "_sharded_seed_resolved", keep=lambda a: a[0]) as spy:
            log = run_cli(["-i", prefix, "-f", r1, "-f2", r2, "-o", out, "-idx-shards", str(n),
                           "-silent"])
            torch.cuda.synchronize()
            launches = {k: getattr(kernels, k).launches for k in SHARDED_KERNELS}
        layout = [str(s.device) for s in spy.first._get_sharded().shards]
        if layout != [str(d) for d in tsi.default_shard_devices(n, "cuda")]:
            raise AssertionError(f"(b) {n} shards: laid out on {layout}, not by"
                                 f" default_shard_devices")
        setup, map_s = cli_seconds(log)
        m = re.search(r"# of device seeding groups on \S+ = (\d+), flagged lanes = (\d+)", log)
        calls, flagged = int(m.group(1)), int(m.group(2))
        if path == "resident":
            need = {"sharded_seed_scan": calls, "sharded_sa_walk": calls if mode == "sampled" else 0,
                    "sharded_occ4": 0, "sharded_fused_step": 0, "sharded_inv_psi": 0,
                    "sharded_gather": 0}
            bad = {k: launches[k] for k, v in need.items() if launches[k] != v}
            if bad or launches["resolve_pack"] == 0:
                raise AssertionError(f"(b) {n} shards {mode}: the resident path launched"
                                     f" {launches} in {calls} sharded calls, expected {need} and"
                                     f" a resolve_pack (the full SA read through the table)")
        else:
            need = STEP_KERNELS + ("sharded_gather", "resolve_pack")
            if any(launches[k] == 0 for k in need) or any(launches[k] for k in RESIDENT_KERNELS) \
                    or launches["sharded_occ4"] != launches["sharded_fused_step"]:
                raise AssertionError(f"(b) {n} shards {mode} in two groups: a kernel of the"
                                     f" cross-device path never launched, a resident one did, or"
                                     f" a scan step was not one G1 and one fused step:"
                                     f" {launches}")
        if sam_records(out) != want:
            raise AssertionError(f"(b) {n} shards {mode} ({path}): the SAM differs from the native"
                                 f" mode's")
        runs[(n, mode, path)] = dict(reads_s=len(want) / map_s, map_s=map_s, setup_s=setup,
                                     launches=launches, calls=calls, flagged=flagged)
        for k in SHARDED_KERNELS:
            total[k] += launches[k]
        print(f"phase 11 (b) kart-tpu-torch -idx-shards {n}, shards on {sorted(set(layout))},"
              f" {mode} SA, {path}: {len(want)} reads, {len(want) / map_s:.1f} reads/s (mapping"
              f" {map_s:.3f} s), set-up {setup:.3f} s; {calls} sharded calls, flagged lanes"
              f" {flagged} (re-seeded on the host); launches {launches}; SAM records equal to the"
              f" native mode's")
    mh = two_process_run(prefix, r1, r2, want[: 2 * SHARD_MH_PAIRS])
    print(f"phase 11 (c) two processes on cuda:0 (gloo group, TCP stat relay, map_shard, 2 shards"
          f" each), {SHARD_MH_PAIRS} pairs: merged SAM records equal to a single process's;"
          f" wall {mh['wall']:.3f} s; workers {mh['workers']}")
    return dict(total=total, runs=runs, mh=mh)


B_DP, S_OCC = 32000, 16  # phase 12: 16,000 pairs of phase 6's reads; slots a read of F
DP_MESHES = (("data 1, replicated, full SA", 1, 1, "full"),
             ("data 4 on cuda:0 x 4, full SA", 4, 1, "full"),
             ("data 2, replicated, sampled SA", 2, 1, "sampled"),
             ("data x idx 2 x 2, full SA", 2, 2, "full"),
             ("data x idx 2 x 2, sampled SA", 2, 2, "sampled"))
DP_KERNELS = ("fm_seed_scan", "resolve_pack", "sa_walk", "sharded_seed_scan", "sharded_sa_walk",
              "sharded_occ4", "sharded_fused_step", "sharded_inv_psi", "sharded_gather",
              "sorted_occurrences", "candidate_tail", "cluster_illumina", "pair_candidates")


def sorted_occ_bound(stream, s_occ: int) -> dict:
    """Bound of one F call on this run's stream: cnts read once; of each
    read's first min(max(cnts, 0), s_occ) entries below H, meta read once and
    gpos where the entry is valid; n_occ and the five (B, s_occ) outputs
    written once.  Operations: a read of n valid slots ranks each against
    the others, n * n compares of some 6 operations."""
    import torch

    from kart_tpu_torch.tools.bench_kernels import bound_ms

    cnts, meta, gpos = (x.cpu() for x in stream)
    B, H, isz = cnts.numel(), meta.numel(), gpos.element_size()
    tot = cnts.clamp(min=0).long()
    offs = torch.cumsum(tot, 0) - tot
    take = torch.minimum(tot.clamp(max=s_occ), (H - offs).clamp(min=0))
    first = torch.cumsum(take, 0) - take
    n_load = int(take.sum())
    j = torch.repeat_interleave(offs - first, take) + torch.arange(n_load)
    valid = ((meta[j] >> 16) & 0xFFFF) != 0xFFFF
    n_valid = torch.zeros(B, dtype=torch.long).index_add_(
        0, torch.repeat_interleave(torch.arange(B), take), valid.long())
    n_bytes = 4 * B + 4 * n_load + isz * int(valid.sum()) + 4 * B + B * s_occ * (4 + 4 + isz + 4 + 1)
    t_b, by = bound_ms(n_bytes, 6 * int((n_valid * n_valid).sum()))
    return dict(bound_ms=t_b, bound_by=by, bytes=n_bytes, entries=n_load)


def dp_compare(ref, out, n_ref: int, n_out: int, what: str) -> int:
    """Raise unless `out`, a step over n_out blocks, gives `ref`'s (n_ref
    blocks) counts and entries for every read that neither flagged, its
    cluster ids, acceptance and scores, and the mate links of every pair
    whose mates neither flagged.  Returns the reads compared."""
    from kart_tpu_torch.parallel.dp import per_read_entries

    keep = (ref[0][0] >= 0) & (out[0][0] >= 0)
    for a, b, nm in zip(per_read_entries(out[0], n_out, keep), per_read_entries(ref[0], n_ref, keep),
                        ("cnts", "meta", "gpos")):
        require_equal(a, b, f"{what}: each read's {nm}")
    for a, b, nm in zip(out[1], ref[1], ("cluster_id", "accept", "scores")):
        require_equal(a[keep], b[keep], f"{what}: {nm}")
    pair_keep = keep[0::2] & keep[1::2]
    for a, b, nm in zip(out[2], ref[2], ("paired1", "paired2", "pairing")):
        require_equal(a[pair_keep], b[pair_keep], f"{what}: {nm}")
    return int(keep.sum())


def flagged_reads(stream, n_blocks: int) -> tuple[int, int]:
    """(reads flagged over the budget, reads flagged otherwise) of a step's
    stream over n_blocks blocks; raises unless every read from a block's
    first overflow of its budget on is flagged (make_full_mapping_step's
    contract: the budget check is a prefix sum, so these are a suffix of the
    block).  A read flagged while it fits (a sampled walk cut at max_steps)
    may stand anywhere."""
    import torch

    cnts, meta, _ = stream
    tot = torch.where(cnts >= 0, cnts, -cnts - 1).long().view(n_blocks, -1)
    over = torch.cumsum(tot, 1) > meta.numel() // n_blocks
    flags = (cnts < 0).view(n_blocks, -1)
    if (over & ~flags).any():
        raise AssertionError("a read past its block's budget is not flagged")
    return int(over.sum()), int((flags & ~over).sum())


@contextlib.contextmanager
def replaced(module, **attrs):
    """module's attributes replaced inside the block, restored after."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def eager_tail(k):
    """The glue's torch ops around k's cluster_illumina and pair_candidates
    (k a kernels module): the composition candidate_tail replaces."""
    from kart_tpu_torch.parallel import dp as tdp

    def run(*a):
        with replaced(tdp, cluster_illumina_plain=k.cluster_illumina,
                      pair_candidates_plain=k.pair_candidates):
            return tdp.candidate_tail_plain(*a)
    return run


def block_kernels(path: str, eager: bool) -> list[str]:
    """The device kernels of one dp block from F on (`front_tail`; with
    `eager`, the glue's torch ops around the two kernels in place of
    candidate_tail) on the block saved at `path`, by torch.profiler in a
    process of its own: in this one, after phase 12 (a)'s timings, a session
    can record the launches of the block and none of its kernels (PERF.md,
    section 7)."""
    cmd = [sys.executable, os.path.abspath(__file__), "--block-kernels", path,
           *(["--eager"] if eager else [])]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"block_kernels exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def block_kernels_main(path: str, eager: bool) -> int:
    """`--block-kernels PATH [--eager]`: print block_kernels' list as JSON."""
    import torch

    sys.path.insert(0, ROOT)
    from kart_tpu_torch import kernels
    from kart_tpu_torch.parallel import dp as tdp

    d = torch.load(path)
    stream = [x.cuda() for x in d["stream"]]
    rlens, keys = d["rlens"].cuda(), d["keys"].cuda()

    def run():
        return tdp.front_tail(*stream, rlens, keys, d["B"], d["S"], d["max_gaps"], d["est"])
    with replaced(tdp, **({"_candidate_tail": eager_tail(kernels)} if eager else {})):
        print(json.dumps(kernel_names(run)))
    return 0


def kernel_names(fn) -> list[str]:
    """The device kernels (and copies) of one fn() in order, by
    torch.profiler (`device_spans`)."""
    from kart_tpu_torch.tools.bench_kernels import device_spans

    return [short(n) for _, _, n in device_spans(fn, warm=fn)]


def cluster_pair_bounds(cl_args, pr_args) -> tuple:
    """(bound ms, by) of clustering and of mating on these inputs, as phase 3
    counts them: clustering moves the keys, three (B, S) arrays and two (B,)
    in and 9 bytes a slot out at some twenty operations a slot; mating its
    four inputs in, its links and flags out, some ten operations for each
    read-2 slot a live read-1 slot sweeps."""
    from kart_tpu_torch.tools.bench_kernels import bound_ms

    B, S = cl_args[1].shape
    c = bound_ms(cl_args[0].nbytes + 3 * B * S * 4 + 2 * B * 4 + B * S * 9, 20 * B * S)
    P, C1 = pr_args[0].shape
    C2 = pr_args[2].shape[1]
    live = int((pr_args[0] > 0).sum())
    p = bound_ms(2 * P * C1 * 4 + 2 * P * C2 * 4 + P * (C1 + C2) * 4 + P, 10 * live * C2)
    return c, p


# The tail kernel with its KART_TAIL_STAMP hooks recording clock64() at the
# end of each phase, thread 0 of each block
TAIL_STAMP_PROBE = """#include <cuda_runtime.h>
__device__ long long* kart_stamp_out;
#define KART_TAIL_STAMP(k) \\
  if (threadIdx.x == 0) kart_stamp_out[blockIdx.x * 8 + (k)] = clock64();
#include "%s"
extern "C" int kart_probe_tail_stamps(const void* chr_keys, int K, const void* n_occ,
                                      const void* ln, const void* gp, const void* pd,
                                      const void* present, const void* rlens, int max_gaps,
                                      int est, int B, int S, void* cluster_id, void* accept,
                                      void* scores, void* paired1, void* paired2, void* pairing,
                                      void* stamps, void* stream) {
  const cudaError_t e = cudaMemcpyToSymbol(kart_stamp_out, &stamps, sizeof(stamps));
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_tail<int>(chr_keys, K, n_occ, ln, gp, pd, present, rlens, max_gaps, est, B, S,
                          cluster_id, accept, scores, paired1, paired2, pairing,
                          static_cast<cudaStream_t>(stream));
}
"""
TAIL_PHASES = ("stage in", "cluster walk", "stage out", "choose mates", "decide mates",
               "links out")


def tail_stamps(args, max_gaps: int, est: int, want) -> dict:
    """The tail's phases (TAIL_STAMP_PROBE) on int32 inputs `args` (the
    tail's first seven arguments): mean clock64 cycles a block of each phase
    and of the whole, over the blocks of one launch; its outputs held to
    `want`."""
    import ctypes

    import torch

    lib = probe_library("probe_tail_stamps", TAIL_STAMP_PROBE % os.path.join(
        ROOT, "kart_tpu_torch", "csrc", "cluster.cu"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.kart_probe_tail_stamps.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i] + [p] * 8
    keys, n_occ, ln, gp, pd, present, rlens = args
    B, S = pd.shape
    dev = pd.device
    outs = [torch.empty((B, S), dtype=dt, device=dev) for dt in (torch.int32, torch.bool,
                                                                  torch.int32)]
    outs += [torch.empty((B // 2, S), dtype=torch.int32, device=dev) for _ in range(2)]
    outs.append(torch.empty((B // 2,), dtype=torch.bool, device=dev))
    n_blocks = -(-B // 32)
    stamps = torch.zeros((n_blocks, 8), dtype=torch.int64, device=dev)
    for _ in range(2):  # the second launch is the one read
        rc = lib.kart_probe_tail_stamps(
            keys.data_ptr(), keys.numel(), n_occ.data_ptr(), ln.data_ptr(), gp.data_ptr(),
            pd.data_ptr(), present.data_ptr(), rlens.data_ptr(), max_gaps, est, B, S,
            *(o.data_ptr() for o in outs), stamps.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"the tail stamp probe failed to launch ({rc})")
    for g, w in zip(outs, [x for grp in want for x in grp]):
        require_equal(g, w, "candidate_tail with its stamps")
    d = (stamps[:, 1:7] - stamps[:, 0:6]).double().mean(dim=0).tolist()
    out = dict(zip(TAIL_PHASES, d))
    out["whole"] = float((stamps[:, 6] - stamps[:, 0]).double().mean())
    return out


def phase_dp_tail(fouts: dict, stream, keys, rlens, lines: list, other=None) -> dict:
    """Phase 12 (a)'s H: kernels.candidate_tail (one launch: clustering, the
    glue, mating) against dp.candidate_tail_plain, byte-equal, on F's int32
    and int64 outputs of the step's block and on tools/simdata's edges;
    timed by slope with its bound, beside the plain version and the eager
    composition (the glue's torch ops around this build's cluster_illumina
    and pair_candidates); the device kernels of one block from F on
    (torch.profiler), fused and eager; cluster_illumina and pair_candidates
    alone at the dp shape.  With `other` (another build's kernels module),
    its eager composition and its two kernels in turns with this build's."""
    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.parallel import dp as tdp
    from kart_tpu_torch.tools import simdata
    from kart_tpu_torch.tools.bench_kernels import bound_ms, time_both

    mg, est = 5, 1500  # make_full_mapping_step's max_gaps and est_distance
    names = ("cluster_id", "accept", "scores", "paired1", "paired2", "pairing")
    dev = keys.device

    def check(got, want, what):
        for g, w, nm in zip([x for grp in got for x in grp], [x for grp in want for x in grp],
                            names):
            require_equal(g, w, f"candidate_tail {nm}, {what}")

    def clone(a):
        return tuple(x.clone() if torch.is_tensor(x) else x for x in a)

    A = None
    for dtype, f in fouts.items():
        args = (keys, f[0], f[2], f[3], f[4], f[5], rlens)
        with Spy(tdp, "cluster_illumina_plain", clone) as k_cl, \
                Spy(tdp, "pair_candidates_plain", clone) as k_pr:
            want = tdp.candidate_tail_plain(*args, mg, est)
        check(kernels.candidate_tail(*args, mg, est), want, f"F's {dtype} outputs")
        if A is None:
            A, want32, cl_args, pr_args = args, want, k_cl.first[:6], k_pr.first[:5]
    B, S = A[4].shape
    for name in simdata.TAIL_CASES:
        a = simdata.tail_inputs(name)
        t = tuple(torch.from_numpy(x).to(dev) for x in a[:7])
        check(kernels.candidate_tail(*t, *a[7:]), tdp.candidate_tail_plain(*t, *a[7:]),
              f"the edge {name!r}")
    check(eager_tail(kernels)(*A, mg, est), want32, "the eager composition")
    lines.append(f"(a) candidate_tail equal to candidate_tail_plain on F's int32 and int64 outputs"
                 f" (B {B}, s_occ {S}: {int(want32[1][2].sum())} of {B // 2} pairs mated) and on"
                 f" the edges of tools/simdata ({', '.join(simdata.TAIL_CASES)}); the eager"
                 f" composition with this build's cluster_illumina and pair_candidates equal too")

    def fused():
        return kernels.candidate_tail(*A, mg, est)

    t_f = time_both(fused)
    t_e = time_both(lambda: eager_tail(kernels)(*A, mg, est))
    plain = cuda_ms(lambda: tdp.candidate_tail_plain(*A, mg, est), 3)
    isz = A[3].element_size()
    n_bytes = (keys.nbytes + 4 * B + B * S * (4 + isz + 4 + 1) + 4 * B  # in
               + B * S * (4 + 1 + 4) + (B // 2) * S * 8 + B // 2)  # out
    c_b, p_b = cluster_pair_bounds(cl_args, pr_args)
    t_b, by = bound_ms(n_bytes, 20 * B * S + 10 * int((pr_args[0] > 0).sum()) * S)
    rec = dict(ms=1e3 * t_f[0], per_call_ms=1e3 * t_f[1], plain_ms=plain, err=0, bound_ms=t_b,
               bound_by=by, eager_ms=1e3 * t_e[0], shape=f"B {B}, s_occ {S}, F's int32 outputs")
    lines.append(f"(a) candidate_tail (B {B}, s_occ {S}): slope {rec['ms']:.4f} ms, per call"
                 f" {rec['per_call_ms']:.4f} ms, plain {plain:.4f} ms; the eager composition"
                 f" with this build's two kernels: slope {rec['eager_ms']:.4f} ms, per call"
                 f" {1e3 * t_e[1]:.4f} ms; {n_bytes} bytes: bound {t_b:.4f} ms ({by})")
    rec["stamp_cycles"] = st = tail_stamps(A, mg, est, want32)
    lines.append("(a) candidate_tail by phase (clock64, TAIL_STAMP_PROBE), mean cycles a block of"
                 " 32 reads: " + ", ".join(f"{k} {v:.0f}" for k, v in st.items()))
    cnts = stream[0]
    block = os.path.join(DATA, "dp_block.pt")
    torch.save(dict(stream=[x.cpu() for x in stream], rlens=rlens.cpu(), keys=keys.cpu(),
                    B=B, S=S, max_gaps=mg, est=est), block)
    fused_k, eager_k = block_kernels(block, eager=False), block_kernels(block, eager=True)
    if len(fused_k) != 2 or "sorted_occ" not in fused_k[0] or "candidate_tail" not in fused_k[1]:
        raise AssertionError(f"(a) one block from F on ran {fused_k}, expected F and the tail")
    rec["block_kernels"], rec["eager_block_kernels"] = fused_k, eager_k
    lines.append(f"(a) device kernels of one block from F on (torch.profiler, B {cnts.numel()}):"
                 f" fused {len(fused_k)}: {', '.join(fused_k)}; the eager composition"
                 f" {len(eager_k)}: {', '.join(eager_k)}")
    # clustering and mating alone at the dp shape, on this block's inputs
    t_c = time_both(lambda: kernels.cluster_illumina(*cl_args, mg, max_seeds=S))
    t_p = time_both(lambda: kernels.pair_candidates(*pr_args))
    P = pr_args[0].shape[0]
    cl_dp = dict(ms=1e3 * t_c[0], per_call_ms=1e3 * t_c[1], bound_ms=c_b[0], bound_by=c_b[1])
    pr_dp = dict(ms=1e3 * t_p[0], per_call_ms=1e3 * t_p[1], bound_ms=p_b[0], bound_by=p_b[1])
    lines.append(f"(a) at the dp shape, on this block's inputs: cluster_illumina (B {B}, S {S})"
                 f" slope {cl_dp['ms']:.4f} ms, per call {cl_dp['per_call_ms']:.4f} ms, bound"
                 f" {c_b[0]:.4f} ms ({c_b[1]}); pair_candidates (P {P}, C1 {S}, C2 {S}) slope"
                 f" {pr_dp['ms']:.4f} ms, per call {pr_dp['per_call_ms']:.4f} ms, bound"
                 f" {p_b[0]:.4f} ms ({p_b[1]})")
    if other is not None:
        # the other build's tail: its own kernel where it has one, else its
        # eager composition (its two kernels and the glue's torch ops)
        if hasattr(other, "candidate_tail"):
            theirs, kind = (lambda: other.candidate_tail(*A, mg, est)), "its candidate_tail"
        else:
            theirs, kind = (lambda: eager_tail(other)(*A, mg, est)), "its eager composition"
        check(theirs(), want32, f"the other build's tail ({kind})")
        rec["compare_ms"] = compare_turns(f"H, the candidate tail (B {B}, s_occ {S}; other:"
                                          f" {kind})", theirs, fused)
        cl_dp["compare_ms"] = compare_turns(
            f"cluster_illumina dp shape (B {B}, S {S})",
            lambda: other.cluster_illumina(*cl_args, mg, max_seeds=S),
            lambda: kernels.cluster_illumina(*cl_args, mg, max_seeds=S))
        pr_dp["compare_ms"] = compare_turns(
            f"pair_candidates dp shape (P {P}, C1 {S}, C2 {S})",
            lambda: other.pair_candidates(*pr_args), lambda: kernels.pair_candidates(*pr_args))
    rec["cluster_dp"], rec["pair_dp"] = cl_dp, pr_dp
    return rec


def phase_dp(gidx, other=None, other_root: str | None = None) -> dict:
    """Phase 12: the multi-device front half (kart_tpu_torch/parallel/dp.py)
    with every mesh position on cuda:0.  (a) F (csrc/sorted_occ.cu) against
    its plain version, byte-equal, on the resolved stream of phase 6's first
    32,000 reads (mates in consecutive rows, mate 2 reverse-complemented as
    the reader loads it; budget 4 x B, int32 and the int64 copy) and on edge
    streams, timed by slope with its bound, its launches a call listed by
    torch.profiler (with `other`, the other build's kernels module, and its
    checkout `other_root`: the other build's F in turns with this one's,
    and each launch of a two-launch design there timed alone,
    `two_launch_split`); (b) make_full_mapping_step over five meshes, each
    equal to data 1, and data 1 equal to the plain composition of the same
    step on the card; ms a step, reads/s, flagged reads, launches; (c)
    graft_entry's dry run on [cuda:0] * 4 and entry() (equal to its run on
    the CPU), and bench_scaling's lines."""
    import torch

    from kart_tpu_torch import graft_entry, kernels
    from kart_tpu_torch.ops import fm_search as tfm
    from kart_tpu_torch.ops import resolve as tres
    from kart_tpu_torch.parallel import dp as tdp
    from kart_tpu_torch.pipeline.mapper import compute_min_seed_length
    from kart_tpu_torch.tools import bench_scaling, simdata
    from kart_tpu_torch.tools.bench_kernels import device_us_by_kernel, time_both

    msl = compute_min_seed_length(gidx.two_genome_size)
    L, ms = L_MAX_GROUP, L_MAX_GROUP // (msl + 1) + 1
    dev = torch.device("cuda", 0)
    r1, r2 = os.path.join(DATA, "dev_r1.fq"), os.path.join(DATA, "dev_r2.fq")
    if not os.path.exists(r2):
        simulate_pairs(os.path.join(DATA, "genome.fa"), r1, r2, N_DEV_PAIRS)
    half = B_DP // 2
    # mate 2 reverse-complemented, as the reader loads a pair (io/fastq.py)
    mates = [np.where(s < 4, 3 - s, 4).astype(np.int8)[::-1] for s in fastq_codes(r2, half)]
    seqs = [s for pair in zip(fastq_codes(r1, half), mates) for s in pair]
    reads_i8, rl = pad_batch(seqs, B_DP, L)
    reads = torch.from_numpy(reads_i8.astype(np.int32)).to(dev)
    rlens = torch.from_numpy(rl).to(dev)
    lines = []

    # (a) F at the step's width, int32 and int64, then on the edges
    H = 4 * B_DP
    fm32 = tfm.FMIndexTensors.from_genome_index(gidx, dev)
    sa32 = fm32.sa_full.to(dev)
    streams, fouts, got32 = {}, {}, None
    for dtype, fm, sa in (("int32", fm32, sa32), ("int64", fm_int64(fm32), sa32.long())):
        seeds = kernels.fm_seed_scan(fm, reads, rlens, msl, max_seeds=ms, l_max=L)
        out = kernels.resolve_pack(sa, seeds, max_seeds=ms, has_ok=False, occ_budget=H,
                                   pack16=False)
        stream = out if isinstance(out, tuple) else (out[:B_DP], out[B_DP:B_DP + H], out[B_DP + H:])
        streams[dtype] = stream
        got = kernels.sorted_occurrences(*stream, B_DP, S_OCC)
        for g, w, nm in zip(got, tdp.sorted_occurrences_plain(*stream, B_DP, S_OCC),
                            ("n_occ", "rp", "ln", "gp", "pd", "present")):
            require_equal(g, w, f"F {nm} ({dtype}, B {B_DP}, H {H})")
        fouts[dtype] = got
        if got32 is None:
            got32 = got
        else:  # pd's fill narrows to -1 from int64, so pd is held where present
            for g, w, nm in zip(got, got32, ("n_occ", "rp", "ln", "gp", "pd", "present")):
                if nm == "pd":
                    g, w = g[got32[5]], w[got32[5]]
                require_equal(g.to(w.dtype), w, f"F {nm}: int64 against int32")
    cnts = streams["int32"][0]
    lines.append(f"(a) F on the resolved stream of {B_DP} reads (l_max {L}, max_seeds {ms}, budget"
                 f" {H}: {int(cnts.clamp(min=0).sum())} entries, {int((cnts < 0).sum())} reads"
                 f" flagged), s_occ {S_OCC}: equal to its plain version, int32 and int64, and"
                 f" int64 equal to int32 ({int(got32[0].sum())} occurrences sorted)")
    for name in simdata.OCC_STREAMS:
        for dtype in ("int32", "int64"):
            c, m, g, B, s_occ = simdata.occurrence_stream(name, dtype)
            args = (torch.from_numpy(c).to(dev), torch.from_numpy(m).to(dev),
                    torch.from_numpy(g).to(dev), B, s_occ)
            for a, b, nm in zip(kernels.sorted_occurrences(*args),
                                tdp.sorted_occurrences_plain(*args),
                                ("n_occ", "rp", "ln", "gp", "pd", "present")):
                require_equal(a, b, f"F {nm} on the edge stream {name!r} ({dtype})")
    lines.append(f"(a) F equal to its plain version on the edge streams of tools/simdata"
                 f" ({', '.join(simdata.OCC_STREAMS)}: a flagged read's entries, slen 32768, past"
                 f" s_occ at 12 and 32 slots, ties, invalid slots, past H; B 5,000 at 16 and 32"
                 f" slots), int32 and int64")
    rec = {}
    for dtype in ("int32", "int64"):
        st = streams[dtype]
        t = time_both(lambda st=st: kernels.sorted_occurrences(*st, B_DP, S_OCC))
        plain = cuda_ms(lambda st=st: tdp.sorted_occurrences_plain(*st, B_DP, S_OCC), 3)
        b = sorted_occ_bound(st, S_OCC)
        rec[dtype] = dict(ms=1e3 * t[0], per_call_ms=1e3 * t[1], plain_ms=plain, err=0,
                          bound_ms=b["bound_ms"], bound_by=b["bound_by"], bytes=b["bytes"])
        lines.append(f"(a) sorted_occurrences {dtype} (B {B_DP}, H {H}, s_occ {S_OCC}): slope"
                     f" {1e3 * t[0]:.4f} ms, per call {1e3 * t[1]:.4f} ms, plain {plain:.4f} ms;"
                     f" {b['bytes']} bytes ({b['entries']} stream entries read): bound"
                     f" {b['bound_ms']:.4f} ms ({b['bound_by']})")
    parts = device_us_by_kernel(lambda: kernels.sorted_occurrences(*streams["int32"], B_DP, S_OCC))
    rec["int32"]["device_launches"] = {short(k): v for k, v in parts.items()}
    lines.append("(a) sorted_occurrences int32, device us a call by launch (torch.profiler): "
                 + ", ".join(f"{short(k)} {v:.2f}" for k, v in sorted(parts.items())))
    if other is not None:
        st = streams["int32"]
        for a, b_, nm in zip(other.sorted_occurrences(*st, B_DP, S_OCC),
                             kernels.sorted_occurrences(*st, B_DP, S_OCC),
                             ("n_occ", "rp", "ln", "gp", "pd", "present")):
            require_equal(b_, a, f"F {nm} against the compared build's")
        t = [time_both(lambda: other.sorted_occurrences(*st, B_DP, S_OCC))[0],
             time_both(lambda: kernels.sorted_occurrences(*st, B_DP, S_OCC))[0],
             time_both(lambda: kernels.sorted_occurrences(*st, B_DP, S_OCC))[0],
             time_both(lambda: other.sorted_occurrences(*st, B_DP, S_OCC))[0]]
        rec["int32"]["compare_ms"] = [1e3 * x for x in t]
        lines.append("compare F int32 (other, this, this, other): slope ms "
                     + ", ".join(f"{1e3 * x:.4f}" for x in t))
        split = two_launch_split(other_root, st, B_DP, S_OCC)
        if split is not None:
            rec["int32"]["other_split_ms"] = split
            lines.append(f"(a) the other build's two launches of F, each alone by slope: the"
                         f" one-block scan {split[0]:.4f} ms, the sort {split[1]:.4f} ms")
        tiles = tile_times(st, B_DP, S_OCC)
        rec["int32"]["tile_ms"] = tiles
        lines.append("(a) F int32 by its tile of reads (this build's kernel, other tiles through"
                     " TILE_PROBE), slope ms: " + ", ".join(f"{k} reads {v:.4f}"
                                                            for k, v in tiles.items()))

    # (a) H, the candidate tail, on F's outputs of the step's width and on the edges
    keys = torch.from_numpy(np.ascontiguousarray(gidx.chr_map[0].astype(np.int32))).to(dev)
    tail = phase_dp_tail(fouts, streams["int32"], keys, rlens, lines, other)

    # (b) the whole front half over five meshes
    kw = dict(min_seed_len=msl, max_seeds=ms, l_max=L, s_occ=S_OCC)
    total = {k: 0 for k in DP_KERNELS}
    ref = None
    runs = {}
    for name, n_data, n_idx, sa_mode in DP_MESHES:
        mesh = tdp.make_data_mesh(n_data, n_idx, devices=[dev] * (n_data * n_idx))
        step, place = tdp.make_full_mapping_step(mesh, gidx, idx_axis="idx" if n_idx > 1 else None,
                                                 sa_mode=sa_mode, **kw)
        r, rl_ = place(reads, rlens)
        step(r, rl_)  # warm
        torch.cuda.synchronize()
        for k in DP_KERNELS:
            getattr(kernels, k).launches = 0
        out = step(r, rl_)
        torch.cuda.synchronize()
        launches = {k: getattr(kernels, k).launches for k in DP_KERNELS}
        for k in DP_KERNELS:
            total[k] += launches[k]
        need = ["resolve_pack", "sorted_occurrences", "candidate_tail"]
        need += ["fm_seed_scan"] if n_idx == 1 else ["sharded_seed_scan"]
        need += ["sa_walk"] if (n_idx, sa_mode) == (1, "sampled") else []
        need += ["sharded_sa_walk"] if (n_idx, sa_mode) == (2, "sampled") else []
        if any(launches[k] == 0 for k in need) or any(launches[k] for k in STEP_KERNELS) \
                or launches["sharded_gather"] or launches["cluster_illumina"] \
                or launches["pair_candidates"]:
            raise AssertionError(f"(b) {name}: a kernel of the step never launched, or G4, a"
                                 f" step kernel of the cross-device path, cluster_illumina or"
                                 f" pair_candidates did: {launches}")
        step_ms = cuda_ms(lambda: step(r, rl_), 3)
        flagged = flagged_reads(out[0], n_data)
        if ref is None:
            ref = out
            for k in DP_KERNELS:
                getattr(kernels, k).launches = 0
            with replaced(tdp, seed_scan=tfm.seed_scan_plain, resolve_pack=tres.resolve_pack_plain,
                          _sorted_occurrences=tdp.sorted_occurrences_plain,
                          _candidate_tail=tdp.candidate_tail_plain):
                plain_out = step(r, rl_)
            torch.cuda.synchronize()
            plain_launches = {k: getattr(kernels, k).launches for k in DP_KERNELS}
            if any(plain_launches.values()):
                raise AssertionError(f"(b) {name}: the plain composition launched a kernel:"
                                     f" {plain_launches}")
            for g, w, nm in zip([x for grp in out for x in grp],
                                [x for grp in plain_out for x in grp],
                                ("cnts", "meta", "gpos", "cluster_id", "accept", "scores",
                                 "paired1", "paired2", "pairing")):
                require_equal(g, w, f"(b) {name}: {nm} against the plain composition")
            cmp = f"every array equal to the plain composition on the card; {int(out[2][2].sum())}" \
                  f" of {B_DP // 2} pairs mated"
        else:
            kept = dp_compare(ref, out, 1, n_data, f"(b) {name}")
            cmp = f"equal to data 1 on the {kept} reads neither flagged"
        runs[name] = dict(step_ms=step_ms, reads_s=B_DP / step_ms * 1e3, flagged=flagged,
                          launches=launches)
        lines.append(f"(b) {name}: {step_ms:.4f} ms a step (event window), {B_DP / step_ms * 1e3:.1f}"
                     f" reads/s, flagged reads {flagged[0]} over the budget (a suffix of each"
                     f" block) and {flagged[1]} by a cut walk; {cmp};"
                     f" launches {launches}")

    # (c) the entry points and the scaling tool, every position on cuda:0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graft_entry.dryrun_multichip(4, devices=[dev] * 4)
    lines.append("(c) " + buf.getvalue().strip() + " (every position on cuda:0)")
    fn, args = graft_entry.entry()
    fn_cpu, args_cpu = graft_entry.entry("cpu")
    for g, w, nm in zip(fn(*args), fn_cpu(*args_cpu), ("packed", "locs")):
        require_equal(g.cpu(), w, f"(c) entry() {nm} on the card against the CPU")
    lines.append(f"(c) entry(): seed scan + full-SA gather of {args[0].shape[0]} reads on the card"
                 f" equal to its run on the CPU")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_scaling.main([])
    lines += [f"(c) bench_scaling (one card: every mesh position shares cuda:0): {ln}"
              for ln in buf.getvalue().strip().splitlines()]
    for ln in lines:
        print("phase 12 " + ln)
    return dict(tail=tail, sorted_occ=dict(rec["int32"], int64=rec["int64"], per_call_ms=rec["int32"]["per_call_ms"],
                                shape=f"B {B_DP}, H {H}, s_occ {S_OCC}, int32"),
                launches=total, runs=runs)


BENCH_METRICS = ("illumina_pe_reads_per_sec_device_pipelined", "pacbio_reads_per_sec_per_chip",
                 "illumina_pe_reads_per_sec_per_chip")  # tools/bench.py's lines, in bench.py's order
BENCH_KERNELS = ("kmer_funnel", "resolve_pack")  # launched in every device-pipelined pass
# the bench in a process of its own that, like this script, cannot import
# JAX, kart_tpu or bench.py
_BENCH_RUN = """
import runpy, sys
for m in ("jax", "kart_tpu", "bench"):
    sys.modules[m] = None
runpy.run_module("kart_tpu_torch.tools.bench", run_name="__main__")
"""


def phase_bench(prefix: str, pb: str, smi: str) -> None:
    """Phase 13: (a) tools/bench.py on this script's genome, index, phase 6's
    reads and the PacBio reads, in a child process; (b) run_test.sh."""
    r1, r2 = os.path.join(DATA, "dev_r1.fq"), os.path.join(DATA, "dev_r2.fq")
    if not (os.path.exists(r1) and os.path.exists(r2)):  # phase 6 did not run
        simulate_pairs(os.path.join(DATA, "genome.fa"), r1, r2, N_DEV_PAIRS)
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if not k.startswith("KART_")}
    proc = subprocess.run([sys.executable, "-c", _BENCH_RUN, "--index", prefix, "--reads", r1, r2,
                           "--pacbio", pb], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=400)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"(a) the bench exited {proc.returncode}: {proc.stderr[-3000:]}")
    got = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if [r.get("metric") for r in got] != list(BENCH_METRICS):
        raise AssertionError(f"(a) the bench's lines: {proc.stdout[-3000:]}")
    bad = [r for r in got if r["value"] is None or r["device"] != smi]
    if bad:
        raise AssertionError(f"(a) a line without a value or not on {smi!r}: {bad}")
    side = json.loads(proc.stderr.strip().splitlines()[-1])
    idle = [k for k in BENCH_KERNELS if not side["launches"].get(k)]
    if idle:
        raise AssertionError(f"(a) no launch of {idle} in the device passes: {side}")
    print(f"phase 13 (a) tools/bench.py on phase 6's {2 * N_DEV_PAIRS} reads and phase 8's PacBio"
          f" reads, in a process of its own: exit 0 in {wall:.1f} s")
    for r in got:
        print(f"phase 13 (a) {json.dumps(r)}")
    print(f"phase 13 (a) set-up, groups and launches of the timed device passes: {json.dumps(side)}")

    # (b) the port's smoke test: its own index, native SAM, evaluator, device SAM
    t0 = time.perf_counter()
    env["KART_TPU_TEST_DIR"] = os.path.join(DATA, "run_test")
    env["PYTHON"] = sys.executable
    proc = subprocess.run(["bash", os.path.join(ROOT, "kart_tpu_torch", "run_test.sh")], cwd=ROOT,
                          env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                          timeout=300)
    wall = time.perf_counter() - t0
    out = proc.stdout
    want = ("[Making the index files successfully! (.bwt == 4639752 bytes)]",
            "[The device-pipelined SAM is byte-equal to the native SAM]", "[End of test]")
    if proc.returncode != 0 or not all(w in out for w in want):
        raise AssertionError(f"(b) run_test.sh exited {proc.returncode}: {out[-3000:]}")
    evaluator = [ln for ln in out.splitlines()
                 if ln.startswith(("# of reads", "# of mapped", "precision", "recall"))]
    print(f"phase 13 (b) kart_tpu_torch/run_test.sh: exit 0 in {wall:.1f} s; {want[0]};"
          f" {'; '.join(evaluator)}; {want[1]} (KART_SEED_MODE=device on the card)")


# A two-launch design of F (offsets_kernel, a one-block scan, then
# launch_sort), its launches exported alone
SPLIT_PROBE = """#include "%s"
extern "C" int kart_split_offsets(const void* cnts, int B, void* offs, void* stream) {
  offsets_kernel<<<1, kScanThreads, kTile * sizeof(unsigned), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cnts), B, static_cast<int*>(offs));
  return static_cast<int>(cudaGetLastError());
}
extern "C" int kart_split_sort(const void* cnts, const void* offs, int B, const void* meta,
                               const void* gpos, long long H, int S, void* n_occ, void* rp,
                               void* ln, void* gp, void* pd, void* present, void* stream) {
  launch_sort<int, 16>(cnts, offs, B, meta, gpos, H, S, kBig32, n_occ, rp, ln, gp, pd, present,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
"""


# This build's F at other tiles of reads a block (int32, s_occ 16 at most)
TILE_PROBE = """#include "%s"
extern "C" int kart_probe_tile(int tile, const void* cnts, int B, const void* meta,
                               const void* gpos, long long H, int S, void* state, void* n_occ,
                               void* rp, void* ln, void* gp, void* pd, void* present,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S > 16) return static_cast<int>(cudaErrorInvalidValue);
  if (tile == 64)
    launch_sort<int, 16, 64>(cnts, B, meta, gpos, H, S, kBig32, state, n_occ, rp, ln, gp, pd,
                             present, st);
  else if (tile == 256)
    launch_sort<int, 16, 256>(cnts, B, meta, gpos, H, S, kBig32, state, n_occ, rp, ln, gp, pd,
                              present, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
"""


def tile_times(stream, B: int, s_occ: int) -> dict:
    """F's slope (int32) at this build's tile (128 reads at 16 slots) and,
    through TILE_PROBE, at tiles of 64 and 256 reads, each byte-equal to the
    plain version."""
    import ctypes

    import torch

    from kart_tpu_torch import kernels
    from kart_tpu_torch.parallel import dp as tdp
    from kart_tpu_torch.tools.bench_kernels import time_both

    lib = probe_library("probe_tile", TILE_PROBE % os.path.join(
        ROOT, "kart_tpu_torch", "csrc", "sorted_occ.cu"))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kart_probe_tile.argtypes = [i, p, i, p, p, ll, i, p, p, p, p, p, p, p, p]
    cnts, meta, gpos = stream
    dev = cnts.device
    want = tdp.sorted_occurrences_plain(cnts, meta, gpos, B, s_occ)
    out = {128: 1e3 * time_both(lambda: kernels.sorted_occurrences(cnts, meta, gpos, B,
                                                                   s_occ))[0]}
    for tile in (64, 256):
        state = torch.zeros((2 + -(-B // tile),), dtype=torch.int64, device=dev)
        outs = [torch.empty((B,), dtype=torch.int32, device=dev)] + [
            torch.empty((B, s_occ), dtype=dt, device=dev)
            for dt in (torch.int32, torch.int32, torch.int32, torch.int32, torch.bool)]

        def run(tile=tile, state=state, outs=outs):
            if lib.kart_probe_tile(tile, cnts.data_ptr(), B, meta.data_ptr(), gpos.data_ptr(),
                                   meta.numel(), s_occ, state.data_ptr(),
                                   *(o.data_ptr() for o in outs),
                                   torch.cuda.current_stream(dev).cuda_stream):
                raise RuntimeError(f"the tile probe at {tile} reads failed to launch")

        run()
        for g, w in zip(outs, want):
            require_equal(g, w, f"F at a tile of {tile} reads")
        out[tile] = 1e3 * time_both(run)[0]
    return out


def two_launch_split(root: str, stream, B: int, s_occ: int):
    """[ms of the scan launch, ms of the sort launch], each alone by slope,
    of the F at root/kart_tpu_torch/csrc/sorted_occ.cu where it is the
    two-launch design (SPLIT_PROBE); None where it is not."""
    import ctypes

    import torch

    from kart_tpu_torch.tools.bench_kernels import time_both

    src = os.path.join(os.path.abspath(root), "kart_tpu_torch", "csrc", "sorted_occ.cu")
    with open(src) as f:
        if "offsets_kernel" not in f.read():
            return None
    lib = probe_library("probe_split", SPLIT_PROBE % src)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kart_split_offsets.argtypes = [p, i, p, p]
    lib.kart_split_sort.argtypes = [p, p, i, p, p, ll, i, p, p, p, p, p, p, p]
    cnts, meta, gpos = stream
    dev = cnts.device
    offs = torch.empty((B,), dtype=torch.int32, device=dev)
    outs = [torch.empty((B,), dtype=torch.int32, device=dev)] + [
        torch.empty((B, s_occ), dtype=dt, device=dev)
        for dt in (torch.int32, torch.int32, torch.int32, torch.int32, torch.bool)]

    def st():
        return torch.cuda.current_stream(dev).cuda_stream

    def scan():
        if lib.kart_split_offsets(cnts.data_ptr(), B, offs.data_ptr(), st()):
            raise RuntimeError("the split probe's scan failed to launch")

    def sort():
        if lib.kart_split_sort(cnts.data_ptr(), offs.data_ptr(), B, meta.data_ptr(),
                               gpos.data_ptr(), meta.numel(), s_occ,
                               *(o.data_ptr() for o in outs), st()):
            raise RuntimeError("the split probe's sort failed to launch")

    scan()
    sort()
    torch.cuda.synchronize()
    return [1e3 * time_both(scan)[0], 1e3 * time_both(sort)[0]]


def load_compared_package(root: str, module: str):
    """root/kart_tpu_torch loaded as a package of its own name, and its
    `module`: its relative imports resolve inside it, so it launches the
    kernels that root's kernels.py builds beside it."""
    import importlib
    import importlib.util

    name = "kart_tpu_torch_compared"
    if name not in sys.modules:
        pkg = os.path.join(root, "kart_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.{module}")


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", metavar="DIR", default=None,
                    help="a checkout of another commit whose NW, FM stepper, funnel and"
                         " resolve_pack phases 1, 2 and 4, whose clustering and mating phase 3,"
                         " whose SensitiveMode funnel and FM stepper phase 7, whose walk phase"
                         " 9, whose cross-device scan, resident walk and resident full-SA"
                         " resolve phase 11, and whose F, candidate tail, clustering and mating"
                         " phase 12, time beside this one's")
    ap.add_argument("--phases", metavar="LIST", default=None,
                    help="run only these phases beside phase 0 and the set-up, e.g. 7,8 (a partial"
                         " run prints no kernels record and no result line, and exits 4)")
    ap.add_argument("--block-kernels", metavar="PATH", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--eager", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    only = None if args.phases is None else {int(x) for x in args.phases.split(",")}

    def want(n: int) -> bool:
        return only is None or n in only
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.block_kernels is not None:
        return block_kernels_main(args.block_kernels, args.eager)
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

    other = other_si = None
    if args.compare is not None:
        from kart_tpu_torch.tools.bench_kernels import load_kernels_module

        other = load_kernels_module(os.path.join(args.compare, "kart_tpu_torch", "kernels.py"),
                                    "kart_tpu_torch_compared_kernels")
        other.build()
        other_si = load_compared_package(args.compare, "parallel.sharded_index")
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
        slice3 = phase_slice(prefix, gidx, fm["l2_ns"], other)
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
        sampled = phase_sampled_kernels(gidx, pb, fm["l2_ns"], other)
        sampled_launches = phase_sampled_slice(
            prefix, pb, os.path.join(DATA, "dev.sam") if want(6) else None)
    if want(10):
        phase_tools(gidx, prefix)
    if want(11):
        sharded = phase_sharded_kernels(gidx, fm["l2_ns"], other_si)
        sharded_slice = phase_sharded_slice(prefix)
    if want(12):
        dp = phase_dp(gidx, other, args.compare)
    if want(13):
        phase_bench(prefix, pb, smi)
    loaded = sorted(m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in ("jax", "kart_tpu", "bench"))
    if loaded:
        raise AssertionError(f"the port imported {loaded}")
    if only is not None:
        print(f"partial run (phases {sorted(only)}): no kernels record, no result")
        return 4

    def entry(name, source, replaces, n_launches, r, library_ms=None):
        # shape, reseed_layout: what a record's times refer to, where phase lines alone do not say
        extra = {k: r[k] for k in ("shape", "reseed_layout", "chain_ms", "chain_steps", "ns_a_step",
                                   "design_chain_ms", "per_call_ms",
                                   "slab_paths", "int64", "resolve_pack_sampled_ms",
                                   "resolve_pack_int64_ms", "resolve_pack_full_ms",
                                   "fm_seed_scan_int64_ms", "fm_sensitive_scan_int64_ms",
                                   "keys_ms", "compare_ms", "dp_shape", "eager_ms",
                                   "block_kernels", "eager_block_kernels", "stamp_cycles")
                 if k in r}
        return dict(name=name, route="cuda", source=f"kart_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=n_launches, max_abs_err=r["err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=library_ms, **extra)

    fm["err"] = max(fm["err"], funnel["fm_err"])
    # library_ms: table[rid] for the row gather and slab[rows] for the sharded
    # gather; no one PyTorch call computes
    # an FM backward search (windowed or not), an NW traceback plane, the
    # candidate tail's clustering and mating in one pass, the
    # funnel's rounds in either mode, the budgeted expansion into a packed
    # stream, the 2-bit unpack, an inverse-Psi walk, a clustering whose
    # breaks and threshold run in order along the seeds, or a mate choice
    # that steals in order along the candidates, a masked occ4 of a slab, an
    # FM step from counts, or an inverse-Psi step
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
              launches_b["cluster_illumina"],
              dict(slice3["cluster"], dp_shape=dp["tail"]["cluster_dp"])),
        entry("pair_candidates", "pairing.cu", "kart_tpu/ops/pairing.py:22",
              launches_b["pair_candidates"], dict(slice3["pair"], dp_shape=dp["tail"]["pair_dp"])),
        entry("sharded_seed_scan", "fm_seed_scan.cu",
              "kart_tpu/parallel/sharded_index.py:230 with kart_tpu/parallel/sharded_index.py:138",
              sharded_slice["total"]["sharded_seed_scan"], sharded["sharded_seed_scan"]),
        entry("sharded_sa_walk", "sa_walk.cu",
              "kart_tpu/parallel/sharded_index.py:189 with kart_tpu/parallel/sharded_index.py:159",
              sharded_slice["total"]["sharded_sa_walk"], sharded["sharded_sa_walk"]),
        entry("sharded_occ4", "sharded_fm.cu",
              "kart_tpu/parallel/sharded_index.py:115 and kart_tpu/parallel/sharded_index.py:138",
              sharded_slice["total"]["sharded_occ4"], sharded["sharded_occ4"]),
        entry("sharded_fused_step", "sharded_fm.cu",
              "kart_tpu/parallel/sharded_index.py:230 (kart_tpu/ops/fm_search.py:165's step) with"
              " kart_tpu/parallel/sharded_index.py:138",
              sharded_slice["total"]["sharded_fused_step"], sharded["sharded_fused_step"]),
        entry("sharded_inv_psi", "sharded_fm.cu",
              "kart_tpu/parallel/sharded_index.py:159 and kart_tpu/parallel/sharded_index.py:189",
              sharded_slice["total"]["sharded_inv_psi"], sharded["sharded_inv_psi"]),
        entry("sharded_gather", "sharded_fm.cu",
              "kart_tpu/parallel/sharded_index.py:148 and kart_tpu/parallel/sharded_index.py:218",
              sharded_slice["total"]["sharded_gather"], sharded["sharded_gather"],
              sharded["sharded_gather"]["library_ms"]),
        entry("sorted_occurrences", "sorted_occ.cu", "kart_tpu/parallel/dp.py:115",
              dp["launches"]["sorted_occurrences"], dp["sorted_occ"]),
        entry("candidate_tail", "cluster.cu", "kart_tpu/parallel/dp.py:223",
              dp["launches"]["candidate_tail"], dp["tail"]),
    ]}
    from kart_tpu_torch.tools.bench_kernels import PROFILER_OFFSETS

    print(f"torch.profiler: {len(PROFILER_OFFSETS)} sessions with a launch; launch to kernel, us"
          f" (seconds into the run: least..most): "
          + ", ".join(f"{t - T_START:.0f} s {lo:.1f}..{hi:.1f}" for t, lo, hi in PROFILER_OFFSETS))
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
