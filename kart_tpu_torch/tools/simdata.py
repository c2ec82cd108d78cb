"""Synthetic genome, paired reads and PacBio reads for smoke runs and tests.

The port's own copy of the generators of the repository's `bench.py`
(`make_repeat_genome`, the read recipe of `simulate_reads`, and the PacBio
recipe of `ensure_pacbio_assets`), so that the port runs on the same data
without importing it: an E. coli-scale random genome with implanted repeat
families, 150 bp read pairs with insert 500 +- 50, 1% substitutions and
indels at 0.001 per base, and PacBio-like reads of 5,000 to 7,000 bases with
15% errors (substitutions, deletions and insertions 2:1:1).  All draw from a
numpy `Generator` in the same order as bench.py, so the same seed gives the
same bytes (tests/test_torch_slice.py holds them equal).  `ensure_assets`
makes bench.py's whole set (genome, index and 100,000 pairs) under bench.py's
file names.
"""

from __future__ import annotations

import os

import numpy as np

GENOME_LEN = 4_639_680
GENOME_SEED = 7
READS_SEED = 20260817
READ_LEN = 150
N_PAIRS = 100_000  # bench.py's read set
GENOME_NAME = b"bench_ecoli_synthetic_repeats"
PB_READS_SEED = 20260821
PB_N_READS = 1500
PB_MIN_LEN, PB_MAX_LEN = 5000, 7000
PB_ERR = 0.15

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_repeat_genome(rng: np.random.Generator) -> np.ndarray:
    """Random genome with implanted repeat families (tandem + dispersed)."""
    seq = rng.choice(_BASES, size=GENOME_LEN)

    def diverge(frag, rate):
        frag = frag.copy()
        n = rng.binomial(len(frag), rate)
        if n:
            idx = rng.integers(0, len(frag), size=n)
            frag[idx] = _BASES[rng.integers(0, 4, size=n)]
        return frag

    def implant(frag):
        p = int(rng.integers(0, GENOME_LEN - len(frag)))
        seq[p : p + len(frag)] = frag

    # rRNA-operon-like: 7 near-identical 5 kb copies
    src = rng.choice(_BASES, size=5000)
    for _ in range(7):
        implant(diverge(src, 0.005))
    # IS-element-like: 5 families x 10 copies of 1.2 kb
    for _ in range(5):
        src = rng.choice(_BASES, size=1200)
        for _ in range(10):
            implant(diverge(src, 0.015))
    # REP-motif-like: 500 copies of a 40 bp motif
    src = rng.choice(_BASES, size=40)
    for _ in range(500):
        implant(diverge(src, 0.05))
    # tandem arrays: 30 loci, unit 20-200 bp x 3-8 copies
    for _ in range(30):
        unit = rng.choice(_BASES, size=int(rng.integers(20, 200)))
        arr = np.concatenate([diverge(unit, 0.01) for _ in range(int(rng.integers(3, 8)))])
        implant(arr)
    return seq


def write_genome_fasta(path: str, seq: np.ndarray) -> None:
    """One record, 70 bases a line, under bench.py's sequence name."""
    s = seq.tobytes()
    with open(path, "wb") as f:
        f.write(b">" + GENOME_NAME + b"\n")
        for j in range(0, len(s), 70):
            f.write(s[j : j + 70] + b"\n")


def read_genome_fasta(path: str) -> np.ndarray:
    """The bases of a one-record FASTA written by write_genome_fasta."""
    with open(path, "rb") as f:
        return np.frombuffer(b"".join(f.read().split(b"\n")[1:]), np.uint8)


def ensure_assets(data_dir: str) -> tuple[str, str, str]:
    """bench.py's genome, its index (built by the port's builder, byte for
    byte kart_tpu's) and its 100,000 read pairs in data_dir under bench.py's
    file names, each made where missing -> (index prefix, r1, r2)."""
    from ..index import build_index, index_files_exist

    os.makedirs(data_dir, exist_ok=True)
    fa = os.path.join(data_dir, "bench_genome_v2.fa")
    prefix = os.path.join(data_dir, "bench_idx_v2")
    r1, r2 = (os.path.join(data_dir, f"bench_v2_r{k}.fq") for k in (1, 2))
    if not os.path.exists(fa):
        write_genome_fasta(fa, make_repeat_genome(np.random.default_rng(GENOME_SEED)))
    if not (index_files_exist(prefix) and os.path.exists(prefix + ".saf")):
        build_index(fa, prefix, verbose=False)
    if count_reads(r1) != N_PAIRS or count_reads(r2) != N_PAIRS:
        simulate_reads(read_genome_fasta(fa), r1, r2, N_PAIRS)
    return prefix, r1, r2


def count_reads(path: str) -> int:
    """FASTQ records in `path` (0 where it is missing)."""
    if not os.path.exists(path):
        return 0
    with open(path, "rb") as f:
        return sum(1 for _ in f) // 4


def simulate_reads(genome: np.ndarray, out1: str, out2: str, n_pairs: int,
                   err: float = 0.01, indel: float = 0.001) -> None:
    """Deterministic PE simulator (insert ~500, sd 50): the first n_pairs
    pairs of bench.py's read set for this genome, as two FASTQ files."""
    comp = np.zeros(256, np.uint8)
    comp[_BASES] = np.frombuffer(b"TGCA", np.uint8)
    rng = np.random.default_rng(READS_SEED)
    L = len(genome)
    qline = b"I" * READ_LEN
    with open(out1, "wb") as f1, open(out2, "wb") as f2:
        for i in range(n_pairs):
            insert = max(2 * READ_LEN, int(rng.normal(500, 50)))
            p = int(rng.integers(0, L - insert))
            frag = genome[p : p + insert].copy()
            # base errors + occasional indels
            nerr = rng.binomial(len(frag), err)
            if nerr:
                idx = rng.integers(0, len(frag), size=nerr)
                frag[idx] = _BASES[rng.integers(0, 4, size=nerr)]
            if rng.random() < indel * insert:
                q = int(rng.integers(10, len(frag) - 10))
                if rng.random() < 0.5:
                    frag = np.delete(frag, slice(q, q + int(rng.integers(1, 4))))
                else:
                    ins = _BASES[rng.integers(0, 4, int(rng.integers(1, 4)))]
                    frag = np.insert(frag, q, ins)
            fwd = frag[:READ_LEN].tobytes()
            rev = comp[frag[-READ_LEN:][::-1]].tobytes()
            hdr = f"@{i}:Pos={p + 1}\t".encode()
            f1.write(hdr + b"/1\n" + fwd + b"\n+\n" + qline + b"\n")
            f2.write(hdr + b"/2\n" + rev + b"\n+\n" + qline + b"\n")


def noisy_copy(rng: np.random.Generator, src: np.ndarray, rl: int, err: float = PB_ERR) -> bytes:
    """At most rl bases read off `src` with bench.py's PacBio error model:
    per step a substitution (err / 2), a deletion (err / 4), an insertion
    (err / 4) or the base itself, in bench.py's order of draws."""
    out = []
    j = 0
    n = len(src)
    while j < n and len(out) < rl:
        r = rng.random()
        if r < err * 0.5:  # substitution
            out.append(_BASES[(np.searchsorted(_BASES, src[j]) + rng.integers(1, 4)) % 4])
            j += 1
        elif r < err * 0.75:  # deletion
            j += 1
        elif r < err:  # insertion
            out.append(_BASES[rng.integers(0, 4)])
        else:
            out.append(src[j])
            j += 1
    return bytes(out[:rl])


def simulate_pacbio_reads(genome: np.ndarray, out: str, n_reads: int = PB_N_READS) -> None:
    """The first n_reads reads of bench.py's PacBio read set for this genome
    (`@pb<i>:Pos=<1-based start>`), as one FASTQ file."""
    rng = np.random.default_rng(PB_READS_SEED)
    L = len(genome)
    with open(out, "wb") as f:
        for i in range(n_reads):
            rl = int(rng.integers(PB_MIN_LEN, PB_MAX_LEN + 1))
            p = int(rng.integers(0, L - 2 * rl))
            seq = noisy_copy(rng, genome[p : p + int(rl * 1.3)], rl)
            f.write(b"@pb%d:Pos=%d\n%s\n+\n%s\n" % (i, p + 1, seq, b"I" * len(seq)))


# Resolved occurrence streams on the edges of the PosDiff sort (F,
# parallel/dp.py::_sorted_occurrences): the tests hold the plain version to
# kart_tpu's and the kernel (through the host shim) to the plain version on
# them, chip_smoke.py the kernel on the card.
OCC_STREAMS = ("flagged_keeps_entries", "sign_bit", "past_s_occ", "ties", "invalid_slots",
               "past_H", "random", "wide", "past_s_occ_warp", "mixed", "mixed_warp")


def meta_of(rp, slen) -> np.ndarray:
    """rpos | slen << 16 as int32 bits (a slen of 32768 sets the sign bit)."""
    m = (np.asarray(rp, np.int64) & 0xFFFF) | (np.asarray(slen, np.int64) << 16)
    return ((m + 2**31) % 2**32 - 2**31).astype(np.int32)


def occurrence_stream(name: str, dtype: str):
    """(cnts, meta, gpos, B, s_occ) of the resolved stream `name` of
    OCC_STREAMS, gpos int32 or int64 (`dtype`): a flagged read whose entries
    stay in the stream (the reads after it take them), meta's sign bit (slen
    32768), reads past s_occ (at 12 slots, and at 32, a warp a read), equal
    (pd, rp), invalid slots, entries past H, and random batches of 70, 40 and
    5,000 reads (the last at 16 and 32 slots, with ties).  In int64 half the
    positions lie past 2**32, so pd narrows to its low 32 bits."""
    rng = np.random.default_rng(OCC_STREAMS.index(name) + 17)
    idt = np.int32 if dtype == "int32" else np.int64
    s_occ = {"past_s_occ": 12, "wide": 32, "past_s_occ_warp": 32, "mixed_warp": 32}.get(name, 16)
    if name == "flagged_keeps_entries":
        # read 1 is flagged (tot 3 counts 0) but its three entries stay: read 2
        # takes them, and read 3 starts where read 2's count ends
        cnts = np.array([3, -4, 2, 5, 0, 4], np.int32)
        H = 3 + 3 + 2 + 5 + 4 + 3  # 17 entries, then the fill
    elif name == "past_H":
        cnts = np.array([5, 7, 9, 6], np.int32)
        H = 15  # read 2 is cut at the end of the stream, read 3 has nothing
    elif name in ("past_s_occ", "past_s_occ_warp"):
        cnts = np.array([40, 3, 12, 13] if name == "past_s_occ" else [40, 3, 12, 33, 17], np.int32)
        H = int(cnts.sum())
    else:
        B = {"random": 70, "wide": 40, "mixed": 5000, "mixed_warp": 5000}.get(name, 9)
        cnts = rng.integers(-6, 40 if name.startswith("mixed") else 30, B).astype(np.int32)
        cnts[rng.random(B) < 0.2] = 0
        H = int(np.maximum(cnts, 0).sum()) + int(rng.integers(0, 12))
    B = len(cnts)
    rp = rng.integers(0, 150, H)
    slen = rng.integers(13, 60, H)
    gpos = rng.integers(0, 5000, H).astype(np.int64)
    if name in ("ties", "mixed", "mixed_warp"):  # equal (pd, rp) and equal pd with another rp
        rp = rng.integers(0, 3, H)
        gpos = rp + rng.integers(100, 103, H)
    if name in ("sign_bit", "random", "wide", "mixed", "mixed_warp"):
        slen[rng.random(H) < 0.3] = 32768
    if name in ("invalid_slots", "random", "wide", "past_H", "mixed", "mixed_warp"):
        bad = rng.random(H) < 0.25
        slen[bad] = 0xFFFF
        rp[bad] = 0xFFFF
    meta = meta_of(rp, slen)
    n_entries = 17 if name == "flagged_keeps_entries" else int(np.maximum(cnts, 0).sum())
    meta[n_entries:] = -1  # the stream's fill past the last entry
    if dtype == "int64":
        gpos[rng.random(H) < 0.5] += 2**32 + 7  # pd narrows to its low 32 bits
    return cnts, meta, gpos.astype(idt), B, s_occ


# F's outputs on the edges of the front half's candidate tail
# (parallel/dp.py::candidate_tail_plain): the tests hold the plain version
# to kart_tpu's lines and the kernel (through the host shim) to the plain
# version on them, chip_smoke.py the kernel on the card.
TAIL_CASES = ("random", "unsorted_pd", "accepted_empty", "absent_inside", "negative_pd",
              "s_occ_1", "s_occ_32", "gp_int64", "crafted")
TAIL_MAX_GAPS, TAIL_EST = 5, 1500


def tail_inputs(name: str):
    """(keys, n_occ, ln, gp, pd, present, rlens, max_gaps, est) of the case
    `name` of TAIL_CASES, laid out as F leaves them: B reads (an even count,
    rows 2p and 2p + 1 a pair, read 2's posdiffs a few hundred past read
    1's) of S slots (16; 1 and 32 for the s_occ cases), each read's first
    n_occ slots PosDiff-sorted seeds (lengths 13-60, some 32768, gpos across
    the 6 chromosome keys of 3 chromosomes), the rest F's fill (pd 2**31 - 1,
    present False, ln and gp 0).  Edges: posdiffs that fall inside a cluster
    (its least member is not its first), reads whose threshold is negative
    (rlens -7 to -400, so empty cluster slots are accepted), present False
    inside n_occ (pd there F's int64 fill narrowed, -1), negative posdiffs,
    gpos int64 past 2**32 (narrowed), and `crafted`'s four pairs: a cluster
    whose least posdiff, not its first, reaches the mate; a threshold of
    floor(-14 / 10) = -2 that accepts a score of -1; two read-1 clusters of
    one score on one mate (the second does not steal); and a higher score
    that steals."""
    if name == "crafted":
        return _crafted_tail()
    rng = np.random.default_rng(TAIL_CASES.index(name) + 101)
    S = {"s_occ_1": 1, "s_occ_32": 32}.get(name, 16)
    B = {"random": 256, "s_occ_32": 128}.get(name, 64)
    keys = np.array([3000, 8000, 10000, 12000, 14000, 20000], np.int32)
    n_occ = rng.integers(0, S + 1, B).astype(np.int32)
    base = rng.integers(-50, 19000, B // 2)
    base = np.stack([base, base + rng.integers(150, 450, B // 2)], axis=1).reshape(-1)
    step = np.where(rng.random((B, S)) < 0.7, rng.integers(0, 4, (B, S)),
                    rng.integers(4, 900, (B, S)))
    pd = (base[:, None] + np.cumsum(step, axis=1)).astype(np.int64)
    if name == "unsorted_pd":  # small steps down inside a run of breaks
        pd -= np.where(rng.random((B, S)) < 0.4, rng.integers(1, 4, (B, S)), 0)
    if name == "negative_pd":
        pd -= rng.integers(0, 400, (B, 1))
    rp = rng.integers(0, 150, (B, S))
    gp = pd + rp
    ln = rng.integers(13, 61, (B, S))
    ln[rng.random((B, S)) < 0.05] = 32768
    present = np.ones((B, S), bool)
    if name == "absent_inside":
        present = rng.random((B, S)) >= 0.2
    rlens = np.where(rng.random(B) < 0.9, 150, rng.integers(0, 151, B))
    if name == "accepted_empty":
        rlens[::3] = -rng.integers(7, 401, len(rlens[::3]))
    fill = np.arange(S)[None, :] >= n_occ[:, None]
    present &= ~fill
    pd = np.where(present, pd, np.where(fill, 2**31 - 1, -1))
    gp = np.where(fill, 0, gp)
    ln = np.where(fill, 0, ln)
    if name == "gp_int64":
        gp = np.where(rng.random((B, S)) < 0.5, gp + 2**32, gp)
    gdt = np.int64 if name == "gp_int64" else np.int32
    return (keys, n_occ, ln.astype(np.int32), gp.astype(gdt), pd.astype(np.int32), present,
            rlens.astype(np.int32), TAIL_MAX_GAPS, TAIL_EST)


def _crafted_tail():
    """tail_inputs("crafted"): four pairs of reads of 4 slots, each read's
    seeds as (pd, gp, ln) in slot order."""
    S = 4
    reads = [
        [(1000, 1100, 30), (990, 1092, 30)], [(995, 1100, 40)],  # least, not first, reaches
        [(100, 160, -1)], [(400, 470, 40)],  # thr0 -2 accepts -1 (truncated -1 would not)
        [(100, 150, 40), (200, 250, 40)], [(300, 350, 50)],  # a tie on one mate: no steal
        [(100, 150, 35), (200, 250, 45)], [(300, 350, 50)],  # a higher score steals
    ]
    B = len(reads)
    pd = np.full((B, S), 2**31 - 1, np.int32)
    gp = np.zeros((B, S), np.int32)
    ln = np.zeros((B, S), np.int32)
    present = np.zeros((B, S), bool)
    n_occ = np.array([len(r) for r in reads], np.int32)
    for b, seeds in enumerate(reads):
        for t, (p, g, l) in enumerate(seeds):
            pd[b, t], gp[b, t], ln[b, t], present[b, t] = p, g, l, True
    rlens = np.array([150, 150, -7, 150, 150, 150, 150, 150], np.int32)
    keys = np.array([3000, 8000], np.int32)
    return keys, n_occ, ln, gp, pd, present, rlens, TAIL_MAX_GAPS, TAIL_EST
