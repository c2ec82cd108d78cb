"""Synthetic genome and paired reads for smoke runs and tests.

The port's own copy of the generators of the repository's `bench.py`
(`make_repeat_genome`, and the read recipe of `simulate_reads`), so that
the port runs on the same data without importing it: an E. coli-scale
random genome with implanted repeat families, and 150 bp read pairs with
insert 500 +- 50, 1% substitutions and indels at 0.001 per base.  Both draw
from a numpy `Generator` in the same order as bench.py, so the same seed
gives the same bytes (tests/test_torch_slice.py holds them equal).
"""

from __future__ import annotations

import numpy as np

GENOME_LEN = 4_639_680
GENOME_SEED = 7
READS_SEED = 20260817
READ_LEN = 150
GENOME_NAME = b"bench_ecoli_synthetic_repeats"

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
