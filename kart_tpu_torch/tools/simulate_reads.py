#!/usr/bin/env python
"""Seedable paired-end read simulator (wgsim-equivalent, diploid).

Capability parity with the reference's bundled wgsim (reference:
wgsim/wgsim.c:107-165 wgsim_mut_diref, :243-454 wgsim_core), with the same
mutation model:

  * TWO haplotypes per chromosome (diploid); each mutation is homozygous
    with probability 1/3, else heterozygous on one random haplotype
    (wgsim.c:121-160); `--haploid` collapses to one haplotype;
  * per-site mutation rate `-r`; a mutation is a substitution with
    probability 1 - INDEL_FRAC (`-R`), else an indel (50/50 ins/del);
  * indel length extends geometrically with probability `-X`
    (INDEL_EXTEND, wgsim.c:119,150-154; insertions capped at 4 bp like
    the reference's 2-bit-packed insertion word);
  * each fragment is sampled from ONE random haplotype (wgsim.c:327), with
    normal insert length (mean -d, sd -s) and uniform base error -e;
    base qualities encode the error rate (Q = -10 log10 e, wgsim.c:265).

The true fragment start is encoded in the read name (`<id>:Pos=<1-based>`),
compatible with evaluate_sam.py beside it and the reference's SamEvaluation
(which scores the first SAM record per name).  Unlike the reference tool,
the seed is settable (-S), making simulations reproducible.

The port's copy of the repository's `tools/simulate_reads.py`: the same
reads for the same arguments, byte for byte, with the FASTA parser of the
port's index layer.

Usage:
  python -m kart_tpu_torch.tools.simulate_reads ref.fa r1.fq r2.fq \
      [-N reads] [-l len] [-d dist] [-s std] [-e err] [-r mut] \
      [-R indelfrac] [-X indelext] [-S seed] [--haploid]
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np

from ..index.format import parse_fasta


def _mutate_diploid(g: np.ndarray, rng, mut: float, indel_frac: float,
                    indel_extend: float, haploid: bool):
    """wgsim_mut_diref equivalent on one chromosome.

    Returns two haplotypes as aligned marker arrays over reference
    coordinates: (sub (2, L) uint8 base or 0xFF for 'unchanged', del (2, L)
    bool, ins dict[(hap, pos)] -> np.ndarray inserted AFTER pos)."""
    L = len(g)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    code = np.full(256, 4, np.uint8)
    for i, b in enumerate(b"ACGT"):
        code[b] = i
        code[ord(chr(b).lower())] = i
    c_all = code[g]
    sub = np.full((2, L), 0xFF, np.uint8)
    dele = np.zeros((2, L), bool)
    ins: dict = {}
    deleting = 0  # bitmask of haplotypes mid-deletion
    mut_sites = np.nonzero(rng.random(L) < mut)[0]
    # the per-site walk matches the reference's sequential semantics
    # (deletion extension consumes following sites)
    i = 0
    mut_set = set(mut_sites.tolist())
    while i < L:
        c = int(c_all[i])
        if deleting:
            if rng.random() < indel_extend:
                for h in range(2):
                    if deleting & (1 << h):
                        dele[h, i] = True
                i += 1
                continue
            deleting = 0
        if c < 4 and i in mut_set:
            if rng.random() >= indel_frac:  # substitution
                nc = (c + int(rng.random() * 3 + 1)) & 3
                if haploid or rng.random() < 1 / 3:  # hom
                    sub[0, i] = sub[1, i] = bases[nc]
                else:  # het
                    sub[int(rng.random() < 0.5), i] = bases[nc]
            elif rng.random() < 0.5:  # deletion
                if haploid or rng.random() < 1 / 3:  # hom-del
                    dele[0, i] = dele[1, i] = True
                    deleting = 3
                else:  # het-del
                    h = int(rng.random() < 0.5)
                    dele[h, i] = True
                    deleting = 1 << h
            else:  # insertion (1..4 bp, geometric extension)
                n_ins = 1
                while n_ins < 4 and rng.random() < indel_extend:
                    n_ins += 1
                seq_ins = bases[rng.integers(0, 4, size=n_ins)]
                if haploid or rng.random() < 1 / 3:  # hom-ins
                    ins[(0, i)] = seq_ins
                    ins[(1, i)] = seq_ins
                else:
                    ins[(int(rng.random() < 0.5), i)] = seq_ins
        i += 1
    if haploid:
        sub[1] = sub[0]
        dele[1] = dele[0]
    return sub, dele, ins


def _apply_haplotype(g, sub, dele, ins, hap: int):
    """Materialize haplotype `hap` and the ref->hap coordinate map
    (vectorized: the dense sub/del masks apply in bulk; the sparse
    insertions splice in afterwards)."""
    L = len(g)
    keep = ~dele[hap]
    emitted = np.where(sub[hap] != 0xFF, sub[hap], g)
    # coord[i] = emitted bases strictly before ref position i
    coord = np.zeros(L, np.int64)
    np.cumsum(keep[:-1], out=coord[1:])
    base_out = emitted[keep]
    ins_pos = sorted(i for (h, i) in ins if h == hap)
    if ins_pos:
        # splice each insertion right after its (possibly deleted) site
        chunks, prev = [], 0
        extra = np.zeros(L, np.int64)
        added = 0
        for i in ins_pos:
            cut = int(coord[i]) + int(keep[i])
            chunks.append(base_out[prev:cut])
            chunks.append(ins[(hap, i)])
            prev = cut
            if i + 1 < L:
                extra[i + 1] += len(ins[(hap, i)])
        chunks.append(base_out[prev:])
        base_out = np.concatenate(chunks)
        coord = coord + np.cumsum(extra)
    return base_out.astype(np.uint8), coord


def simulate(
    fa: str,
    out1: str,
    out2: str,
    n_reads: int = 2000,
    read_len: int = 150,
    dist: int = 500,
    std: int = 50,
    err: float = 0.01,
    mut: float = 0.001,
    indel_frac: float = 0.15,
    seed: int = 11,
    indel_extend: float = 0.3,
    haploid: bool = False,
) -> None:
    rng = np.random.default_rng(seed)
    seqs = parse_fasta(fa)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)

    # diploid mutation + materialized haplotypes per chromosome
    chroms = []
    for s in seqs:
        g = s.seq.copy()
        sub, dele, ins = _mutate_diploid(g, rng, mut, indel_frac, indel_extend, haploid)
        haps = []
        for h in range(2):
            hs, coord = _apply_haplotype(g, sub, dele, ins, h)
            haps.append((hs, coord))
        chroms.append((s.name, len(g), haps))

    comp = np.full(256, ord("N"), np.uint8)
    for a, b in zip(b"ACGTacgt", b"TGCATGCA"):
        comp[a] = b
    q = "I" if err == 0 else chr(min(73, int(-10.0 * math.log10(err) + 0.499) + 33))
    qline = q * read_len

    w = np.array([L for _, L, _ in chroms], dtype=np.float64)
    n_pairs = n_reads // 2
    with open(out1, "w") as f1, open(out2, "w") as f2:
        written = 0
        while written < n_pairs:
            ci = int(rng.choice(len(chroms), p=w / w.sum()))
            name, L, haps = chroms[ci]
            insert = max(2 * read_len, int(rng.normal(dist, std) + 0.5))
            if L <= insert:
                continue
            p = int(rng.integers(0, L - insert))  # ref coords (truth)
            hs, coord = haps[int(rng.random() < 0.5)]  # random haplotype
            hp = int(coord[p])
            hq = int(coord[p + insert - 1]) + 1
            frag = hs[hp:hq]
            if len(frag) < 2 * read_len:
                continue
            fwd = frag[:read_len].copy()
            rev = comp[frag[-read_len:][::-1]].copy()
            for r in (fwd, rev):
                ne = rng.binomial(read_len, err)
                if ne:
                    ix = rng.integers(0, read_len, ne)
                    r[ix] = bases[rng.integers(0, 4, ne)]
            i = written
            f1.write(f"@{i}:Pos={p + 1}\t/1\n{fwd.tobytes().decode()}\n+\n{qline}\n")
            f2.write(f"@{i}:Pos={p + 1}\t/2\n{rev.tobytes().decode()}\n+\n{qline}\n")
            written += 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ref")
    ap.add_argument("out1")
    ap.add_argument("out2")
    ap.add_argument("-N", type=int, default=2000, help="total reads (pairs*2)")
    ap.add_argument("-l", type=int, default=150, help="read length")
    ap.add_argument("-d", type=int, default=500, help="outer insert distance")
    ap.add_argument("-s", type=int, default=50, help="insert stddev")
    ap.add_argument("-e", type=float, default=0.01, help="base error rate")
    ap.add_argument("-r", type=float, default=0.001, help="mutation rate")
    ap.add_argument("-R", type=float, default=0.15, help="indel fraction of mutations")
    ap.add_argument("-X", type=float, default=0.3, help="indel extension probability")
    ap.add_argument("-S", type=int, default=11, help="random seed")
    ap.add_argument("--haploid", action="store_true", help="one haplotype (wgsim -h)")
    a = ap.parse_args()
    simulate(a.ref, a.out1, a.out2, a.N, a.l, a.d, a.s, a.e, a.r, a.R, a.S,
             indel_extend=a.X, haploid=a.haploid)
    return 0


if __name__ == "__main__":
    sys.exit(main())
