"""Offline genome index construction (the `kart-tpu index` subcommand).

Replaces the reference's BWT-SW incremental construction (reference:
src/BWT_Index/bwtindex.c:77-149, bwt_gen.c) with a direct suffix-array
construction (C++ SA-IS, kart_tpu_torch/native/sais.cpp) followed by a vectorized
BWT/Occ/SA-sample derivation in NumPy.  The resulting .bwt/.sa/.pac/.ann/.amb
files are byte-identical to the reference indexer's output, including the
fixed-seed lrand48 replacement of ambiguous bases (bntseq.c:144,173-174).
"""

from __future__ import annotations

import numpy as np

from ..native import suffix_array
from .drand48 import Drand48
from .format import (
    NT4_TABLE,
    SA_INTERVAL,
    FastaSeq,
    interleave_bwt,
    parse_fasta,
    write_ann_amb,
    write_bwt,
    write_pac,
    write_sa,
)


def encode_forward(seqs: list[FastaSeq]):
    """Encode all sequences to 2-bit codes, replacing ambiguous bases with
    lrand48()&3 (seed 11), and collect amb holes exactly like the reference
    packer (bntseq.c add1)."""
    rng = Drand48(seed=11)
    parts = []
    holes = []  # (offset, len, char)
    n_ambs_per_seq = []
    offset = 0
    last_char = 0  # `lasts` carries across sequences in the reference code? No:
    # add1 initializes lasts=0 per call, so holes never span sequences.
    for s in seqs:
        codes = NT4_TABLE[s.seq].copy()
        amb = codes >= 4
        n_amb = int(amb.sum())
        if n_amb:
            idx = np.nonzero(amb)[0]
            chars = s.seq[idx]
            # hole boundaries: non-contiguous position or different raw char
            new_hole = np.ones(len(idx), dtype=bool)
            if len(idx) > 1:
                new_hole[1:] = (idx[1:] != idx[:-1] + 1) | (chars[1:] != chars[:-1])
            starts = np.nonzero(new_hole)[0]
            ends = np.append(starts[1:], len(idx))
            n_holes_here = 0
            for a, b in zip(starts, ends):
                holes.append((offset + int(idx[a]), int(b - a), chr(int(chars[a]))))
                n_holes_here += 1
            codes[idx] = (rng.lrand48_array(n_amb) & 3).astype(np.uint8)
            n_ambs_per_seq.append(n_holes_here)
        else:
            n_ambs_per_seq.append(0)
        parts.append(codes)
        offset += len(codes)
    fwd = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    return fwd, holes, n_ambs_per_seq


def build_index(fasta_path: str, prefix: str, verbose: bool = True) -> None:
    seqs = parse_fasta(fasta_path)
    if not seqs:
        raise ValueError(f"no sequences found in {fasta_path}")
    if verbose:
        print(f"[kart-tpu index] Packing {len(seqs)} sequence(s) from {fasta_path}...")
    fwd, holes, n_ambs = encode_forward(seqs)
    l_pac = len(fwd)
    text = np.concatenate([fwd, (3 - fwd)[::-1]])  # forward + reverse complement
    seq_len = len(text)

    if verbose:
        print(f"[kart-tpu index] Building suffix array over {seq_len} bases...")
    sa_full = suffix_array(text + 1)  # length seq_len+1, sa_full[0] == seq_len

    if verbose:
        print("[kart-tpu index] Deriving BWT / Occ / SA samples...")
    primary = int(np.nonzero(sa_full == 0)[0][0])
    # BWT char of row r is text[sa[r]-1]; the sentinel row (sa==0) is omitted
    # and recorded as `primary` (reference: src/BWT_Index convention).
    bwt_all = text[(sa_full - 1) % seq_len]
    mask = np.ones(seq_len + 1, dtype=bool)
    mask[primary] = False
    bwt_codes = bwt_all[mask]

    counts = np.bincount(text, minlength=4).astype(np.int64)
    l2 = np.zeros(5, dtype=np.int64)
    l2[1:] = np.cumsum(counts)

    _, _, payload = interleave_bwt(bwt_codes)
    write_bwt(prefix, primary, l2, payload)

    n_sa = seq_len // SA_INTERVAL + 1
    sa_samples = sa_full[::SA_INTERVAL][:n_sa].copy()
    sa_samples[0] = -1
    write_sa(prefix, primary, l2, seq_len, sa_samples)

    write_pac(prefix, fwd)
    write_ann_amb(prefix, l_pac, list(zip(seqs, n_ambs)), holes, seed=11)

    # device sidecar: full suffix array (our own extension).  sa_full[k] equals
    # bwt_sa(k) for every BWT row k >= 1, turning suffix-array resolution on
    # device into a single gather instead of an unbounded inverse-Psi walk.
    dtype = np.int32 if seq_len < 2**31 else np.int64
    with open(prefix + ".saf", "wb") as f:
        np.save(f, sa_full.astype(dtype))
    if verbose:
        print(f"[kart-tpu index] Done: {prefix}.{{bwt,sa,pac,ann,amb,saf}}")
