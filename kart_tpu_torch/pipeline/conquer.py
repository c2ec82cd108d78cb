"""Conquer step: close normal pairs (gapped fragments) into alignments.

Mirrors the reference exactly:
- Needleman-Wunsch with the reference's 3-matrix float scoring and backtrace
  tie-break order (reference: src/nw_alignment.cpp:18-80)
- 8-mer fragment repartitioning (reference: src/KmerAnalysis.cpp)
- head/tail/middle fragment processing with mismatch shortcuts, soft-clip
  rules and local-quality rejection (reference: src/tools.cpp:142-397)

Fragments here are tiny (avg ~20 bp), so the NumPy antidiagonal NW below is
the host path; bulk batches go to the device NW kernel (ops/nw.py).
All float arithmetic is float32 to match C float comparisons bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from ..index.format import NT4_TABLE
from .candidates import Seed, identify_normal_pairs

KMER_SIZE = 8
KMER_POWER = 0x3FFF

MAX_PENALTY = np.float32(-65536)
OPEN_GAP = np.float32(-1)
EXTEND_GAP = np.float32(-0.5)
NEW_GAP = np.float32(-1.5)


def nw_alignment(s1: bytes, s2: bytes) -> tuple[bytes, bytes]:
    """Global alignment returning gapped strings, bit-exact with the
    reference nw_alignment (float32 DP, backtrace prefers r then t)."""
    m, n = len(s1) + 1, len(s2) + 1
    r = np.empty((m, n), np.float32)
    t = np.empty((m, n), np.float32)
    s = np.empty((m, n), np.float32)
    r[0, 0] = t[0, 0] = s[0, 0] = 0
    ii = np.arange(1, m, dtype=np.float32)
    r[1:, 0] = MAX_PENALTY
    s[1:, 0] = t[1:, 0] = OPEN_GAP + ii * EXTEND_GAP
    jj = np.arange(1, n, dtype=np.float32)
    t[0, 1:] = MAX_PENALTY
    s[0, 1:] = r[0, 1:] = OPEN_GAP + jj * EXTEND_GAP

    c1 = NT4_TABLE[np.frombuffer(s1, dtype=np.uint8)]
    c2 = NT4_TABLE[np.frombuffer(s2, dtype=np.uint8)]
    sub = np.where(c1[:, None] == c2[None, :], np.float32(1.5), np.float32(-1.5))

    # antidiagonal sweep: all cells on diag d depend on d-1 (r,t) and d-2 (s)
    for d in range(2, m + n - 1):
        lo = max(1, d - (n - 1))
        hi = min(m - 1, d - 1)
        i = np.arange(lo, hi + 1)
        j = d - i
        rv = np.maximum(r[i, j - 1] + EXTEND_GAP, s[i, j - 1] + NEW_GAP)
        tv = np.maximum(t[i - 1, j] + EXTEND_GAP, s[i - 1, j] + NEW_GAP)
        sv = np.maximum(np.maximum(s[i - 1, j - 1] + sub[i - 1, j - 1], rv), tv)
        r[i, j] = rv
        t[i, j] = tv
        s[i, j] = sv

    # backtrace (r first, then t — nw_alignment.cpp:61-68)
    out1 = bytearray()
    out2 = bytearray()
    i, j = m - 1, n - 1
    while i > 0 or j > 0:
        if s[i, j] == r[i, j]:
            out1.append(0x2D)  # '-'
            out2.append(s2[j - 1])
            j -= 1
        elif s[i, j] == t[i, j]:
            out1.append(s1[i - 1])
            out2.append(0x2D)
            i -= 1
        else:
            out1.append(s1[i - 1])
            out2.append(s2[j - 1])
            i -= 1
            j -= 1
    out1.reverse()
    out2.reverse()
    return bytes(out1), bytes(out2)


# ---------------------------------------------------------------------------
# 8-mer fragment repartition (KmerAnalysis.cpp)
# ---------------------------------------------------------------------------


def create_kmer_vec(seq: bytes) -> list[tuple[int, int]]:
    """CreateKmerVecFromReadSeq (KmerAnalysis.cpp:56-102): rolling 8-mer ids
    (wid, pos), restarting after 'N' chars, sorted by wid."""
    length = len(seq)
    vec: list[tuple[int, int]] = []
    tail = 0
    count = 0
    while count < KMER_SIZE and tail < length:
        if seq[tail] != 0x4E:  # 'N'
            count += 1
        else:
            count = 0
        tail += 1
    if count == KMER_SIZE:
        head = tail - KMER_SIZE
        wid = 0
        for q in range(head, head + KMER_SIZE):
            wid = (wid << 2) + int(NT4_TABLE[seq[q]])
        vec.append((wid, head))
        head += 1
        while tail < length:
            if seq[tail] != 0x4E:
                wid = ((wid & KMER_POWER) << 2) + int(NT4_TABLE[seq[tail]])
                vec.append((wid, head))
                head += 1
                tail += 1
            else:
                count = 0
                tail += 1
                while count < KMER_SIZE and tail < length:
                    if seq[tail] != 0x4E:
                        count += 1
                    else:
                        count = 0
                    tail += 1
                if count == KMER_SIZE:
                    head = tail - KMER_SIZE
                    wid = 0
                    for q in range(head, head + KMER_SIZE):
                        wid = (wid << 2) + int(NT4_TABLE[seq[q]])
                    vec.append((wid, head))
                    # the reference's for-increment advances BOTH head and
                    # tail after an N-restart, skipping one input char
                    # (KmerAnalysis.cpp:74,91-95) — replicated for parity
                    head += 1
                    tail += 1
                else:
                    break
        vec.sort(key=lambda x: x[0])
    return vec


def identify_common_kmers(max_shift: int, vec1, vec2) -> list[tuple[int, int, int]]:
    """IdentifyCommonKmers (KmerAnalysis.cpp:104-130): (posdiff, rpos, gpos)
    sorted by (posdiff, rpos)."""
    import bisect

    wids2 = [w for w, _ in vec2]
    out = []
    for wid, rpos in vec1:
        k = bisect.bisect_left(wids2, wid)
        while k < len(vec2) and vec2[k][0] == wid:
            gpos = vec2[k][1]
            if (gpos >= rpos and gpos - rpos < max_shift) or (
                gpos < rpos and rpos - gpos < max_shift
            ):
                out.append((gpos - rpos, rpos, gpos))
            k += 1
    out.sort(key=lambda x: (x[0], x[1]))
    return out


def simple_pairs_from_common_kmers(min_seed_len: int, pairs) -> list[Seed]:
    """GenerateSimplePairsFromCommonKmers (KmerAnalysis.cpp:132-162): merge
    runs of rPos-consecutive, equal-PosDiff kmers."""
    out: list[Seed] = []
    num = len(pairs)
    i = 0
    while i < num:
        pd, rpos, gpos = pairs[i]
        n_pos = rpos + 1
        j = i + 1
        while j < num:
            if pairs[j][1] != n_pos or pairs[j][0] != pd:
                break
            n_pos += 1
            j += 1
        length = KMER_SIZE + (j - 1 - i)
        if length >= min_seed_len:
            out.append(Seed(True, rpos, gpos, length, length, pd))
        i = j
    return out


def simple_pairs_from_fragment_pair(max_dist: int, frag1: bytes, frag2: bytes) -> list[Seed]:
    """GenerateSimplePairsFromFragmentPair (KmerAnalysis.cpp:164-179)."""
    vec1 = create_kmer_vec(frag1)
    vec2 = create_kmer_vec(frag2)
    pairs = identify_common_kmers(max_dist, vec1, vec2)
    out = simple_pairs_from_common_kmers(8, pairs)
    out.sort(key=lambda s: (s.gpos, s.rpos))
    return out


# ---------------------------------------------------------------------------
# Fragment processing (tools.cpp)
# ---------------------------------------------------------------------------


def count_mismatches(a: bytes, b: bytes) -> int:
    # CalFragPairMismatchBases: raw byte comparison (tools.cpp:40-47)
    return sum(1 for x, y in zip(a, b) if x != y)


def add_new_cigar_elements(a1: bytes, a2: bytes, cigar: list) -> int:
    """AddNewCigarElements (tools.cpp:49-104): aligned strings -> cigar ops,
    returns the number of matched bases."""
    state = "*"
    c = 0
    score = 0
    for x, y in zip(a1, a2):
        if x == 0x2D:
            op = "D"
        elif y == 0x2D:
            op = "I"
        else:
            if x == y:
                score += 1
            op = "M"
        if op == state:
            c += 1
        else:
            if c > 0:
                cigar.append((c, state))
            c = 1
            state = op
    if c > 0:
        cigar.append((c, state))
    return score


def check_local_alignment_quality(a1: bytes, a2: bytes) -> bool:
    """CheckLocalAlignmentQuality (tools.cpp:255-290): reject alignments with
    >= 4 state switches or >= 30% mismatches (min 3)."""
    aln_type = -1
    n = mis = status = 0
    for x, y in zip(a1, a2):
        if x == 0x2D:
            if aln_type != 0:
                aln_type = 0
                status += 1
        elif y == 0x2D:
            if aln_type != 1:
                aln_type = 1
                status += 1
        else:
            n += 1
            if x != y:
                mis += 1
            if aln_type != 2:
                aln_type = 2
                status += 1
    if status >= 4 or (mis >= 3 and mis >= int(n * 0.3)):
        return False
    return True


class Conquer:
    """Fragment-pair alignment with the reference's divide-and-conquer
    recursion.  Holds the decoded genome text and mode flags.

    Batched-NW support: every NW goes through `_nw`.  A chunk loop can
    run the report pass twice — first with `collecting` set (NW inputs are
    recorded and answered with a placeholder alignment; outputs discarded),
    then with `nw_memo` filled by one device NW batch (ops/nw.py) so the
    replay pass never runs the host DP.  NW inputs are deterministic
    functions of the fragment pairs (repartition precedes NW; decisions
    follow it), which makes the collect pass exact.  An NW that the
    replay pass answers without the memo is counted in `nw_memo_misses`
    (it still runs the host DP, so the alignment is right either way): a
    silent miss would hide the device kernel."""

    def __init__(self, ref_seq: np.ndarray, pacbio: bool, max_gaps: int):
        self.ref_seq = ref_seq  # ASCII uint8 of fwd+rc genome
        self.pacbio = pacbio
        self.max_gaps = max_gaps
        self.nw_memo: dict | None = None
        self.collecting: set | None = None
        self.nw_memo_misses = 0

    def _nw(self, s1: bytes, s2: bytes) -> tuple[bytes, bytes]:
        if self.collecting is not None:
            self.collecting.add((s1, s2))
            # placeholder with a valid alignment shape; collect-pass output
            # is discarded
            return s1 + b"-" * len(s2), b"-" * len(s1) + s2
        if self.nw_memo is not None:
            hit = self.nw_memo.get((s1, s2))
            if hit is not None:
                return hit
        self.nw_memo_misses += 1
        return nw_alignment(s1, s2)

    def genome_frag(self, gpos: int, glen: int) -> bytes:
        return self.ref_seq[gpos : gpos + glen].tobytes()

    def normal_pair_alignment(self, rlen: int, frag1: bytes, glen: int, frag2: bytes):
        """GenerateNormalPairAlignment (tools.cpp:142-223)."""
        run_nw = True
        if rlen > 30 and glen > 30:
            if self.pacbio:
                max_shift = int(rlen * 0.2) if rlen > glen else int(glen * 0.2)
                if max_shift > 50:
                    max_shift = 50
            else:
                max_shift = self.max_gaps
            parts = simple_pairs_from_fragment_pair(max_shift, frag1, frag2)
            if parts:
                parts = identify_normal_pairs(rlen, glen, parts)
            if parts:
                run_nw = False
                a1 = bytearray()
                a2 = bytearray()
                for p in parts:
                    if p.rlen == 0 and p.glen == 0:
                        continue
                    if p.glen == 0:
                        a1 += frag1[p.rpos : p.rpos + p.rlen]
                        a2 += b"-" * p.rlen
                    elif p.rlen == 0:
                        a1 += b"-" * p.glen
                        a2 += frag2[p.gpos : p.gpos + p.glen]
                    elif p.rlen == 1 and p.glen == 1:
                        a1 += frag1[p.rpos : p.rpos + 1]
                        a2 += frag2[p.gpos : p.gpos + 1]
                    else:
                        str1 = frag1[p.rpos : p.rpos + p.rlen]
                        str2 = frag2[p.gpos : p.gpos + p.glen]
                        if not p.simple:
                            if self.pacbio and (p.rlen > 300 or p.glen > 300):
                                str1, str2 = self.normal_pair_alignment(
                                    p.rlen, str1, p.glen, str2
                                )
                            else:
                                str1, str2 = self._nw(str1, str2)
                        a1 += str1
                        a2 += str2
                return bytes(a1), bytes(a2)
        if run_nw:
            return self._nw(frag1, frag2)

    def process_normal(self, seq: bytes, sp: Seed, cigar: list) -> int:
        """ProcessNormalSequencePair (tools.cpp:225-253)."""
        if sp.rlen == 0 or sp.glen == 0:
            if sp.rlen > 0:
                cigar.append((sp.rlen, "I"))
            elif sp.glen > 0:
                cigar.append((sp.glen, "D"))
            return 0
        frag1 = seq[sp.rpos : sp.rpos + sp.rlen]
        frag2 = self.genome_frag(sp.gpos, sp.glen)
        if sp.rlen == sp.glen:
            n = count_mismatches(frag1, frag2)
            if n <= 2 and n <= int(sp.rlen * 0.2):
                cigar.append((sp.rlen, "M"))
                return sp.rlen - n
        a1, a2 = self.normal_pair_alignment(sp.rlen, frag1, sp.glen, frag2)
        return add_new_cigar_elements(a1, a2, cigar)

    def process_head(self, seq: bytes, sp: Seed, cigar: list) -> int:
        """ProcessHeadSequencePair (tools.cpp:292-342). Mutates sp on gap
        trimming."""
        frag1 = seq[sp.rpos : sp.rpos + sp.rlen]
        frag2 = self.genome_frag(sp.gpos, sp.glen)
        if not self.pacbio and sp.rlen == sp.glen:
            n = count_mismatches(frag1, frag2)
            if n <= 2 and n <= int(sp.rlen * 0.2):
                cigar.append((sp.rlen, "M"))
                return sp.rlen - n
        if not self.pacbio and sp.rlen > 50:
            cigar.append((sp.rlen, "S"))
            return 0
        a1, a2 = self.normal_pair_alignment(sp.rlen, frag1, sp.glen, frag2)
        if not check_local_alignment_quality(a1, a2):
            cigar.append((sp.rlen, "S"))
            return 0
        # Case 1: leading gaps in the read block -> shrink genome block
        p = 0
        while p < len(a1) and a1[p] == 0x2D:
            p += 1
        if p > 0:
            a1 = a1[p:]
            a2 = a2[p:]
            sp.gpos += p
            sp.glen -= p
        # Case 2: leading gaps in the genome block -> shrink read block (S)
        p = 0
        while p < len(a2) and a2[p] == 0x2D:
            p += 1
        if p > 0:
            a1 = a1[p:]
            a2 = a2[p:]
            sp.rpos += p
            sp.rlen -= p
            cigar.append((p, "S"))
        return add_new_cigar_elements(a1, a2, cigar)

    def process_tail(self, seq: bytes, sp: Seed, cigar: list) -> int:
        """ProcessTailSequencePair (tools.cpp:344-397). Mutates sp on gap
        trimming."""
        frag1 = seq[sp.rpos : sp.rpos + sp.rlen]
        frag2 = self.genome_frag(sp.gpos, sp.glen)
        if not self.pacbio and sp.rlen == sp.glen:
            n = count_mismatches(frag1, frag2)
            if n <= 2 and n <= int(sp.rlen * 0.2):
                cigar.append((sp.rlen, "M"))
                return sp.rlen - n
        if not self.pacbio and sp.rlen > 100:
            cigar.append((sp.rlen, "S"))
            return 0
        a1, a2 = self.normal_pair_alignment(sp.rlen, frag1, sp.glen, frag2)
        if not check_local_alignment_quality(a1, a2):
            cigar.append((sp.rlen, "S"))
            return 0
        # Case 1: trailing gaps in the read block -> shrink genome block
        c = 0
        p = len(a1) - 1
        while p >= 0 and a1[p] == 0x2D:
            c += 1
            p -= 1
        if c > 0:
            a1 = a1[: len(a1) - c]
            a2 = a2[: len(a2) - c]
            sp.glen -= c
        # Case 2: trailing gaps in the genome block -> shrink read block
        c = 0
        p = len(a2) - 1
        while p >= 0 and a2[p] == 0x2D:
            c += 1
            p -= 1
        if c > 0:
            a1 = a1[: len(a1) - c]
            a2 = a2[: len(a2) - c]
            sp.rlen -= c
        score = add_new_cigar_elements(a1, a2, cigar)
        if c > 0:
            cigar.append((c, "S"))
        return score
