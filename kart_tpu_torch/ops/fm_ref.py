"""Host (NumPy) reference model of the FM-index search.

This is the executable spec of the reference's backward-search semantics
(reference: src/bwt_search.cpp:44-184) used by unit tests to validate the
batched device kernels, and as a slow fallback path.  All arithmetic mirrors
the reference exactly, including the primary-row adjustment and the
complement-interval bookkeeping of BWT_Search.
"""

from __future__ import annotations

import numpy as np

OCC_THR = 50
OCC_INTV_SHIFT = 7
OCC_INTERVAL = 1 << OCC_INTV_SHIFT
OCC_INTV_MASK = OCC_INTERVAL - 1


class FMIndexRef:
    def __init__(self, occ_cp, bwt_words, L2, primary, seq_len, sa_samples, sa_intv):
        self.occ_cp = np.asarray(occ_cp, dtype=np.int64)  # (n_blocks, 4)
        self.words = np.asarray(bwt_words, dtype=np.uint32)  # (n_blocks, 8)
        self.L2 = np.asarray(L2, dtype=np.int64)  # (5,)
        self.primary = int(primary)
        self.seq_len = int(seq_len)
        self.sa = np.asarray(sa_samples, dtype=np.int64)
        self.sa_intv = int(sa_intv)

    # -- low-level ----------------------------------------------------------

    def _word(self, k: int) -> int:
        """BWT word containing (primary-adjusted) position k."""
        return int(self.words[k >> 7, (k & 0x7F) >> 4])

    def bwt_char(self, k: int) -> int:
        """bwt_B0: 2-bit code at primary-adjusted position k."""
        return (self._word(k) >> ((~k & 0xF) << 1)) & 3

    @staticmethod
    def _count_word(w: int, c: int) -> int:
        """Number of positions with code c in a 32-bit word (16 bases)."""
        y = w & 0xFFFFFFFF
        y2 = y if (c & 2) else ~y
        y1 = y if (c & 1) else ~y
        m = (y2 >> 1) & y1 & 0x55555555
        return bin(m & 0x55555555).count("1")

    def occ(self, k: int, c: int) -> int:
        """bwt_occ(k, c): #occurrences of c in bwt[0..k] (k inclusive),
        with the reference's sentinel-position handling."""
        if k == self.seq_len:
            return int(self.L2[c + 1] - self.L2[c])
        if k == -1:
            return 0
        k -= k >= self.primary
        blk = k >> 7
        n = int(self.occ_cp[blk, c])
        # whole words before the word containing k
        jk = (k & 0x7F) >> 4
        for j in range(jk):
            n += self._count_word(int(self.words[blk, j]), c)
        # partial word: mask off bits after k
        w = int(self.words[blk, jk]) & ~((1 << ((~k & 0xF) << 1)) - 1) & 0xFFFFFFFF
        n += self._count_word(w, c)
        if c == 0:
            n -= ~k & 0xF  # masked-out positions counted as code 0
        return n

    def occ4(self, k: int) -> np.ndarray:
        """bwt_occ4(k): counts of all 4 codes in bwt[0..k]."""
        if k == -1:
            return np.zeros(4, dtype=np.int64)
        k -= k >= self.primary
        blk = k >> 7
        cnt = self.occ_cp[blk].copy()
        jk = (k & 0x7F) >> 4
        for j in range(jk):
            w = int(self.words[blk, j])
            for c in range(4):
                cnt[c] += self._count_word(w, c)
        w = int(self.words[blk, jk]) & ~((1 << ((~k & 0xF) << 1)) - 1) & 0xFFFFFFFF
        for c in range(4):
            cnt[c] += self._count_word(w, c)
        cnt[0] -= ~k & 0xF
        return cnt

    def inv_psi(self, k: int) -> int:
        """bwt_invPsi: previous-text-position row."""
        x = k - (k > self.primary)
        c = self.bwt_char(x)
        x = int(self.L2[c]) + self.occ(k, c)
        return 0 if k == self.primary else x

    def sa_lookup(self, k: int) -> int:
        """bwt_sa: resolve BWT row k to a text position via the sampled SA."""
        mask = self.sa_intv - 1
        add = 0
        while k & mask:
            add += 1
            k = self.inv_psi(k)
        return add + int(self.sa[k // self.sa_intv])

    # -- search -------------------------------------------------------------

    def search(self, seq: np.ndarray, start: int, stop: int, min_seed_len: int):
        """BWT_Search: maximal exact extension of seq[start:stop] (2-bit
        codes; >3 = ambiguous).  Returns (length, freq, locations)."""
        p = int(seq[start])
        x0 = int(self.L2[p]) + 1
        x1 = int(self.L2[3 - p]) + 1
        x2 = int(self.L2[p + 1] - self.L2[p])
        pos = start + 1
        while pos < stop:
            if seq[pos] > 3:
                break
            tk = self.occ4(x1 - 1)
            tl = self.occ4(x1 - 1 + x2)
            ok_x1 = self.L2[:4] + 1 + tk
            ok_x2 = tl - tk
            ok_x0 = np.zeros(4, dtype=np.int64)
            ok_x0[3] = x0 + (x1 <= self.primary and x1 + x2 - 1 >= self.primary)
            ok_x0[2] = ok_x0[3] + ok_x2[3]
            ok_x0[1] = ok_x0[2] + ok_x2[2]
            ok_x0[0] = ok_x0[1] + ok_x2[1]
            i = 3 - int(seq[pos])
            if ok_x2[i] == 0:
                break
            x0, x1, x2 = int(ok_x0[i]), int(ok_x1[i]), int(ok_x2[i])
            pos += 1
        length = pos - start
        if length < min_seed_len:
            return length, 0, np.zeros(0, dtype=np.int64)
        freq = x2
        if freq > OCC_THR:
            return length, 0, np.zeros(0, dtype=np.int64)
        locs = np.array([self.sa_lookup(x0 + i) for i in range(freq)], dtype=np.int64)
        return length, freq, locs


def identify_seed_pairs_fast(fm: FMIndexRef, seq: np.ndarray, min_seed_len: int):
    """Host emulation of IdentifySeedPairs_FastMode (reference:
    src/AlignmentCandidates.cpp:49-80), before the PosDiff sort.
    Returns list of (rpos, length, gpos) in emission order."""
    rlen = len(seq)
    out = []
    pos, end_pos = 0, rlen - min_seed_len
    while pos < end_pos:
        if seq[pos] > 3:
            pos += 1
            continue
        length, freq, locs = fm.search(seq, pos, rlen, min_seed_len)
        for loc in locs:
            out.append((pos, length, int(loc)))
        pos += length + 1
    return out


def fm_from_genome_index(gidx) -> FMIndexRef:
    r = gidx.raw
    return FMIndexRef(
        r.occ_cp, r.bwt_words, r.L2, r.primary, r.seq_len, r.sa_samples, r.sa_intv
    )
