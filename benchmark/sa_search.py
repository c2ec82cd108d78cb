"""The plain reference's own index: the suffix array of the genome's text
and the searches that Kart's seeding makes in it, in plain torch (any
device).  Nothing here comes from the port.

The text is the genome's forward strand followed by its reverse
complement, as Kart's index holds it (bwt_index.cpp); its suffix array has
the empty suffix first.  A search at a read position finds the longest
prefix of the read from there (up to a stop, and never past an ambiguous
base) that occurs in the text, and the rows of the suffix array whose
suffixes start with it: BWT_Search's (length, interval) of Kart's
bwt_search.cpp, worked out by binary search over the sorted suffixes.

Bases are compared 21 at a time: a suffix's `WORD_BASES` bases from
position i are one int64, 3 bits a base (A C G T = 1 2 3 4, 0 past the
text's end), the first base in the highest bits, so that integer order is
the text's order and the end of the text sorts first.
"""

from __future__ import annotations

import math

import numpy as np
import torch

WORD_BASES = 21
_SHIFTS = torch.tensor([3 * (WORD_BASES - 1 - b) for b in range(WORD_BASES)], dtype=torch.int64)
# MASK[c]: the top c bases of a word
MASK = torch.tensor([((1 << (3 * c)) - 1) << (3 * (WORD_BASES - c)) for c in range(WORD_BASES + 1)],
                    dtype=torch.int64)


def text_of(genome_codes: np.ndarray) -> np.ndarray:
    """Forward strand then its reverse complement, 2-bit codes."""
    g = genome_codes.astype(np.uint8)
    return np.concatenate([g, (3 - g)[::-1]])


def suffix_array(text: torch.Tensor) -> torch.Tensor:
    """Suffix array (n + 1,) int64 of a code text (n,) by prefix doubling;
    row 0 is the empty suffix (position n)."""
    dev = text.device
    n1 = text.shape[0] + 1
    rank = torch.zeros(n1, dtype=torch.int64, device=dev)
    rank[:-1] = text.long() + 1
    k = 1
    while True:
        nxt = torch.zeros(n1, dtype=torch.int64, device=dev)
        nxt[: n1 - k] = rank[k:]
        key = rank * (n1 + 1) + nxt
        sa = torch.argsort(key)
        sk = key[sa]
        new = torch.zeros(n1, dtype=torch.int64, device=dev)
        new[1:] = torch.cumsum(sk[1:] != sk[:-1], 0)
        rank = torch.empty_like(new)
        rank[sa] = new
        if int(new[-1]) == n1 - 1:
            return sa
        k *= 2


def words_of(codes: torch.Tensor, pad: int) -> torch.Tensor:
    """Per position i of the last axis of `codes` (values 0-3, anything
    else ends the sequence there for this purpose as past-the-end), the
    int64 word of bases i .. i+20 (3 bits each, 0 past the end); `pad`
    zero words follow."""
    c = codes.long()
    v = torch.where((c >= 0) & (c <= 3), c + 1, 0)
    shape = v.shape[:-1]
    n = v.shape[-1]
    z = torch.zeros((*shape, n + pad + WORD_BASES), dtype=torch.int64, device=v.device)
    z[..., :n] = v
    out = torch.zeros((*shape, n + pad), dtype=torch.int64, device=v.device)
    for j in range(WORD_BASES):
        out |= z[..., j : j + n + pad] << (3 * (WORD_BASES - 1 - j))
    return out


class SuffixIndex:
    """The text's suffix array and its words, on one device."""

    def __init__(self, text_codes: np.ndarray, sa: np.ndarray, dev, max_bases: int):
        self.n = len(text_codes)
        self.sa = torch.from_numpy(np.ascontiguousarray(sa)).to(dev).long()
        if self.sa.shape[0] != self.n + 1:
            raise ValueError("the suffix array does not fit the text")
        self.max_words = -(-max_bases // WORD_BASES)
        self.words = words_of(torch.from_numpy(text_codes).to(dev), WORD_BASES * self.max_words + 1)
        self.dev = dev
        self.mask = MASK.to(dev)
        self.shifts = _SHIFTS.to(dev)

    def _masks(self, m: torch.Tensor, nw: int) -> torch.Tensor:
        """(M, nw) word masks of the first m bases."""
        c = (m[:, None] - WORD_BASES * torch.arange(nw, device=self.dev)[None, :]).clamp(0, WORD_BASES)
        return self.mask[c]

    def _suffix_words(self, rows: torch.Tensor, nw: int) -> torch.Tensor:
        s = self.sa[rows]
        return self.words[s[:, None] + WORD_BASES * torch.arange(nw, device=self.dev)[None, :]]

    def _compare(self, rows, q, masks) -> torch.Tensor:
        """Sign of (suffix at row, cut to the masks) - (query q): -1, 0, 1."""
        d = torch.sign((self._suffix_words(rows, q.shape[1]) & masks) - q)
        first = torch.argmax((d != 0).int(), dim=1)
        return d.gather(1, first[:, None])[:, 0]

    def _bound(self, q, m, upper: bool) -> torch.Tensor:
        """The first row whose suffix, cut to m bases, is >= (upper: >) the
        query's first m bases."""
        masks = self._masks(m, q.shape[1])
        qm = q & masks
        M = q.shape[0]
        lo = torch.zeros(M, dtype=torch.int64, device=self.dev)
        hi = torch.full((M,), self.n + 1, dtype=torch.int64, device=self.dev)
        for _ in range(math.ceil(math.log2(self.n + 2)) + 1):
            mid = (lo + hi) // 2
            c = self._compare(mid.clamp(max=self.n), qm, masks)
            right = (c > 0) if upper else (c >= 0)
            act = lo < hi
            hi = torch.where(act & right, mid, hi)
            lo = torch.where(act & ~right, mid + 1, lo)
        return lo

    def _lcp(self, rows, q, m) -> torch.Tensor:
        """Common prefix (bases) of the query's first m bases and the
        suffix at each row (0 where the row is past the last)."""
        ok = rows <= self.n
        masks = self._masks(m, q.shape[1])
        x = (self._suffix_words(rows.clamp(0, self.n), q.shape[1]) & masks) ^ (q & masks)
        nz = x != 0
        first = torch.argmax(nz.int(), dim=1)
        xw = x.gather(1, first[:, None])[:, 0]
        groups = (xw[:, None] >> self.shifts[None, :]) & 7
        lead = torch.argmax((groups != 0).int(), dim=1)
        lcp = torch.where(nz.any(1), WORD_BASES * first + lead, m)
        return torch.where(ok, torch.minimum(lcp, m), 0)

    def search(self, q: torch.Tensor, qlen: torch.Tensor, min_len: int):
        """Per query (words q (M, nw), length qlen >= 1): the longest prefix
        that occurs in the text -> (length, lo, hi), [lo, hi) its rows;
        lo = hi = 0 where the length is under min_len."""
        ip = self._bound(q, qlen, upper=False)
        best = torch.maximum(self._lcp(ip - 1, q, qlen), self._lcp(ip, q, qlen))
        lo = torch.zeros_like(ip)
        hi = torch.zeros_like(ip)
        long_ = best >= min_len
        if bool(long_.any()):
            idx = torch.nonzero(long_)[:, 0]
            lo[idx] = self._bound(q[idx], best[idx], upper=False)
            hi[idx] = self._bound(q[idx], best[idx], upper=True)
        return best, lo, hi


def read_words(reads: torch.Tensor, nw: int) -> torch.Tensor:
    """(B, l_max + ...) words of every position of (B, l_max) read codes
    (ambiguous and pad codes > 3 are 0 there, and never inside a query)."""
    return words_of(reads, WORD_BASES * nw + 1)


def query_words(rw: torch.Tensor, r: torch.Tensor, p: torch.Tensor, nw: int) -> torch.Tensor:
    """(M, nw) words of the queries starting at read r, position p."""
    return rw[r[:, None], p[:, None] + WORD_BASES * torch.arange(nw, device=rw.device)[None, :]]


def next_ambiguous(reads: torch.Tensor, rlens: torch.Tensor) -> torch.Tensor:
    """(B, l_max + 1): the first position >= i holding an ambiguous base or
    the read's end."""
    B, L = reads.shape
    pos = torch.arange(L, device=reads.device)[None, :].expand(B, L)
    stop = (reads > 3) | (pos >= rlens[:, None].long())
    big = torch.full((B, L + 1), L, dtype=torch.int64, device=reads.device)
    big[:, :L] = torch.where(stop, pos, L)
    return torch.flip(torch.cummin(torch.flip(big, [1]), 1).values, [1])


def expand(sa: torch.Tensor, read: torch.Tensor, rpos: torch.Tensor, slen: torch.Tensor,
           lo: torch.Tensor, hi: torch.Tensor, n_reads: int):
    """Seed records in emission order (sorted by read, then rpos) -> per
    read counts and the flat (rpos, slen, gpos) of their occurrences, each
    seed's in suffix-array row order."""
    freq = hi - lo
    order = torch.argsort(read * (1 << 20) + rpos)
    read, rpos, slen, lo, freq = read[order], rpos[order], slen[order], lo[order], freq[order]
    cnt = torch.zeros(n_reads, dtype=torch.int64, device=sa.device)
    cnt.scatter_add_(0, read, freq)
    rep = torch.repeat_interleave(torch.arange(freq.shape[0], device=sa.device), freq)
    start = torch.cumsum(freq, 0) - freq
    j = torch.arange(rep.shape[0], device=sa.device) - start[rep]
    return cnt, rpos[rep], slen[rep], sa[lo[rep] + j]
