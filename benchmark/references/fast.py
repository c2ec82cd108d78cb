"""Plain reference of FastMode seeding (Illumina reads): Kart's
IdentifySeedPairs_FastMode (AlignmentCandidates.cpp), before its PosDiff
sort.

Per read, from position 0 while pos < rlen - min_seed_len: an ambiguous
base is stepped over; else the longest prefix of the read from pos (to the
read's end, never past an ambiguous base) that occurs in the text is
found; if it is min_seed_len long or more and occurs occ_thr times or
fewer, each occurrence is emitted as (pos, length, text position) in
suffix-array row order; pos moves past the prefix and one base more.

All reads step together, one search each a round, on the device.
"""

from __future__ import annotations

import torch

from benchmark import sa_search


def seeds(index: sa_search.SuffixIndex, reads: torch.Tensor, rlens: torch.Tensor, cfg: dict):
    """-> (counts (B,), rpos, slen, gpos flat in emission order, the searches
    made: dict of read, pos, qlen, length, lo, hi, emitted)."""
    msl, thr = int(cfg["min_seed_len"]), int(cfg["occ_thr"])
    dev = reads.device
    B, L = reads.shape
    nw = -(-L // sa_search.WORD_BASES)
    rw = sa_search.read_words(reads, nw)
    stop = sa_search.next_ambiguous(reads, rlens)
    pos_i = torch.arange(L, device=dev)[None, :].expand(B, L)
    nonamb = torch.full((B, L + 1), L, dtype=torch.int64, device=dev)
    nonamb[:, :L] = torch.where(reads <= 3, pos_i, L)
    nonamb = torch.flip(torch.cummin(torch.flip(nonamb, [1]), 1).values, [1])
    end = rlens.long() - msl
    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.arange(B, device=dev)
    made = []
    while active.numel():
        p = nonamb[active, pos[active].clamp(max=L)]
        keep = p < end[active]
        active, p = active[keep], p[keep]
        if not active.numel():
            break
        qlen = stop[active, p] - p
        best, lo, hi = index.search(sa_search.query_words(rw, active, p, nw), qlen, msl)
        emitted = (best >= msl) & (hi - lo <= thr)
        made.append((active, p, qlen, best, lo, hi, emitted))
        pos[active] = p + best + 1
    cols = [torch.cat(c) for c in zip(*made)] if made else [
        torch.zeros(0, dtype=torch.int64, device=dev)] * 7
    searches = dict(zip(("read", "pos", "qlen", "length", "lo", "hi", "emitted"), cols))
    e = searches["emitted"].bool()
    cnt, rp, sl, gp = sa_search.expand(index.sa, searches["read"][e], searches["pos"][e],
                                       searches["length"][e], searches["lo"][e],
                                       searches["hi"][e], B)
    return cnt, rp, sl, gp, searches
