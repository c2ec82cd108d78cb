"""Plain reference of SensitiveMode seeding (PacBio reads): Kart's
IdentifySeedPairs_SensitiveMode (AlignmentCandidates.cpp), before its
position sort.

Per read, from position 0 while pos < rlen - min_seed_len: an ambiguous
base is stepped over; else the longest prefix of the read from pos that
occurs in the text is found, reading no further than min(pos + window,
rlen) nor past an ambiguous base; if it is min_seed_len long or more and
occurs occ_thr times or fewer, each occurrence is emitted as (pos, length,
text position) in suffix-array row order and pos moves past the prefix;
else pos moves min_seed_len on.

A search depends on its start alone, so every start of every read is
searched at once, in blocks, and the reads' walks then read the results.
"""

from __future__ import annotations

import torch

from benchmark import sa_search

BLOCK = 1 << 20  # searches a block


def seeds(index: sa_search.SuffixIndex, reads: torch.Tensor, rlens: torch.Tensor, cfg: dict):
    """-> (counts (B,), rpos, slen, gpos flat in emission order, the searches
    the walks made: dict of read, pos, qlen, length, lo, hi, emitted)."""
    msl, thr, win = int(cfg["min_seed_len"]), int(cfg["occ_thr"]), int(cfg["window"])
    dev = reads.device
    B, L = reads.shape
    nw = -(-win // sa_search.WORD_BASES)
    rw = sa_search.read_words(reads, nw)
    stop = sa_search.next_ambiguous(reads, rlens)
    pos_i = torch.arange(L, device=dev)[None, :].expand(B, L)
    start = (reads <= 3) & (pos_i < (rlens.long() - msl)[:, None])
    r_all, p_all = torch.nonzero(start, as_tuple=True)
    best = torch.zeros((B, L), dtype=torch.int64, device=dev)
    lo = torch.zeros((B, L), dtype=torch.int64, device=dev)
    hi = torch.zeros((B, L), dtype=torch.int64, device=dev)
    for b0 in range(0, r_all.shape[0], BLOCK):
        r, p = r_all[b0 : b0 + BLOCK], p_all[b0 : b0 + BLOCK]
        qlen = torch.minimum(p + win, stop[r, p]) - p
        b, l_, h = index.search(sa_search.query_words(rw, r, p, nw), qlen, msl)
        best[r, p], lo[r, p], hi[r, p] = b, l_, h
    hit = (best >= msl) & (hi - lo <= thr)
    end = rlens.long() - msl
    pos = torch.zeros(B, dtype=torch.int64, device=dev)
    active = torch.arange(B, device=dev)
    made = []
    while active.numel():
        keep = pos[active] < end[active]
        active = active[keep]
        if not active.numel():
            break
        p = pos[active]
        amb = reads[active, p] > 3
        h = hit[active, p] & ~amb
        s = active[~amb]
        sp = p[~amb]
        made.append((s, sp, torch.minimum(sp + win, stop[s, sp]) - sp, best[s, sp], lo[s, sp],
                     hi[s, sp], h[~amb]))
        pos[active] = torch.where(amb, p + 1, torch.where(h, p + best[active, p], p + msl))
    cols = [torch.cat(c) for c in zip(*made)] if made else [
        torch.zeros(0, dtype=torch.int64, device=dev)] * 7
    searches = dict(zip(("read", "pos", "qlen", "length", "lo", "hi", "emitted"), cols))
    e = searches["emitted"].bool()
    cnt, rp, sl, gp = sa_search.expand(index.sa, searches["read"][e], searches["pos"][e],
                                       searches["length"][e], searches["lo"][e],
                                       searches["hi"][e], B)
    return cnt, rp, sl, gp, searches
