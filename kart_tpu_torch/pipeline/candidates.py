"""Candidate generation and the divide step.

Host-side (per-read, tiny-vector) logic mirroring the reference's semantics
exactly — required for bit-identical SAM:

- seed clustering into alignment candidates
  (reference: src/AlignmentCandidates.cpp:82-130 Illumina, :171-224 PacBio)
- tandem-repeat / translocation / overlap seed filters and normal-pair
  synthesis (reference: src/AlignmentCandidates.cpp:235-490)
- candidate pruning (reference: src/Mapping.cpp:317-346)

Seeds are stored as flat Python lists of Seed records; per-read counts are
a handful of elements, so this layer is control logic, not compute.  The
compute (seed discovery, SA resolution, gap alignment) lives on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(slots=True)
class Seed:
    simple: bool
    rpos: int
    gpos: int
    rlen: int
    glen: int
    posdiff: int


@dataclass(slots=True)
class Candidate:
    score: int
    posdiff: int
    paired_idx: int = -1
    seeds: list = field(default_factory=list)


def sort_by_posdiff(seeds: list[Seed]):
    # CompByPosDiff: (PosDiff, rPos) (AlignmentCandidates.cpp:11-15)
    seeds.sort(key=lambda s: (s.posdiff, s.rpos))


def sort_by_gpos(seeds: list[Seed]):
    # CompByGenomePos: (gPos, rPos) (AlignmentCandidates.cpp:17-21)
    seeds.sort(key=lambda s: (s.gpos, s.rpos))


def gen_candidates_illumina(rlen: int, seeds: list[Seed], gidx, max_gaps: int) -> list[Candidate]:
    """GenerateAlignmentCandidateForIlluminaSeq (AlignmentCandidates.cpp:82-130).
    `seeds` must already be PosDiff-sorted."""
    thr = int(rlen * 0.2)
    if thr > 50:
        thr = 50
    out: list[Candidate] = []
    num = len(seeds)
    i = 0
    while i < num and seeds[i].posdiff < 0:
        i += 1
    keys, _ = gidx.chr_map
    while i < num:
        score = seeds[i].rlen
        lb = gidx.chr_lower_bound(seeds[i].gpos)
        gpos_end = keys[lb] if lb < len(keys) else 2**62  # GetAlignmentBoundary
        j = i
        k = i + 1
        while k < num:
            if seeds[k].gpos > gpos_end or (seeds[k].posdiff - seeds[j].posdiff) > max_gaps:
                break
            score += seeds[k].rlen
            j = k
            k += 1
        if score > thr:
            cand = Candidate(score=score, posdiff=0)
            cand.seeds = [
                Seed(s.simple, s.rpos, s.gpos, s.rlen, s.glen, s.posdiff) for s in seeds[i:k]
            ]
            if score - 50 > thr:
                thr = score - 50
            cand.posdiff = cand.seeds[0].posdiff
            if cand.posdiff < 0:
                cand.posdiff = 0
            sort_by_gpos(cand.seeds)
            out.append(cand)
        i = k
    return out


def gen_candidates_pacbio(rlen: int, seeds: list[Seed]) -> list[Candidate]:
    """GenerateAlignmentCandidateForPacBioSeq (AlignmentCandidates.cpp:171-224).
    `seeds` must already be gPos-sorted."""
    out: list[Candidate] = []
    num = len(seeds)
    if num == 0:
        return out
    thr = 0
    taken = [False] * num
    i = 0
    while i < num and seeds[i].posdiff < 0:
        i += 1
    for i in range(i, num):
        if taken[i]:
            continue
        score = seeds[i].rlen
        taken[i] = True
        sel = [seeds[i]]
        j = i
        for k in range(i + 1, num):
            if taken[k]:
                continue
            if abs(seeds[k].posdiff - seeds[j].posdiff) < 300:
                if seeds[k].rpos > seeds[j].rpos:
                    score += seeds[k].rlen
                    sel.append(seeds[k])
                    taken[k] = True
                    j = k
            elif seeds[k].gpos - seeds[j].gpos > 1000:
                break
        if score >= thr:
            thr = score
            pd = seeds[i].posdiff
            cand = Candidate(score=score, posdiff=(0 if pd < 0 else pd))
            cand.seeds = [Seed(s.simple, s.rpos, s.gpos, s.rlen, s.glen, s.posdiff) for s in sel]
            out.append(cand)
    return out


def remove_redundant_candidates(cands: list[Candidate], pacbio: bool) -> None:
    """RemoveRedundantCandidates (Mapping.cpp:317-346): zero out candidates
    below the kept-score threshold."""
    if len(cands) <= 1:
        return
    score1 = score2 = 0
    for c in cands:
        if c.score > score2:
            if c.score >= score1:
                score2 = score1
                score1 = c.score
            else:
                score2 = c.score
    if pacbio or score1 == score2 or score1 - score2 > 20:
        thr = score1
    else:
        thr = score2
    for c in cands:
        if c.score < thr:
            c.score = 0


# ---------------------------------------------------------------------------
# Divide step: seed filters + normal-pair synthesis
# ---------------------------------------------------------------------------


def _remove_null_seeds(seeds: list[Seed]) -> list[Seed]:
    return [s for s in seeds if s.rlen != 0]


def remove_tandem_repeat_seeds(seeds: list[Seed]) -> list[Seed]:
    """RemoveTandemRepeatSeeds (AlignmentCandidates.cpp:235-260): zero all
    seeds sharing an rPos."""
    num = len(seeds)
    if num < 2:
        return seeds
    order = sorted(range(num), key=lambda idx: seeds[idx].rpos)
    found = False
    i = 0
    while i < num:
        j = i + 1
        while j < num and seeds[order[j]].rpos == seeds[order[i]].rpos:
            j += 1
        if j - i > 1:
            found = True
            for k in range(i, j):
                seeds[order[k]].rlen = seeds[order[k]].glen = 0
        i = j
    return _remove_null_seeds(seeds) if found else seeds


def remove_translocated_seeds(seeds: list[Seed]) -> list[Seed]:
    """RemoveTranslocatedSeeds (AlignmentCandidates.cpp:262-321): resolve
    rPos/gPos order inversions, keeping the heavier side."""
    num = len(seeds)
    if num < 2:
        return seeds
    # vec: (rPos, original gPos-rank index) sorted by rPos; CompByFirstInt
    # compares rPos only, and std::sort on equal keys keeps... the reference
    # uses an unstable sort but equal rPos pairs are removed beforehand by
    # the tandem filter, so ties cannot occur here.
    vec = sorted([(s.rpos, idx) for idx, s in enumerate(seeds)], key=lambda t: t[0])
    found = False
    i = 0
    while i < num:
        if vec[i][0] != seeds[i].rpos:
            found = True
            # IdentifyTranslocationRange
            max_idx = vec[i][1]
            jj = i + 1
            while jj <= max_idx:
                if vec[jj][1] > max_idx:
                    max_idx = vec[jj][1]
                jj += 1
            j = max_idx
            s1 = s2 = 0
            for k in range(i, j + 1):
                if k < vec[k][1]:
                    s1 += seeds[vec[k][1]].rlen
                else:
                    s2 += seeds[vec[k][1]].rlen
            if s1 > s2:
                for k in range(i, j + 1):
                    if k > vec[k][1]:
                        seeds[vec[k][1]].rlen = seeds[vec[k][1]].glen = 0
            else:
                for k in range(i, j + 1):
                    if k < vec[k][1]:
                        seeds[vec[k][1]].rlen = seeds[vec[k][1]].glen = 0
            i = j
        i += 1
    return _remove_null_seeds(seeds) if found else seeds


def _check_seed_overlapping(p1: Seed, p2: Seed) -> bool:
    """CheckSeedOverlapping (AlignmentCandidates.cpp:323-373): trim or kill
    one of two overlapping seeds; returns False when p1 lost (bMaster)."""
    master = True
    overlap = p1.rpos + p1.rlen - p2.rpos
    if overlap > 0:
        if p1.rlen < p2.rlen:
            master = False
            if p1.rlen > overlap:
                p1.rlen -= overlap
                p1.glen = p1.rlen
            else:
                p1.rlen = p1.glen = 0
        else:
            if p2.rlen > overlap:
                p2.rpos += overlap
                p2.gpos += overlap
                p2.rlen -= overlap
                p2.glen = p2.rlen
            else:
                p2.rlen = p2.glen = 0
    if p1.rlen > 0 and p2.rlen > 0:
        overlap = p1.gpos + p1.glen - p2.gpos
        if overlap > 0:
            if p1.glen < p2.glen:
                master = False
                if p1.rlen > overlap:
                    p1.rlen -= overlap
                    p1.glen = p1.rlen
                else:
                    p1.rlen = p1.glen = 0
            else:
                if p2.rlen > overlap:
                    p2.rpos += overlap
                    p2.gpos += overlap
                    p2.rlen -= overlap
                    p2.glen = p2.rlen
                else:
                    p2.rlen = p2.glen = 0
    return master


def check_overlapping_seeds(seeds: list[Seed]) -> list[Seed]:
    """CheckOverlappingSeeds (AlignmentCandidates.cpp:382-418)."""
    num = len(seeds)
    if num < 2:
        return seeds
    null_seed = False
    i = 0
    while i < num:
        if seeds[i].rlen > 0:
            r_end = seeds[i].rpos + seeds[i].rlen - 1
            g_end = seeds[i].gpos + seeds[i].glen - 1
            for j in range(i + 1, num):
                if seeds[j].rlen == 0:
                    continue
                if r_end < seeds[j].rpos and g_end < seeds[j].gpos:
                    break
                if not _check_seed_overlapping(seeds[i], seeds[j]):
                    break
            if seeds[i].rlen == 0:
                null_seed = True
                # LocateThePreviousSeedIdx
                i -= 1
                while i > 0 and seeds[i].rlen == 0:
                    i -= 1
                if i < 0:
                    i = 0
            else:
                i += 1
        else:
            null_seed = True
            i += 1
    return _remove_null_seeds(seeds) if null_seed else seeds


def identify_normal_pairs(rlen: int, glen: int, seeds: list[Seed]) -> list[Seed]:
    """IdentifyNormalPairs (AlignmentCandidates.cpp:420-490): run the three
    seed filters, synthesize normal pairs in inter-seed gaps, and add missing
    head/tail blocks.  glen == -1 means 'whole-read vs genome' mode (the
    GenMappingReport call site)."""
    if len(seeds) > 1:
        seeds = remove_tandem_repeat_seeds(seeds)
        seeds = remove_translocated_seeds(seeds)
        seeds = check_overlapping_seeds(seeds)
        num = len(seeds)
        added = []
        for i in range(num - 1):
            j = i + 1
            r_gaps = seeds[j].rpos - (seeds[i].rpos + seeds[i].rlen)
            if r_gaps < 0:
                r_gaps = 0
            g_gaps = seeds[j].gpos - (seeds[i].gpos + seeds[i].glen)
            if g_gaps < 0:
                g_gaps = 0
            if r_gaps > 0 or g_gaps > 0:
                rp = seeds[i].rpos + seeds[i].rlen
                gp = seeds[i].gpos + seeds[i].glen
                added.append(Seed(False, rp, gp, r_gaps, g_gaps, gp - rp))
        if added:
            # reference: push_back + inplace_merge by CompByGenomePos.  The
            # merge is stable, so equal keys keep originals-before-added.
            seeds = sorted(seeds + added, key=lambda s: (s.gpos, s.rpos))
            # Note: sorted() is stable over the concatenated list, which
            # reproduces inplace_merge's behavior iff both halves were
            # individually sorted — they are (seeds by construction, added
            # in increasing gpos).
    if seeds:
        s0 = seeds[0]
        r_gaps = s0.rpos if s0.rpos > 0 else 0
        g_gaps = s0.gpos if glen > 0 else r_gaps
        if r_gaps > 0 or g_gaps > 0:
            gp = s0.gpos - g_gaps
            if gp < 0:
                # reference clamps gPos to 0 and then adds the already-zeroed
                # value to gGaps (a no-op), so gGaps stays unchanged
                # (AlignmentCandidates.cpp:464)
                gp = 0
            seeds.insert(0, Seed(False, 0, gp, r_gaps, g_gaps, gp))
        sl = seeds[-1]
        r_gaps = rlen - (sl.rpos + sl.rlen)
        g_gaps = (glen - (sl.gpos + sl.glen)) if glen > 0 else r_gaps
        if r_gaps > 0 or g_gaps > 0:
            rp = sl.rpos + sl.rlen
            gp = sl.gpos + sl.glen
            seeds.append(Seed(False, rp, gp, r_gaps, g_gaps, gp - rp))
    return seeds
