"""Paired-end pairing, rescue, and final mate selection.

Mirrors CheckPairedAlignmentCandidates / RemoveUnMatedAlignmentCandidates /
CheckPairedFinalAlignments (reference: src/Mapping.cpp:348-480) and
RescueUnpairedAlignment (reference: src/AlignmentRescue.cpp).
"""

from __future__ import annotations

from .candidates import Candidate, Seed, remove_redundant_candidates
from .conquer import (
    create_kmer_vec,
    identify_common_kmers,
    simple_pairs_from_common_kmers,
)
from .report import ReadState


def check_paired_candidates(est_distance: int, vec1: list[Candidate], vec2: list[Candidate]) -> bool:
    """CheckPairedAlignmentCandidates (Mapping.cpp:348-400)."""
    num1, num2 = len(vec1), len(vec2)
    if num1 * num2 > 1000:
        remove_redundant_candidates(vec1, pacbio=False)
        remove_redundant_candidates(vec2, pacbio=False)
    pairing = False
    for i in range(num1):
        if vec1[i].score == 0:
            continue
        best_mate = -1
        s = 0
        for j in range(num2):
            if vec2[j].score == 0 or vec2[j].posdiff < vec1[i].posdiff:
                continue
            dist = vec2[j].posdiff - vec1[i].posdiff
            if dist < est_distance:
                if vec2[j].score > s:
                    best_mate = j
                    s = vec2[j].score
                elif vec2[j].score == s:
                    best_mate = -1
        if s > 0 and best_mate != -1:
            j = best_mate
            if vec2[j].paired_idx == -1:
                pairing = True
                vec1[i].paired_idx = j
                vec2[j].paired_idx = i
            elif vec1[i].score > vec1[vec2[j].paired_idx].score:
                vec1[vec2[j].paired_idx].paired_idx = -1
                vec1[i].paired_idx = j
                vec2[j].paired_idx = i
    return pairing


def remove_unmated_candidates(vec1: list[Candidate], vec2: list[Candidate]) -> None:
    """RemoveUnMatedAlignmentCandidates (Mapping.cpp:402-427): zero unmated,
    sum mated scores."""
    for c1 in vec1:
        if c1.paired_idx == -1:
            c1.score = 0
        else:
            c2 = vec2[c1.paired_idx]
            c1.score = c2.score = c1.score + c2.score
    for c2 in vec2:
        if c2.paired_idx == -1:
            c2.score = 0


def check_paired_final_alignments(read1: ReadState, read2: ReadState, multi_hit: bool) -> None:
    """CheckPairedFinalAlignments (Mapping.cpp:429-480)."""
    if read1.best_idx != -1 and read2.best_idx != -1:
        mated = read1.reports[read1.best_idx].paired_idx == read2.best_idx
    else:
        mated = False
    if not multi_hit and mated:
        return
    if not mated and read1.score > 0 and read2.score > 0:
        s = 0
        for i in range(read1.can_num):
            j = read1.reports[i].paired_idx
            if read1.reports[i].aln_score > 0 and j != -1 and read2.reports[j].aln_score > 0:
                mated = True
                tot = read1.reports[i].aln_score + read2.reports[j].aln_score
                if s < tot:
                    s = tot
                    read1.best_idx = i
                    read1.score = read1.reports[i].aln_score
                    read2.best_idx = j
                    read2.score = read2.reports[j].aln_score
    if mated:
        for i in range(read1.can_num):
            rep = read1.reports[i]
            j = rep.paired_idx
            if rep.aln_score != read1.score or (
                j != -1 and read2.reports[j].aln_score != read2.score
            ):
                rep.aln_score = 0
                rep.paired_idx = -1
    else:
        for rep in read1.reports:
            rep.paired_idx = -1
            if rep.aln_score > 0 and rep.aln_score != read1.score:
                rep.aln_score = 0
        for rep in read2.reports:
            rep.paired_idx = -1
            if rep.aln_score > 0 and rep.aln_score != read2.score:
                rep.aln_score = 0


# ---------------------------------------------------------------------------
# PE rescue (AlignmentRescue.cpp)
# ---------------------------------------------------------------------------


def _max_candidate_score(vec: list[Candidate]) -> int:
    return max((c.score for c in vec), default=0)


def _anchor_threshold(vec: list[Candidate]) -> int:
    thr = _max_candidate_score(vec) - 30
    return 50 if thr < 50 else thr


def rescue_unpaired(
    gidx,
    est_distance: int,
    max_insert_size: int,
    max_gaps: int,
    r1: ReadState,
    r2: ReadState,
    vec1: list[Candidate],
    vec2: list[Candidate],
) -> bool:
    """RescueUnpairedAlignment (AlignmentRescue.cpp:73-170)."""
    score1 = _max_candidate_score(vec1)
    score2 = _max_candidate_score(vec2)
    if score1 == 0 and score2 == 0:
        return False
    if score1 < int(r1.rlen * 0.1) and score2 < int(r2.rlen * 0.1):
        strategy = 4
    elif score1 > score2 and score1 - score2 > 50:
        strategy = 1
    elif score2 > score1 and score2 - score1 > 50:
        strategy = 2
    else:
        strategy = 3
    if est_distance > max_insert_size:
        est_distance = max_insert_size
    mated = False
    num1, num2 = len(vec1), len(vec2)
    ref = gidx.ref_seq
    keys, vals = gidx.chr_map

    if strategy in (1, 3):
        thr = _anchor_threshold(vec1)
        kvec1 = create_kmer_vec(r2.seq)
        j = num2
        for i in range(num1):
            if vec1[i].score < thr:
                continue
            left = vec1[i].posdiff
            right = vec1[i].posdiff + est_distance + r2.rlen
            lb = int(gidx.chr_lower_bound(left))
            chr_id = int(vals[lb]) if lb < len(vals) else 0
            fwd = int(gidx.chrom_fwd_loc[chr_id])
            rev = int(gidx.chrom_rev_loc[chr_id])
            if right < gidx.genome_size and right > fwd:
                right = fwd - 1
            elif right >= gidx.genome_size and right > rev:
                right = rev - 1
            slen = int(right - left)
            if slen < r2.rlen:
                continue
            seg = ref[left : left + slen].tobytes()
            kvec2 = create_kmer_vec(seg)
            pairs = identify_common_kmers(slen, kvec1, kvec2)
            simple = simple_pairs_from_common_kmers(10, pairs)
            cand = _identify_rescue_candidate_mg(left, simple, max_gaps)
            if cand.score > score2:
                mated = True
                cand.paired_idx = i
                vec1[i].paired_idx = j
                j += 1
                vec2.append(cand)
    if strategy in (2, 3):
        thr = _anchor_threshold(vec2)
        kvec1 = create_kmer_vec(r1.seq)
        i = num1
        for j2 in range(num2):
            if vec2[j2].score < thr:
                continue
            left = vec2[j2].posdiff - est_distance
            right = vec2[j2].posdiff + r2.rlen
            lb = int(gidx.chr_lower_bound(right))
            chr_id = int(vals[lb]) if lb < len(vals) else 0
            fwd = int(gidx.chrom_fwd_loc[chr_id])
            rev = int(gidx.chrom_rev_loc[chr_id])
            cl = int(gidx.raw.chrom_lens[chr_id])
            if left < gidx.genome_size and left < fwd - cl:
                left = fwd - cl + 1
            elif right >= gidx.genome_size and left < rev - cl:
                left = rev - cl + 1
            slen = int(right - left)
            if slen < r1.rlen:
                continue
            seg = ref[left : left + slen].tobytes()
            kvec2 = create_kmer_vec(seg)
            pairs = identify_common_kmers(slen, kvec1, kvec2)
            simple = simple_pairs_from_common_kmers(10, pairs)
            cand = _identify_rescue_candidate_mg(left, simple, max_gaps)
            if cand.score > score1:
                mated = True
                cand.paired_idx = j2
                vec2[j2].paired_idx = i
                i += 1
                vec1.append(cand)
    return mated


def _identify_rescue_candidate_mg(gpos: int, seeds: list[Seed], max_gaps: int) -> Candidate:
    """IdnetifyRescueCandidate with the configured MaxGaps."""
    cand = Candidate(score=0, posdiff=0, paired_idx=-1)
    num = len(seeds)
    i = 0
    while i < num:
        seeds[i].gpos += gpos
        s = seeds[i].rlen
        sel = [seeds[i]]
        j = i + 1
        while j < num:
            if seeds[j].posdiff - seeds[i].posdiff < max_gaps:
                seeds[j].gpos += gpos
                s += seeds[j].rlen
                sel.append(seeds[j])
                j += 1
            else:
                break
        if s > cand.score:
            cand.score = s
            cand.posdiff = sel[0].posdiff + gpos
            cand.seeds = sel
        i = j
    cand.seeds.sort(key=lambda x: (x.gpos, x.rpos))
    for sp in cand.seeds:
        sp.posdiff += gpos
    return cand
