"""Report generation: candidate -> (score, CIGAR, coordinates).

Mirrors GenMappingReport / GenCoordinateInfo / GenerateCIGAR /
CheckCoordinateValidity / GapPenalty (reference:
src/AlignmentCandidates.cpp:492-745).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .candidates import Candidate, identify_normal_pairs
from .conquer import Conquer


@dataclass(slots=True)
class Coordinate:
    bdir: bool = True  # True: forward
    cigar: str = ""
    gpos: int = 0
    chrom_idx: int = 0


@dataclass(slots=True)
class AlnReport:
    aln_score: int = 0
    sam_flag: int = 0
    paired_idx: int = -1
    coor: Coordinate = field(default_factory=Coordinate)


@dataclass
class ReadState:
    header: str
    seq: bytes
    qual: bytes | None
    rlen: int
    mapq: int = 0
    score: int = 0
    sub_score: int = 0
    can_num: int = 0
    best_idx: int = 0
    reports: list = field(default_factory=list)


def generate_cigar_str(cigar_vec: list) -> str:
    """GenerateCIGAR (AlignmentCandidates.cpp:492-513): merge adjacent ops."""
    out = []
    state = ""
    c = 0
    for n, op in cigar_vec:
        if op != state:
            if c > 0:
                out.append(f"{c}{state}")
            c = n
            state = op
        else:
            c += n
    if c > 0:
        out.append(f"{c}{state}")
    return "".join(out)


def gen_coordinate_info(gidx, first_read: bool, gpos: int, end_gpos: int, cigar_vec: list):
    """GenCoordinateInfo (AlignmentCandidates.cpp:515-562)."""
    coor = Coordinate()
    keys, vals = gidx.chr_map
    if gpos < gidx.genome_size:  # forward strand
        coor.bdir = bool(first_read)
        if gidx.n_chrom == 1:
            coor.chrom_idx = 0
            coor.gpos = gpos + 1
        else:
            lb = int(gidx.chr_lower_bound(gpos))
            coor.chrom_idx = int(vals[lb])
            coor.gpos = gpos + 1 - int(gidx.chrom_fwd_loc[coor.chrom_idx])
    else:
        coor.bdir = not first_read
        cigar_vec = cigar_vec[::-1]
        if gidx.n_chrom == 1:
            coor.chrom_idx = 0
            coor.gpos = gidx.two_genome_size - end_gpos
        else:
            lb = int(gidx.chr_lower_bound(gpos))
            coor.gpos = int(keys[lb]) - end_gpos + 1
            coor.chrom_idx = int(vals[lb])
    coor.cigar = generate_cigar_str(cigar_vec)
    return coor


def check_coordinate_validity(gidx, seeds) -> bool:
    """CheckCoordinateValidity (AlignmentCandidates.cpp:582-610)."""
    gpos1 = 0
    gpos2 = gidx.two_genome_size
    for s in seeds:
        if s.glen > 0:
            gpos1 = s.gpos
            break
    for s in reversed(seeds):
        if s.glen > 0:
            gpos2 = s.gpos + s.glen - 1
            break
    keys, vals = gidx.chr_map
    gs = gidx.genome_size
    if (gpos1 < gs) != (gpos2 < gs):
        return False
    lb1 = int(gidx.chr_lower_bound(gpos1))
    lb2 = int(gidx.chr_lower_bound(gpos2))
    if lb1 >= len(keys) or lb2 >= len(keys) or vals[lb1] != vals[lb2]:
        return False
    return True


def gap_penalty(cigar_vec: list) -> int:
    return sum(n for n, op in cigar_vec if op in ("I", "D"))


def gen_mapping_report(
    gidx,
    conquer: Conquer,
    first_read: bool,
    read: ReadState,
    cands: list[Candidate],
    pacbio: bool,
    multi_hit: bool,
) -> None:
    """GenMappingReport (AlignmentCandidates.cpp:624-745): align every
    candidate, accumulate scores, pick best/sub-best."""
    read.score = read.sub_score = read.best_idx = 0
    read.can_num = len(cands)
    if read.can_num > 0:
        read.reports = [AlnReport() for _ in range(read.can_num)]
        for i, cand in enumerate(cands):
            rep = read.reports[i]
            rep.aln_score = 0
            rep.paired_idx = cand.paired_idx
            if cand.score == 0:
                continue
            if pacbio and read.score > 0:
                read.sub_score = read.score
                continue
            cand.seeds = identify_normal_pairs(read.rlen, -1, cand.seeds)
            if not check_coordinate_validity(gidx, cand.seeds):
                continue
            cigar_vec: list = []
            seeds = cand.seeds
            num = len(seeds)
            for j in range(num):
                sp = seeds[j]
                if sp.rlen == 0 and sp.glen == 0:
                    continue
                if sp.simple:
                    cigar_vec.append((sp.rlen, "M"))
                    rep.aln_score += sp.rlen
                elif j == 0:
                    if sp.rlen > 3000:
                        cigar_vec.append((sp.rlen, "S"))
                        sp.gpos = seeds[1].gpos
                        sp.glen = 0
                    else:
                        s = conquer.process_head(read.seq, sp, cigar_vec)
                        rep.aln_score += s
                        if s == 0:
                            sp.gpos = seeds[1].gpos
                            sp.glen = 0
                elif j == num - 1:
                    if sp.rlen > 3000:
                        cigar_vec.append((sp.rlen, "S"))
                        sp.gpos = seeds[j - 1].gpos + seeds[j - 1].glen
                        sp.glen = 0
                    else:
                        s = conquer.process_tail(read.seq, sp, cigar_vec)
                        rep.aln_score += s
                        if s == 0:
                            sp.gpos = seeds[j - 1].gpos + seeds[j - 1].glen
                            sp.glen = 0
                else:
                    rep.aln_score += conquer.process_normal(read.seq, sp, cigar_vec)
            if not pacbio and len(cigar_vec) > 1:
                rep.aln_score -= gap_penalty(cigar_vec)
                if rep.aln_score <= 0:
                    rep.aln_score = 0
                    continue
            if len(cigar_vec) == 0:
                rep.aln_score = 0
            else:
                rep.coor = gen_coordinate_info(
                    gidx,
                    first_read,
                    seeds[0].gpos,
                    seeds[num - 1].gpos + seeds[num - 1].glen - 1,
                    cigar_vec,
                )
                if rep.coor.gpos <= 0:
                    rep.aln_score = 0
            if rep.aln_score > read.score:
                read.best_idx = i
                read.sub_score = read.score
                read.score = rep.aln_score
            elif rep.aln_score == read.score:
                read.sub_score = read.score
                if (
                    not multi_hit
                    and read.score > 0
                    and gidx.raw.chrom_lens[rep.coor.chrom_idx]
                    > gidx.raw.chrom_lens[read.reports[read.best_idx].coor.chrom_idx]
                ):
                    read.best_idx = i
    else:
        read.can_num = 1
        read.best_idx = 0
        read.reports = [AlnReport()]
