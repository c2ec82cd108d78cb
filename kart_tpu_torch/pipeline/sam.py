"""SAM flag assembly, MAPQ, and record emission.

Mirrors SetSingleAlignmentFlag / SetPairedAlignmentFlag / EvaluateMAPQ /
OutputPairedAlignments / OutputSingledAlignments (reference:
src/Mapping.cpp:49-315) including the float32 MAPQ arithmetic and the
mate-2 reverse-complement output conventions.
"""

from __future__ import annotations

import math

import numpy as np

from .report import ReadState

MAPQ_COEF = 30
MAX_MAPQ = 60

def revcomp(seq: bytes) -> bytes:
    """GetComplementarySeq (tools.cpp:19-29): non-ACGT chars become 'N'."""
    from ..io.fastq import _COMP_FULL

    return seq[::-1].translate(_COMP_FULL)


def set_single_flag(read: ReadState) -> None:
    """SetSingleAlignmentFlag (Mapping.cpp:49-71)."""
    if read.score > read.sub_score:
        rep = read.reports[read.best_idx]
        rep.sam_flag = 0x10 if not rep.coor.bdir else 0
    elif read.score > 0:
        for rep in read.reports:
            if rep.aln_score > 0:
                rep.sam_flag = 0x10 if not rep.coor.bdir else 0
    else:
        read.reports[0].sam_flag = 0x4


def set_paired_flags(read1: ReadState, read2: ReadState) -> None:
    """SetPairedAlignmentFlag (Mapping.cpp:73-158)."""
    if read1.score > read1.sub_score and read2.score > read2.sub_score:
        i = read1.best_idx
        rep1 = read1.reports[i]
        rep1.sam_flag = 0x41
        j = read2.best_idx
        rep2 = read2.reports[j]
        rep2.sam_flag = 0x81
        if j == rep1.paired_idx:
            rep1.sam_flag |= 0x2
            rep2.sam_flag |= 0x2
        rep1.sam_flag |= 0x20 if rep1.coor.bdir else 0x10
        rep2.sam_flag |= 0x20 if rep2.coor.bdir else 0x10
        return
    if read1.score > read1.sub_score:
        rep1 = read1.reports[read1.best_idx]
        rep1.sam_flag = 0x41
        rep1.sam_flag |= 0x20 if rep1.coor.bdir else 0x10
        j = rep1.paired_idx
        if j != -1 and read2.reports[j].aln_score > 0:
            rep1.sam_flag |= 0x2
        else:
            rep1.sam_flag |= 0x8
    elif read1.score > 0:
        for rep1 in read1.reports:
            if rep1.aln_score > 0:
                rep1.sam_flag = 0x41
                rep1.sam_flag |= 0x20 if rep1.coor.bdir else 0x10
                j = rep1.paired_idx
                if j != -1 and read2.reports[j].aln_score > 0:
                    rep1.sam_flag |= 0x2
                else:
                    rep1.sam_flag |= 0x8
    else:
        rep1 = read1.reports[0]
        rep1.sam_flag = 0x41 | 0x4
        if read2.score == 0:
            rep1.sam_flag |= 0x8
        else:
            rep1.sam_flag |= 0x10 if read2.reports[read2.best_idx].coor.bdir else 0x20

    if read2.score > read2.sub_score:
        rep2 = read2.reports[read2.best_idx]
        rep2.sam_flag = 0x81
        rep2.sam_flag |= 0x20 if rep2.coor.bdir else 0x10
        i = rep2.paired_idx
        if i != -1 and read1.reports[i].aln_score > 0:
            rep2.sam_flag |= 0x2
        else:
            rep2.sam_flag |= 0x8
    elif read2.score > 0:
        for rep2 in read2.reports:
            if rep2.aln_score > 0:
                rep2.sam_flag = 0x81
                rep2.sam_flag |= 0x20 if rep2.coor.bdir else 0x10
                i = rep2.paired_idx
                if i != -1 and read1.reports[i].aln_score > 0:
                    rep2.sam_flag |= 0x2
                else:
                    rep2.sam_flag |= 0x8
    else:
        rep2 = read2.reports[0]
        rep2.sam_flag = 0x81 | 0x4
        if read1.score == 0:
            rep2.sam_flag |= 0x8
        else:
            rep2.sam_flag |= 0x10 if read1.reports[read1.best_idx].coor.bdir else 0x20


def evaluate_mapq(read: ReadState, pacbio: bool) -> None:
    """EvaluateMAPQ (Mapping.cpp:160-175), float32-exact."""
    if read.score == 0 or read.score == read.sub_score:
        read.mapq = 0
        return
    if pacbio:
        f_scale = 85.0 * math.ceil(read.rlen // 100 + 0.5)
        if f_scale > 2000:
            f_scale = 2000.0
        read.mapq = int(MAX_MAPQ * (read.score / f_scale))
    elif read.sub_score == 0 or read.score - read.sub_score > 5:
        read.mapq = MAX_MAPQ
    else:
        # (int)(30 * (1 - (float)(score-sub)/score) * log(score) + 0.4999)
        # C evaluates (float)(s-ss)/s and 1-... and 30*... in float, then
        # multiplies by double log(score).
        frac = np.float32(np.float32(read.score - read.sub_score) / np.float32(read.score))
        coef = np.float32(np.float32(MAPQ_COEF) * (np.float32(1) - frac))
        read.mapq = int(float(coef) * math.log(read.score) + 0.4999)
    if read.mapq > MAX_MAPQ:
        read.mapq = MAX_MAPQ


def sam_header(gidx, version: str = "2.5.6") -> str:
    """@PG + @SQ header identical to the reference (Mapping.cpp:664-675)."""
    lines = [f"@PG\tID:kart\tPN:Kart\tVN:{version}"]
    for i in range(gidx.n_chrom):
        lines.append(f"@SQ\tSN:{gidx.raw.chrom_names[i]}\tLN:{int(gidx.raw.chrom_lens[i])}")
    return "\n".join(lines) + "\n"


def output_single(gidx, read: ReadState, fastq: bool, multi_hit: bool, stats) -> list[str]:
    """OutputSingledAlignments (Mapping.cpp:272-315)."""
    out = []
    seq_s = read.seq.decode("ascii")
    qual_s = read.qual.decode("ascii") if (fastq and read.qual is not None) else "*"
    if read.score == 0:
        stats["unmapped"] += 1
        out.append(
            f"{read.header}\t{read.reports[0].sam_flag}\t*\t0\t0\t*\t*\t0\t0\t{seq_s}\t{qual_s}\tAS:i:0\tXS:i:0"
        )
        return out
    if read.mapq == MAX_MAPQ:
        stats["unique"] += 1
    rseq_s = rqual_s = None
    for i in range(read.best_idx, read.can_num):
        rep = read.reports[i]
        if rep.aln_score == read.score:
            if not rep.coor.bdir and rseq_s is None:
                rseq_s = revcomp(read.seq).decode("ascii")
                rqual_s = qual_s[::-1] if fastq else "*"
            sq = seq_s if rep.coor.bdir else rseq_s
            ql = (qual_s if rep.coor.bdir else rqual_s) if fastq else "*"
            out.append(
                f"{read.header}\t{rep.sam_flag}\t{gidx.raw.chrom_names[rep.coor.chrom_idx]}\t"
                f"{rep.coor.gpos}\t{read.mapq}\t{rep.coor.cigar}\t*\t0\t0\t{sq}\t{ql}\t"
                f"NM:i:{read.rlen - read.score}\tAS:i:{read.score}\tXS:i:{read.sub_score}"
            )
            if not multi_hit:
                break
    return out


def output_paired(gidx, read1: ReadState, read2: ReadState, fastq: bool, multi_hit: bool, stats) -> list[str]:
    """OutputPairedAlignments (Mapping.cpp:177-270).  read2's stored seq is
    the reverse complement of the original mate."""
    out = []
    # ---- read 1 ----
    seq1 = read1.seq.decode("ascii")
    qual1 = read1.qual.decode("ascii") if (fastq and read1.qual is not None) else "*"
    if read1.score == 0:
        stats["unmapped"] += 1
        out.append(
            f"{read1.header}\t{read1.reports[0].sam_flag}\t*\t0\t0\t*\t*\t0\t0\t{seq1}\t{qual1}\tAS:i:0\tXS:i:0"
        )
    else:
        if read1.mapq == MAX_MAPQ:
            stats["unique"] += 1
        rseq = rqual = None
        for i in range(read1.best_idx, read1.can_num):
            rep = read1.reports[i]
            if rep.aln_score > 0:
                if not rep.coor.bdir and rseq is None:
                    rseq = revcomp(read1.seq).decode("ascii")
                    rqual = qual1[::-1] if fastq else "*"
                j = rep.paired_idx
                sq = seq1 if rep.coor.bdir else rseq
                ql = (qual1 if rep.coor.bdir else rqual) if fastq else "*"
                if j != -1 and read2.reports[j].aln_score > 0:
                    dist = int(read2.reports[j].coor.gpos - rep.coor.gpos) + (
                        read2.rlen if rep.coor.bdir else -read1.rlen
                    )
                    if i == read1.best_idx:
                        stats["paired"] += 2
                        if abs(dist) < 10000:
                            stats["distance"] += abs(dist)
                    out.append(
                        f"{read1.header}\t{rep.sam_flag}\t{gidx.raw.chrom_names[rep.coor.chrom_idx]}\t"
                        f"{rep.coor.gpos}\t{read1.mapq}\t{rep.coor.cigar}\t=\t"
                        f"{read2.reports[j].coor.gpos}\t{dist}\t{sq}\t{ql}\t"
                        f"NM:i:{read1.rlen - read1.score}\tAS:i:{read1.score}\tXS:i:{read1.sub_score}"
                    )
                else:
                    out.append(
                        f"{read1.header}\t{rep.sam_flag}\t{gidx.raw.chrom_names[rep.coor.chrom_idx]}\t"
                        f"{rep.coor.gpos}\t{read1.mapq}\t{rep.coor.cigar}\t*\t0\t0\t{sq}\t{ql}\t"
                        f"NM:i:{read1.rlen - read1.score}\tAS:i:{read1.score}\tXS:i:{read1.sub_score}"
                    )
            if not multi_hit:
                break
    # ---- read 2 (stored reverse-complemented) ----
    rseq2 = read2.seq.decode("ascii")  # stored RC
    qual2 = read2.qual.decode("ascii") if (fastq and read2.qual is not None) else "*"
    if read2.score == 0:
        stats["unmapped"] += 1
        out.append(
            f"{read2.header}\t{read2.reports[0].sam_flag}\t*\t0\t0\t*\t*\t0\t0\t{rseq2}\t{qual2}\tAS:i:0\tXS:i:0"
        )
    else:
        if read2.mapq == MAX_MAPQ:
            stats["unique"] += 1
        seq2 = rqual2 = None
        for j in range(read2.best_idx, read2.can_num):
            rep = read2.reports[j]
            if rep.aln_score > 0:
                if rep.coor.bdir and seq2 is None:
                    seq2 = revcomp(read2.seq).decode("ascii")
                    rqual2 = qual2[::-1] if fastq else "*"
                i = rep.paired_idx
                sq = seq2 if rep.coor.bdir else rseq2
                ql = (rqual2 if rep.coor.bdir else qual2) if fastq else "*"
                if i != -1 and read1.reports[i].aln_score > 0:
                    dist = -(
                        int(rep.coor.gpos - read1.reports[i].coor.gpos)
                        + (read2.rlen if read1.reports[i].coor.bdir else -read1.rlen)
                    )
                    out.append(
                        f"{read2.header}\t{rep.sam_flag}\t{gidx.raw.chrom_names[rep.coor.chrom_idx]}\t"
                        f"{rep.coor.gpos}\t{read2.mapq}\t{rep.coor.cigar}\t=\t"
                        f"{read1.reports[i].coor.gpos}\t{dist}\t{sq}\t{ql}\t"
                        f"NM:i:{read2.rlen - read2.score}\tAS:i:{read2.score}\tXS:i:{read2.sub_score}"
                    )
                else:
                    out.append(
                        f"{read2.header}\t{rep.sam_flag}\t{gidx.raw.chrom_names[rep.coor.chrom_idx]}\t"
                        f"{rep.coor.gpos}\t{read2.mapq}\t{rep.coor.cigar}\t*\t0\t0\t{sq}\t{ql}\t"
                        f"NM:i:{read2.rlen - read2.score}\tAS:i:{read2.score}\tXS:i:{read2.sub_score}"
                    )
            if not multi_hit:
                break
    return out
