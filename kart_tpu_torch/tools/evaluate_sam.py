#!/usr/bin/env python
"""Accuracy evaluator for SAM files with truth-encoded read names.

Behavioral equivalent of the reference's SamEvaluation tool (reference:
SamEvaluation.cpp): the true position is parsed from the read name
(`...=POS` or `POS_...`, the wgsim convention), a prediction counts as
correct within +-(30 + readlen), and mapped%, MAPQ-0 rate, precision and
recall are reported with the same rounding.

The port's copy of the repository's `tools/evaluate_sam.py` (the same
dict for the same SAM file).

Usage: python -m kart_tpu_torch.tools.evaluate_sam alignment.sam [-d]
"""

from __future__ import annotations

import sys

I_SHIFT = 30


def check_pos(length: int, true_loc: int, predicted: int) -> bool:
    return abs(true_loc - predicted) < I_SHIFT + length


def evaluate(path: str, show_wrong: bool = False) -> dict:
    n_reads = n_unmapped = n_correct = n_bad_mapq = 0
    prev_header = None
    with open(path) as f:
        for line in f:
            if not line.strip():
                break
            if line[0] == "@":
                continue
            fields = line.split("\t")
            header, flag, chname, pos_str, mapq = (
                fields[0],
                int(fields[1]),
                fields[2],
                fields[3],
                int(fields[4]),
            )
            seq = fields[9]
            if header == prev_header:
                continue
            prev_header = header
            n_reads += 1
            if chname != "*" and mapq == 0:
                n_bad_mapq += 1
            pos = int(pos_str) - 1 if pos_str != "*" else -1
            if "=" in header:
                true_loc = int("".join(c for c in header.split("=", 1)[1] if c.isdigit()) or 0)
            else:
                true_loc = int(header.split("_", 1)[0] or 0)
            if chname == "*":
                n_unmapped += 1
                if show_wrong:
                    print(header)
            else:
                if check_pos(len(seq), true_loc, pos):
                    n_correct += 1
                elif mapq > 0 and show_wrong:
                    print(header)
    total = n_reads
    mapped = n_reads - n_unmapped

    def pct(x, y):
        return int(10000 * (x / y) + 0.5) / 100.0 if y else 0.0

    print(f"\n\nfilename={path}", file=sys.stderr)
    print(f"# of reads= {total}", file=sys.stderr)
    if n_reads:
        print(f"# of mapped reads= {mapped} ({pct(mapped, total)}%)", file=sys.stderr)
        print(f"# of mapq_0={n_bad_mapq} ({pct(n_bad_mapq, n_reads)}%)", file=sys.stderr)
        print(f"precision= {n_correct} ({pct(n_correct, mapped)}%)", file=sys.stderr)
        print(f"recall= {n_correct} ({pct(n_correct, total)}%)", file=sys.stderr)
    return dict(
        reads=total,
        mapped=mapped,
        correct=n_correct,
        mapq0=n_bad_mapq,
        precision=pct(n_correct, mapped),
        recall=pct(n_correct, total),
    )


if __name__ == "__main__":
    if len(sys.argv) < 2:
        print(f"usage: {sys.argv[0]} SamFile [-d]")
        sys.exit(0)
    evaluate(sys.argv[1], show_wrong="-d" in sys.argv[2:])
