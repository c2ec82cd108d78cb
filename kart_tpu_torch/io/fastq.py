"""Chunked FASTA/FASTQ read input.

Mirrors the reference reader semantics (reference: src/GetData.cpp):
header trimmed of leading '@'/'>' and cut at the first space/'/'/tab;
mate-2 sequences reverse-complemented (and quals reversed) at load when
paired; chunks of 4000 reads (10 for PacBio)."""

from __future__ import annotations

import gzip
from dataclasses import dataclass

READ_CHUNK_SIZE = 4000
PACBIO_CHUNK_SIZE = 10

# GetComplementaryBase (tools.cpp:3-17): ACGT (any case) -> uppercase
# complement, everything else -> 'N'
_comp_table = bytearray(b"N" * 256)
for _a, _b in zip(b"ACGTacgt", b"TGCATGCA"):
    _comp_table[_a] = _b
_COMP_FULL = bytes(_comp_table)


def _revcomp(seq: bytes) -> bytes:
    return seq[::-1].translate(_COMP_FULL)


@dataclass(slots=True)
class RawRead:
    header: str
    seq: bytes
    qual: bytes | None
    rlen: int


def check_read_format(path: str) -> bool:
    """CheckReadFormat (GetData.cpp:8-16): True = FASTQ."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        b = f.read(1)
    return b == b"@"


def _parse_header(line: bytes) -> str:
    """IdentifyHeaderBegPos/EndPos (GetData.cpp:29-49): skip leading @/>
    (scan starts at index 1), cut at first ' ', '/' or tab.  `line` must
    include its trailing newline (getline semantics): the defaults of both
    scans are len-1, i.e. the newline position, so a header with no
    separator ends exactly before the newline."""
    n = len(line)
    p1 = n - 1
    for i in range(1, n):
        if line[i] not in (0x3E, 0x40):  # '>' '@'
            p1 = i
            break
    p2 = n - 1
    for i in range(1, n):
        if line[i] in (0x20, 0x2F, 0x09):  # ' ' '/' '\t'
            p2 = i
            break
    return line[p1:p2].decode("ascii", "replace")


class ReadStream:
    """Sequential entry reader over one (possibly gzipped) FASTA/FASTQ file."""

    def __init__(self, path: str, fastq: bool):
        self.fastq = fastq
        self.f = gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")
        self._pushback: bytes | None = None

    def close(self):
        self.f.close()

    def _getline(self) -> bytes:
        if self._pushback is not None:
            line = self._pushback
            self._pushback = None
            return line
        return self.f.readline()

    def next_entry(self) -> RawRead | None:
        line = self._getline()
        if not line:
            return None
        header = _parse_header(line)
        if self.fastq:
            seq_line = self._getline()
            rlen = len(seq_line) - 1  # reference: rlen = getline len - 1
            if rlen <= 0:
                return None
            seq = seq_line[:rlen]
            self._getline()  # '+'
            qual = self._getline()[:rlen]
            return RawRead(header, seq, qual, rlen)
        parts = []
        while True:
            line = self._getline()
            if not line:
                break
            if line.startswith(b">"):
                self._pushback = line
                break
            parts.append(line[:-1])  # reference drops the last char per line
        seq = b"".join(parts)
        if len(seq) == 0:
            return None
        return RawRead(header, seq, None, len(seq))


def next_chunk(
    stream1: ReadStream,
    stream2: ReadStream | None,
    pair_end: bool,
    pacbio: bool,
) -> list[RawRead]:
    """GetNextChunk / gzGetNextChunk (GetData.cpp:109-143,184-219)."""
    limit = PACBIO_CHUNK_SIZE if pacbio else READ_CHUNK_SIZE
    out: list[RawRead] = []
    while True:
        r1 = stream1.next_entry()
        if r1 is None or r1.rlen == 0:
            break
        out.append(r1)
        r2 = (stream2 or stream1).next_entry()
        if r2 is None or r2.rlen == 0:
            break
        if pair_end:
            r2.seq = _revcomp(r2.seq)
            if r2.qual is not None:
                r2.qual = r2.qual[::-1]
        out.append(r2)
        if len(out) == limit:
            break
    return out
