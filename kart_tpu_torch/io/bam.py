"""Minimal BAM writer (BGZF + BAM record encoding).

Replaces the reference's use of vendored htslib for `-bo` output
(reference: src/Mapping.cpp:610-621 uses sam_parse1 + sam_write1; the BAM
spec is implemented here directly).  Produces standard BGZF-compressed BAM
readable by samtools/pysam."""

from __future__ import annotations

import struct
import zlib

_BGZF_MAX = 65280  # payload bytes per BGZF block

_CIGAR_OPS = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}
_SEQ_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def _bgzf_block(data: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25 + 1
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00"
        + struct.pack("<H", bsize - 1)
    )
    return header + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))


_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfWriter:
    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.buf = bytearray()

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= _BGZF_MAX:
            self.f.write(_bgzf_block(bytes(self.buf[:_BGZF_MAX])))
            del self.buf[:_BGZF_MAX]

    def close(self):
        if self.buf:
            self.f.write(_bgzf_block(bytes(self.buf)))
            self.buf.clear()
        self.f.write(_BGZF_EOF)
        self.f.close()


def encode_bam_record(line: str, ref_ids: dict) -> bytes:
    """Encode one SAM text line as a BAM record (sam_write1 equivalent)."""
    fields = line.rstrip("\n").split("\t")
    qname, flag, rname, pos, mapq, cigar, rnext, pnext, tlen = fields[:9]
    seq, qual = fields[9], fields[10]
    tags = fields[11:]

    ref_id = ref_ids.get(rname, -1)
    pos0 = int(pos) - 1
    flag_i = int(flag)
    mapq_i = int(mapq)

    cig_ops = []
    if cigar != "*":
        num = 0
        for ch in cigar:
            if ch.isdigit():
                num = num * 10 + ord(ch) - 48
            else:
                cig_ops.append((num << 4) | _CIGAR_OPS[ch])
                num = 0
    if rnext == "=":
        next_ref = ref_id
    elif rnext == "*":
        next_ref = -1
    else:
        next_ref = ref_ids.get(rnext, -1)

    l_seq = 0 if seq == "*" else len(seq)
    seq_bytes = bytearray((l_seq + 1) // 2)
    if seq != "*":
        for i, c in enumerate(seq):
            v = _SEQ_NT16.get(c.upper(), 15)
            if i % 2 == 0:
                seq_bytes[i // 2] = v << 4
            else:
                seq_bytes[i // 2] |= v
    if qual == "*" or l_seq == 0:
        qual_bytes = b"\xff" * l_seq
    else:
        qual_bytes = bytes((ord(c) - 33) & 0xFF for c in qual)

    # bin (reg2bin of [pos, end))
    end = pos0 + 1
    if cig_ops:
        end = pos0
        for op in cig_ops:
            o = op & 0xF
            if o in (0, 2, 3, 7, 8):  # M D N = X consume reference
                end += op >> 4
        end = max(end, pos0 + 1)
    b = _reg2bin(pos0, end)

    name_b = qname.encode() + b"\x00"
    rec = bytearray()
    rec += struct.pack(
        "<iiBBHHHiiii",
        ref_id,
        pos0,
        len(name_b),
        mapq_i,
        b,
        len(cig_ops),
        flag_i,
        l_seq,
        next_ref,
        int(pnext) - 1,
        int(tlen),
    )
    rec += name_b
    for op in cig_ops:
        rec += struct.pack("<I", op)
    rec += bytes(seq_bytes)
    rec += qual_bytes
    for tag in tags:
        tg, ty, val = tag.split(":", 2)
        if ty == "i":
            # htslib sam_parse1 picks the smallest integer width
            x = int(val)
            if 0 <= x <= 0xFF:
                rec += tg.encode() + b"C" + struct.pack("<B", x)
            elif -128 <= x < 0:
                rec += tg.encode() + b"c" + struct.pack("<b", x)
            elif 0 <= x <= 0xFFFF:
                rec += tg.encode() + b"S" + struct.pack("<H", x)
            elif -32768 <= x < 0:
                rec += tg.encode() + b"s" + struct.pack("<h", x)
            else:
                rec += tg.encode() + b"i" + struct.pack("<i", x)
        elif ty == "A":
            rec += tg.encode() + b"A" + val.encode()[:1]
        elif ty == "f":
            rec += tg.encode() + b"f" + struct.pack("<f", float(val))
        else:  # Z and fallback
            rec += tg.encode() + b"Z" + val.encode() + b"\x00"
    return struct.pack("<i", len(rec)) + bytes(rec)


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamWriter:
    """SAM-text -> BAM sink used by the CLI's -bo path."""

    def __init__(self, path: str, gidx, version: str = "2.5.6"):
        self.bgzf = BgzfWriter(path)
        self.gidx = gidx
        self.ref_ids = {n: i for i, n in enumerate(gidx.raw.chrom_names)}
        self._header_written = False

    def write_sam_text(self, text: str):
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("@"):
                self._header_text = getattr(self, "_header_text", "") + line + "\n"
                continue
            if not self._header_written:
                self._write_header()
            self.bgzf.write(encode_bam_record(line, self.ref_ids))

    def _write_header(self):
        text = getattr(self, "_header_text", "")
        hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
        hdr += struct.pack("<i", self.gidx.n_chrom)
        for i in range(self.gidx.n_chrom):
            name = self.gidx.raw.chrom_names[i].encode() + b"\x00"
            hdr += struct.pack("<i", len(name)) + name
            hdr += struct.pack("<i", int(self.gidx.raw.chrom_lens[i]))
        self.bgzf.write(hdr)
        self._header_written = True

    def close(self):
        if not self._header_written:
            self._write_header()
        self.bgzf.close()
