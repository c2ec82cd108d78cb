"""On-disk index format, byte-compatible with the reference aligner.

The reference stores a genome index as five files (reference:
src/BWT_Index/bwt.c:174-196, bntseq.c:59-89,192-205):

  .bwt  primary(u64), L2[1..4](u64 x4), then interleaved blocks per 128
        text bases: Occ checkpoint (4 x u64 counts) followed by 8 x u32
        words of 2-bit BWT codes (16 bases/word, first base in bits 30-31),
        terminated by a final Occ checkpoint.
  .sa   primary(u64), L2[1..4](u64 x4), sa_intv(u64)=32, seq_len(u64),
        sampled suffix array values sa[1..n_sa-1] (u64; sa[0] == seq_len is
        implicit / stored as -1 in memory).
  .pac  forward genome 2-bit packed (4 bases/byte, first base in bits 6-7),
        then a pad byte if len%4==0, then a byte holding len%4.
  .ann  text: "l_pac n_seqs seed", then per sequence "gi name [comment]" and
        "offset len n_ambs".
  .amb  text: "l_pac n_seqs n_holes", then per hole "offset len ambchar".

The BWT covers the concatenation T = forward genome + reverse complement
(length seq_len = 2L) with an implicit sentinel: `primary` is the suffix-array
row of the full-text suffix and the sentinel's BWT char is omitted.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

OCC_INTERVAL = 128
SA_INTERVAL = 32

# nst_nt4_table equivalent: ASCII -> 2-bit code, 4 for ambiguous
# (reference: src/BWT_Index/bntseq.c:40-57).
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i
NT4_TABLE[ord("-")] = 5

CODE_TO_ASCII = np.frombuffer(b"ACGTN", dtype=np.uint8)


@dataclass
class FastaSeq:
    name: str
    comment: str
    seq: np.ndarray  # raw ASCII bytes (uint8)


def parse_fasta(path: str):
    """Minimal FASTA parser matching kseq semantics: name = first token after
    '>', comment = rest of header line, sequence = concatenated printable
    chars of following lines."""
    seqs: list[FastaSeq] = []
    name = None
    comment = ""
    chunks: list[bytes] = []
    opener = open
    if path.endswith(".gz"):
        import gzip

        opener = gzip.open
    with opener(path, "rb") as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">") or line.startswith(b"@"):
                if name is not None:
                    seqs.append(
                        FastaSeq(name, comment, np.frombuffer(b"".join(chunks), dtype=np.uint8))
                    )
                header = line[1:].decode("ascii", "replace")
                parts = header.split(None, 1)
                name = parts[0] if parts else ""
                comment = parts[1] if len(parts) > 1 else ""
                chunks = []
            elif name is not None:
                # keep printable, non-space chars only (kseq isgraph())
                chunks.append(bytes(c for c in line if 0x21 <= c <= 0x7E))
    if name is not None:
        seqs.append(FastaSeq(name, comment, np.frombuffer(b"".join(chunks), dtype=np.uint8)))
    return seqs


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes (values 0..3) 4 per byte, first base in bits 6-7."""
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(-1, 4)
    return (
        (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]
    ).astype(np.uint8)


def unpack_2bit(pac: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit: first n 2-bit codes."""
    b = pac.astype(np.uint8)
    out = np.empty(len(b) * 4, dtype=np.uint8)
    out[0::4] = (b >> 6) & 3
    out[1::4] = (b >> 4) & 3
    out[2::4] = (b >> 2) & 3
    out[3::4] = b & 3
    return out[:n]


def pack_words_u32(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes into uint32 words, 16 bases/word, first base in bits
    30-31 (the layout of bwt words in .bwt).  Chunked so gigabase inputs do
    not materialize (n, 16) uint32 temporaries."""
    n = len(codes)
    nw = (n + 15) // 16
    out = np.empty(nw, dtype=np.uint32)
    shifts = np.arange(30, -2, -2, dtype=np.uint32)
    CHUNK_W = 1 << 22  # 4M words = 64M codes per pass
    for w0 in range(0, nw, CHUNK_W):
        w1 = min(w0 + CHUNK_W, nw)
        c0, c1 = w0 * 16, min(w1 * 16, n)
        padded = np.zeros((w1 - w0) * 16, dtype=np.uint32)
        padded[: c1 - c0] = codes[c0:c1]
        g = padded.reshape(-1, 16)
        out[w0:w1] = (g << shifts[None, :]).sum(axis=1, dtype=np.uint32)
    return out


def write_pac(prefix: str, codes_fwd: np.ndarray) -> None:
    l_pac = len(codes_fwd)
    data = pack_2bit(codes_fwd).tobytes()
    with open(prefix + ".pac", "wb") as f:
        f.write(data[: (l_pac >> 2) + (0 if l_pac % 4 == 0 else 1)])
        if l_pac % 4 == 0:
            f.write(b"\x00")
        f.write(bytes([l_pac % 4]))


def write_ann_amb(prefix: str, l_pac: int, seqs, holes, seed: int = 11) -> None:
    with open(prefix + ".ann", "w") as f:
        f.write(f"{l_pac} {len(seqs)} {seed}\n")
        offset = 0
        for s, n_ambs in seqs:
            anno = s.comment if s.comment else "(null)"
            f.write(f"0 {s.name} {anno}\n" if anno else f"0 {s.name}\n")
            f.write(f"{offset} {len(s.seq)} {n_ambs}\n")
            offset += len(s.seq)
    with open(prefix + ".amb", "w") as f:
        f.write(f"{l_pac} {len(seqs)} {len(holes)}\n")
        for off, hlen, ch in holes:
            f.write(f"{off} {hlen} {ch}\n")


def interleave_bwt(bwt_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, bytes]:
    """From the linear BWT 2-bit code sequence (length seq_len, sentinel
    removed), produce (occ_cp (n_blocks,4) int64, words (n_blocks,8) uint32,
    interleaved bytes for the .bwt payload including the final checkpoint)."""
    seq_len = len(bwt_codes)
    n_blocks = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    words = pack_words_u32(bwt_codes)
    nw = len(words)
    words_pad = np.zeros(n_blocks * 8, dtype=np.uint32)
    words_pad[:nw] = words
    words_blocks = words_pad.reshape(n_blocks, 8)

    # cumulative counts of each code value at the START of each block.
    # Blockwise (per-128-base counts then an exclusive cumsum) rather than a
    # full one-hot cumsum: on a gigabase text the latter would materialize
    # two (4, seq_len) int64 arrays (~70 GB each).
    padded_codes = np.full(n_blocks * OCC_INTERVAL, 255, dtype=np.uint8)
    padded_codes[:seq_len] = bwt_codes
    blk = padded_codes.reshape(n_blocks, OCC_INTERVAL)
    per_block = np.stack(
        [(blk == c).sum(axis=1, dtype=np.int64) for c in range(4)], axis=1
    )  # (n_blocks, 4)
    occ_cp = np.zeros((n_blocks, 4), dtype=np.int64)
    np.cumsum(per_block[:-1], axis=0, out=occ_cp[1:])
    final_cp = occ_cp[-1] + per_block[-1]  # (4,)

    # serialize: per block [4 x u64][up to 8 x u32], plus final checkpoint.
    # The last block carries only ceil(rem/16) words (bwtindex.c:62-71 emits
    # words only while i < seq_len); all earlier blocks are a fixed 64 bytes,
    # so they serialize as one (n_blocks-1, 64) byte matrix.
    n_last_words = nw - (n_blocks - 1) * 8
    full = np.empty((n_blocks - 1, 64), dtype=np.uint8) if n_blocks > 1 else np.empty((0, 64), np.uint8)
    if n_blocks > 1:
        full[:, :32] = occ_cp[:-1].astype("<u8").view(np.uint8).reshape(-1, 32)
        full[:, 32:] = words_blocks[:-1].astype("<u4").view(np.uint8).reshape(-1, 32)
    out = bytearray()
    out += full.tobytes()
    out += occ_cp[-1].astype("<u8").tobytes()
    out += words_blocks[-1, :n_last_words].astype("<u4").tobytes()
    out += np.asarray(final_cp).astype("<u8").tobytes()
    return occ_cp, words_blocks, bytes(out)


def write_bwt(prefix: str, primary: int, l2: np.ndarray, payload: bytes) -> None:
    with open(prefix + ".bwt", "wb") as f:
        f.write(np.array([primary], dtype="<u8").tobytes())
        f.write(np.asarray(l2[1:5], dtype="<u8").tobytes())
        f.write(payload)


def write_sa(prefix: str, primary: int, l2: np.ndarray, seq_len: int, sa_samples: np.ndarray) -> None:
    with open(prefix + ".sa", "wb") as f:
        f.write(np.array([primary], dtype="<u8").tobytes())
        f.write(np.asarray(l2[1:5], dtype="<u8").tobytes())
        f.write(np.array([SA_INTERVAL, seq_len], dtype="<u8").tobytes())
        f.write(np.asarray(sa_samples[1:], dtype="<u8").tobytes())


# ---------------------------------------------------------------------------
# Readers (load a reference-format index from disk)
# ---------------------------------------------------------------------------


@dataclass
class RawIndex:
    primary: int
    L2: np.ndarray  # int64[5], L2[0] = 0
    seq_len: int
    occ_cp: np.ndarray  # (n_blocks, 4) int64
    bwt_words: np.ndarray  # (n_blocks, 8) uint32
    sa_intv: int
    sa_samples: np.ndarray  # (n_sa,) int64, sa_samples[0] == -1
    l_pac: int
    pac: np.ndarray  # packed forward genome bytes
    chrom_names: list[str] = field(default_factory=list)
    chrom_lens: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    ann_offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    prefix: str = ""


def read_bwt_file(path: str):
    data = open(path, "rb").read()
    primary = int(np.frombuffer(data[:8], dtype="<u8")[0])
    l2 = np.zeros(5, dtype=np.int64)
    l2[1:] = np.frombuffer(data[8:40], dtype="<u8").astype(np.int64)
    seq_len = int(l2[4])
    payload = data[40:]
    n_blocks = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    nw = (seq_len + 15) // 16
    n_full = nw // 8  # number of blocks carrying all 8 words
    blocks = np.frombuffer(payload[: n_full * 64], dtype=np.uint8).reshape(n_full, 64)
    occ_cp = np.zeros((n_blocks, 4), dtype=np.int64)
    words = np.zeros((n_blocks, 8), dtype=np.uint32)
    occ_cp[:n_full] = blocks[:, :32].copy().view("<u8").astype(np.int64)
    words[:n_full] = blocks[:, 32:].copy().view("<u4")
    if n_full < n_blocks:  # trailing partial block
        off = n_full * 64
        occ_cp[n_full] = np.frombuffer(payload[off : off + 32], dtype="<u8").astype(np.int64)
        n_words = nw - n_full * 8
        words[n_full, :n_words] = np.frombuffer(
            payload[off + 32 : off + 32 + 4 * n_words], dtype="<u4"
        )
    return primary, l2, seq_len, occ_cp, words


def read_sa_file(path: str, seq_len: int):
    data = open(path, "rb").read()
    vals = np.frombuffer(data, dtype="<u8")
    sa_intv = int(vals[5])
    n_sa = (seq_len + sa_intv) // sa_intv
    sa = np.empty(n_sa, dtype=np.int64)
    sa[0] = -1
    sa[1:] = vals[7 : 7 + n_sa - 1].astype(np.int64)
    return sa_intv, sa


def read_ann_file(path: str):
    with open(path) as f:
        tokens_line = f.readline().split()
        l_pac, n_seqs = int(tokens_line[0]), int(tokens_line[1])
        names, lens, offsets = [], [], []
        for _ in range(n_seqs):
            header = f.readline().split(None, 2)
            names.append(header[1])
            meta = f.readline().split()
            offsets.append(int(meta[0]))
            lens.append(int(meta[1]))
    return l_pac, names, np.array(lens, dtype=np.int64), np.array(offsets, dtype=np.int64)


def read_pac_file(path: str):
    data = np.frombuffer(open(path, "rb").read(), dtype=np.uint8)
    # file layout: ceil(l/4) bytes, [pad byte if l%4==0], then a byte = l%4
    rem = int(data[-1])
    l_pac = (len(data) - 2) * 4 + rem
    return data[: (l_pac + 3) // 4], l_pac


def load_raw_index(prefix: str) -> RawIndex:
    primary, l2, seq_len, occ_cp, words = read_bwt_file(prefix + ".bwt")
    sa_intv, sa = read_sa_file(prefix + ".sa", seq_len)
    l_pac, names, lens, offsets = read_ann_file(prefix + ".ann")
    pac, l_pac2 = read_pac_file(prefix + ".pac")
    assert l_pac == l_pac2, f".ann/.pac length mismatch: {l_pac} vs {l_pac2}"
    return RawIndex(
        primary=primary,
        L2=l2,
        seq_len=seq_len,
        occ_cp=occ_cp,
        bwt_words=words,
        sa_intv=sa_intv,
        sa_samples=sa,
        l_pac=l_pac,
        pac=pac,
        chrom_names=names,
        chrom_lens=lens,
        ann_offsets=offsets,
        prefix=prefix,
    )


def index_files_exist(prefix: str) -> bool:
    return all(os.path.exists(prefix + ext) for ext in (".ann", ".amb", ".pac", ".bwt", ".sa"))
