"""2-bit read upload and the resolved seeding entry points.

Counterpart of `kart_tpu/ops/pack.py`.  Host half (numpy): `pack_reads_2bit`
packs (B, l_max) int8 codes 16 bases per uint32 word with a sparse list of
the runs of ambiguous bases (the C++ packer of native/kart_post.cpp;
`pack_reads_2bit_plain` is its numpy version), and `unpack_stream` decodes
the downloaded stream.

The ambiguity list: entry i covers bases [start, start + len) of row
amb_r[i], with amb_p[i] = start | (len - 1) << 16 (start < 2**16, len <=
2**15).  The packer gives one entry per maximal run of codes > 3 in a row,
row-major, so a read's pad to l_max costs one entry.  kart_tpu's list of
single positions is the case len 1, and every consumer takes either.
Consumers clip a run to l_max and drop an entry whose row is outside
[0, B) (the capacity pads carry row B) or whose amb_p is negative.

Device half (torch):
`unpack_reads` (the inverse of the packer), the three scans of packed reads
(`seed_scan_packed`, `sensitive_scan_packed`, `kmer_seed_scan_packed`), and the
three resolved entry points, each from packed reads to the packed int32
stream of ops/resolve.py, the scan recorded as the span `kart.funnel` or
`kart.fm_scan` and the resolve as `kart.resolve` (utils/trace.span):

  seed_scan_resolved_packed       FM stepper, then expand/resolve/pack
  sensitive_scan_resolved_packed  SensitiveMode FM stepper, then the same
  kmer_seed_scan_resolved_packed  13-mer funnel (FastMode, or SensitiveMode
                                  with sensitive=True), then the same

On CUDA tensors they launch the port's kernels (the funnel kernel unpacks
the reads itself); on CPU tensors they run the plain versions.  The FM
entry points resolve occurrences through the full SA or, with sa_mode
"sampled", through the walk over the sampled SA; the funnel's tables carry
their own full SA.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.trace import span
from .fm_search import seed_scan, sensitive_scan
from .kmer_seed import HIT_BUDGET, SLAB_ROWS, kmer_seed_scan_plain
from .resolve import pack_stream_plain, resolve_pack  # noqa: F401  (kart_tpu keeps it here)

# sparse-ambiguity capacity buckets, padded with out-of-range rows (B)
_AMB_BUCKETS = [0, 256, 4096]
AMB_RUN_MAX = 1 << 15  # bases of one entry of the ambiguity list at most
AMB_START_MAX = 1 << 16  # l_max at most: a run's start fits amb_p's low 16 bits
_M32 = 0xFFFFFFFF


def _amb_bucket(n: int) -> int:
    for b in _AMB_BUCKETS:
        if n <= b:
            return b
    return n


def pack_reads_2bit(reads_i8: np.ndarray):
    """(B, l_max) int8 codes (0..3, >3 ambiguous) -> words (B, ceil(L/16))
    uint32, amb_r and amb_p (int32 runs of ambiguous bases, as the module's
    docstring gives them, padded to a capacity bucket with row B), by the
    C++ packer; a failed build of its library raises."""
    _check_run_starts(reads_i8.shape[1])
    return _native_pack(np.ascontiguousarray(reads_i8, dtype=np.int8))


def _check_run_starts(l_max: int) -> None:
    if l_max > AMB_START_MAX:
        raise ValueError(f"l_max {l_max} > {AMB_START_MAX}: a run's start must fit 16 bits")


def pack_reads_2bit_plain(reads_i8: np.ndarray):
    """pack_reads_2bit in numpy: the plain version of the C++ packer."""
    B, L = reads_i8.shape
    _check_run_starts(L)
    nw = -(-L // 16)
    amb_mask = reads_i8 > 3
    codes = np.where(amb_mask, 0, reads_i8).astype(np.uint32)
    padded = np.zeros((B, nw * 16), np.uint32)
    padded[:, :L] = codes
    shifts = (2 * np.arange(16)).astype(np.uint32)
    words = (padded.reshape(B, nw, 16) << shifts).sum(axis=2, dtype=np.uint32)
    # maximal runs: +1 where one starts, -1 where one ends (exclusive)
    edges = np.diff(np.pad(amb_mask, ((0, 0), (1, 1))).astype(np.int8), axis=1)
    rows, starts = np.nonzero(edges == 1)
    lens = np.nonzero(edges == -1)[1] - starts
    # a run past AMB_RUN_MAX bases in pieces of AMB_RUN_MAX
    pieces = -(-lens // AMB_RUN_MAX)
    run = np.repeat(np.arange(len(lens)), pieces)
    k = np.arange(len(run)) - np.repeat(np.cumsum(pieces) - pieces, pieces)
    starts = starts[run] + k * AMB_RUN_MAX
    lens = np.minimum(lens[run] - k * AMB_RUN_MAX, AMB_RUN_MAX)
    cap = _amb_bucket(len(run))
    r = np.full(cap, B, np.int32)
    p = np.zeros(cap, np.int32)
    r[: len(run)] = rows[run]
    p[: len(run)] = starts | ((lens - 1) << 16)
    return words, r, p


def _native_pack(reads_i8):
    """The C++ packer (kart_pack_reads_2bit), called as kart_tpu calls its own."""
    from ..native.post import load_postlib

    lib = load_postlib()
    B, L = reads_i8.shape
    nw = -(-L // 16)
    cap = _AMB_BUCKETS[-1]
    while True:
        words = np.empty((B, nw), np.uint32)
        amb_r = np.full(cap, B, np.int32)
        amb_p = np.zeros(cap, np.int32)
        n = lib.kart_pack_reads_2bit(
            reads_i8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            ctypes.c_int32(B), ctypes.c_int32(L),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.c_int32(nw),
            amb_r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            amb_p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(cap),
        )
        if n <= cap:
            b = _amb_bucket(int(n))
            if b < cap:
                amb_r2 = np.full(b, B, np.int32)
                amb_p2 = np.zeros(b, np.int32)
                amb_r2[:n] = amb_r[:n]
                amb_p2[:n] = amb_p[:n]
                return words, amb_r2, amb_p2
            return words, amb_r, amb_p
        cap = 1 << int(np.ceil(np.log2(n)))


def unpack_stream(packed, B: int, H: int, pack16: bool = False):
    """Host inverse of the stream packing -> (cnts i32 (B,), meta i32
    rpos | slen << 16 (H,), gpos (H,)); a (cnts, meta, gpos) tuple (an int64
    index's stream) comes back as numpy arrays."""
    if isinstance(packed, (tuple, list)):
        return tuple(np.asarray(x) for x in packed)
    arr = np.asarray(packed)
    if not pack16:
        return arr[:B], arr[B : B + H], arr[B + H :]
    cw = arr[: B // 2]
    mw = arr[B // 2 : B // 2 + H // 2]
    gpos = arr[B // 2 + H // 2 :]
    cnts = cw.view(np.int16).astype(np.int32)
    m16 = mw.view(np.uint16).astype(np.int32)
    meta = (m16 & 0xFF) | ((((m16 >> 8) & 0xFF) + 1) << 16)
    return cnts, meta, gpos


def pack_codes_2bit(reads: torch.Tensor):
    """Pack (B, l_max) codes on any device through the host packer; the
    three arrays come back on the reads' device (words as int32 bits)."""
    words, amb_r, amb_p = pack_reads_2bit(reads.cpu().numpy().astype(np.int8))
    dev = reads.device
    return (torch.from_numpy(words.view(np.int32)).to(dev), torch.from_numpy(amb_r).to(dev),
            torch.from_numpy(amb_p).to(dev))


# ---------------------------------------------------------------------------
# Device half
# ---------------------------------------------------------------------------


def unpack_reads_plain(words, amb_r, amb_p, l_max: int):
    """kart_tpu's unpack_reads_device: words (B, nw) int32 (uint32 bits) and
    the sparse ambiguity list (runs, or kart_tpu's single positions) ->
    (B, l_max) int32 codes, ambiguous bases 4."""
    B = words.shape[0]
    j = torch.arange(l_max, device=words.device)
    w = words.long()[:, j >> 4] & _M32
    reads = ((w >> (2 * (j & 15))) & 3).to(torch.int32)
    r, p = amb_r.long(), amb_p.long()
    start = p & 0xFFFF
    end = torch.clamp(start + ((p >> 16) & 0x7FFF) + 1, max=l_max)
    keep = (r >= 0) & (r < B) & (p >= 0) & (start < l_max)
    r, start, end = r[keep], start[keep], end[keep]
    # +1 at each run's start, -1 at its end: a base is ambiguous where the
    # running sum is positive (runs may overlap)
    edge = torch.zeros((B, l_max + 1), dtype=torch.int32, device=words.device)
    one = torch.ones(len(r), dtype=torch.int32, device=words.device)
    edge.index_put_((r, start), one, accumulate=True)
    edge.index_put_((r, end), -one, accumulate=True)
    reads[edge.cumsum(1)[:, :l_max] > 0] = 4
    return reads


def unpack_reads(words, amb_r, amb_p, l_max: int):
    """(B, l_max) int32 codes from packed reads.  CPU tensors run the plain
    version, CUDA tensors the kernel."""
    if words.device.type == "cuda":
        from ..kernels import unpack_reads as kernel

        return kernel(words, amb_r, amb_p, l_max=l_max)
    if words.device.type != "cpu":
        raise ValueError(f"unpack_reads: unsupported device {words.device}")
    return unpack_reads_plain(words, amb_r, amb_p, l_max)


def _resolver(sa_full, sa_mode: str):
    """kart_tpu's _resolver: the full SA for "full" (which must be given),
    None (the sampled-SA walk over the FM index) for "sampled"."""
    if sa_mode == "sampled":
        return None
    if sa_mode != "full":
        raise ValueError(f"unknown sa_mode {sa_mode!r}")
    if sa_full is None:
        raise ValueError('sa_mode "full" needs the full SA')
    return sa_full


def seed_scan_packed(fm, words, amb_r, amb_p, rlens, min_seed_len, *, max_seeds, l_max):
    """FM-stepper seeds of packed reads, in seed_scan's packed
    (B, 1 + 4*max_seeds) layout."""
    reads = unpack_reads(words, amb_r, amb_p, l_max)
    return seed_scan(fm, reads, rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max)


def seed_scan_resolved_packed(fm, sa_full, words, amb_r, amb_p, rlens, min_seed_len, *,
                              max_seeds, l_max, occ_budget, sa_mode="full", pack16=False):
    """FM-stepper seeding of packed reads, resolved through the full SA
    (sa_full on the reads' device) or, with sa_mode "sampled", through the
    walk over fm's sampled SA, and packed into one int32 stream (the tuple
    (cnts, meta, gpos) on an int64 index)."""
    with span("kart.fm_scan"):
        packed = seed_scan_packed(fm, words, amb_r, amb_p, rlens, min_seed_len,
                                  max_seeds=max_seeds, l_max=l_max)
    with span("kart.resolve"):
        return resolve_pack(_resolver(sa_full, sa_mode), packed, max_seeds=max_seeds,
                            has_ok=False, occ_budget=occ_budget, pack16=pack16, fm=fm)


def sensitive_scan_packed(fm, words, amb_r, amb_p, rlens, min_seed_len, *, max_seeds, l_max):
    """SensitiveMode FM-stepper seeds of packed reads, in seed_scan's packed
    (B, 1 + 4*max_seeds) layout."""
    reads = unpack_reads(words, amb_r, amb_p, l_max)
    return sensitive_scan(fm, reads, rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max)


def sensitive_scan_resolved_packed(fm, sa_full, words, amb_r, amb_p, rlens, min_seed_len, *,
                                   max_seeds, l_max, occ_budget, sa_mode="full", pack16=False):
    """SensitiveMode FM-stepper seeding of packed reads, resolved as
    seed_scan_resolved_packed resolves them."""
    with span("kart.fm_scan"):
        packed = sensitive_scan_packed(fm, words, amb_r, amb_p, rlens, min_seed_len,
                                       max_seeds=max_seeds, l_max=l_max)
    with span("kart.resolve"):
        return resolve_pack(_resolver(sa_full, sa_mode), packed, max_seeds=max_seeds,
                            has_ok=False, occ_budget=occ_budget, pack16=pack16, fm=fm)


def kmer_seed_scan_packed(tt, words, amb_r, amb_p, rlens, min_seed_len, *, max_seeds, l_max,
                          hit_cap, rounds, sensitive=False, slab_rows=SLAB_ROWS,
                          hit_budget=HIT_BUDGET):
    """13-mer funnel seeds of packed reads (FastMode, or SensitiveMode) in
    the funnel's (B, 2 + 4*max_seeds) layout; flagged lanes carry ok 0.
    CPU tensors run the plain version, CUDA tensors the kernel (which
    unpacks the reads itself)."""
    kw = dict(max_seeds=max_seeds, l_max=l_max, hit_cap=hit_cap, rounds=rounds,
              sensitive=sensitive, slab_rows=slab_rows, hit_budget=hit_budget)
    if words.device.type == "cuda":
        from ..kernels import kmer_funnel

        return kmer_funnel(tt, words, amb_r, amb_p, rlens, int(min_seed_len), **kw)
    if words.device.type != "cpu":
        raise ValueError(f"kmer_seed_scan_packed: unsupported device {words.device}")
    reads = unpack_reads_plain(words, amb_r, amb_p, l_max)
    return kmer_seed_scan_plain(tt, reads, rlens, min_seed_len, **kw)


def kmer_seed_scan_resolved_packed(tt, words, amb_r, amb_p, rlens, min_seed_len, *, max_seeds,
                                   l_max, hit_cap, rounds, occ_budget, sensitive=False,
                                   pack16=False, slab_rows=SLAB_ROWS, hit_budget=HIT_BUDGET):
    """13-mer funnel seeding of packed reads (FastMode, or SensitiveMode),
    resolved through the full SA and packed into one int32 stream; lanes
    the funnel flags carry cnts < 0."""
    with span("kart.funnel"):
        packed = kmer_seed_scan_packed(tt, words, amb_r, amb_p, rlens, min_seed_len,
                                       max_seeds=max_seeds, l_max=l_max, hit_cap=hit_cap,
                                       rounds=rounds, sensitive=sensitive, slab_rows=slab_rows,
                                       hit_budget=hit_budget)
    with span("kart.resolve"):
        return resolve_pack(tt.sa_full, packed, max_seeds=max_seeds, has_ok=True,
                            occ_budget=occ_budget, pack16=pack16)
