"""2-bit read upload and the resolved seeding entry points.

Counterpart of `kart_tpu/ops/pack.py`.  Host half (numpy): `pack_reads_2bit`
packs (B, l_max) int8 codes 16 bases per uint32 word with a sparse list of
ambiguous positions (the C++ packer of native/kart_post.cpp;
`pack_reads_2bit_plain` is its numpy version), and `unpack_stream` decodes
the downloaded stream.  Device half (torch):
`unpack_reads` (the inverse of the packer), `sensitive_scan_packed`, and the
three resolved entry points, each from packed reads to the packed int32
stream of ops/resolve.py:

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

from .fm_search import seed_scan, sensitive_scan
from .kmer_seed import HIT_BUDGET, SLAB_ROWS, kmer_seed_scan_plain
from .resolve import pack_stream_plain, resolve_pack  # noqa: F401  (kart_tpu keeps it here)

# sparse-ambiguity capacity buckets, padded with out-of-range rows (B)
_AMB_BUCKETS = [0, 256, 4096]
_M32 = 0xFFFFFFFF


def _amb_bucket(n: int) -> int:
    for b in _AMB_BUCKETS:
        if n <= b:
            return b
    return n


def pack_reads_2bit(reads_i8: np.ndarray):
    """(B, l_max) int8 codes (0..3, >3 ambiguous) -> words (B, ceil(L/16))
    uint32, amb_r and amb_p (int32 coordinates of the ambiguous bases,
    padded to a capacity bucket with row B), by the C++ packer; a failed
    build of its library raises."""
    return _native_pack(np.ascontiguousarray(reads_i8, dtype=np.int8))


def pack_reads_2bit_plain(reads_i8: np.ndarray):
    """pack_reads_2bit in numpy: the plain version of the C++ packer."""
    B, L = reads_i8.shape
    nw = -(-L // 16)
    amb_mask = reads_i8 > 3
    codes = np.where(amb_mask, 0, reads_i8).astype(np.uint32)
    padded = np.zeros((B, nw * 16), np.uint32)
    padded[:, :L] = codes
    shifts = (2 * np.arange(16)).astype(np.uint32)
    words = (padded.reshape(B, nw, 16) << shifts).sum(axis=2, dtype=np.uint32)
    amb_r, amb_p = np.nonzero(amb_mask)
    cap = _amb_bucket(len(amb_r))
    r = np.full(cap, B, np.int32)
    p = np.zeros(cap, np.int32)
    r[: len(amb_r)] = amb_r
    p[: len(amb_p)] = amb_p
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
    the sparse ambiguity list -> (B, l_max) int32 codes, ambiguous bases 4.
    Entries out of range are dropped (pads carry row B)."""
    B = words.shape[0]
    j = torch.arange(l_max, device=words.device)
    w = words.long()[:, j >> 4] & _M32
    reads = ((w >> (2 * (j & 15))) & 3).to(torch.int32)
    r, p = amb_r.long(), amb_p.long()
    keep = (r >= 0) & (r < B) & (p >= 0) & (p < l_max)
    reads[r[keep], p[keep]] = 4
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


def seed_scan_resolved_packed(fm, sa_full, words, amb_r, amb_p, rlens, min_seed_len, *,
                              max_seeds, l_max, occ_budget, sa_mode="full", pack16=False):
    """FM-stepper seeding of packed reads, resolved through the full SA
    (sa_full on the reads' device) or, with sa_mode "sampled", through the
    walk over fm's sampled SA, and packed into one int32 stream (the tuple
    (cnts, meta, gpos) on an int64 index)."""
    reads = unpack_reads(words, amb_r, amb_p, l_max)
    packed = seed_scan(fm, reads, rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max)
    return resolve_pack(_resolver(sa_full, sa_mode), packed, max_seeds=max_seeds, has_ok=False,
                        occ_budget=occ_budget, pack16=pack16, fm=fm)


def sensitive_scan_packed(fm, words, amb_r, amb_p, rlens, min_seed_len, *, max_seeds, l_max):
    """SensitiveMode FM-stepper seeds of packed reads, in seed_scan's packed
    (B, 1 + 4*max_seeds) layout."""
    reads = unpack_reads(words, amb_r, amb_p, l_max)
    return sensitive_scan(fm, reads, rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max)


def sensitive_scan_resolved_packed(fm, sa_full, words, amb_r, amb_p, rlens, min_seed_len, *,
                                   max_seeds, l_max, occ_budget, sa_mode="full", pack16=False):
    """SensitiveMode FM-stepper seeding of packed reads, resolved as
    seed_scan_resolved_packed resolves them."""
    packed = sensitive_scan_packed(fm, words, amb_r, amb_p, rlens, min_seed_len,
                                   max_seeds=max_seeds, l_max=l_max)
    return resolve_pack(_resolver(sa_full, sa_mode), packed, max_seeds=max_seeds, has_ok=False,
                        occ_budget=occ_budget, pack16=pack16, fm=fm)


def kmer_seed_scan_resolved_packed(tt, words, amb_r, amb_p, rlens, min_seed_len, *, max_seeds,
                                   l_max, hit_cap, rounds, occ_budget, sensitive=False,
                                   pack16=False, slab_rows=SLAB_ROWS, hit_budget=HIT_BUDGET):
    """13-mer funnel seeding of packed reads (FastMode, or SensitiveMode),
    resolved through the full SA and packed into one int32 stream; lanes
    the funnel flags carry cnts < 0."""
    kw = dict(max_seeds=max_seeds, l_max=l_max, hit_cap=hit_cap, rounds=rounds,
              sensitive=sensitive, slab_rows=slab_rows, hit_budget=hit_budget)
    if words.device.type == "cuda":
        from ..kernels import kmer_funnel

        packed = kmer_funnel(tt, words, amb_r, amb_p, rlens, int(min_seed_len), **kw)
    elif words.device.type == "cpu":
        reads = unpack_reads_plain(words, amb_r, amb_p, l_max)
        packed = kmer_seed_scan_plain(tt, reads, rlens, min_seed_len, **kw)
    else:
        raise ValueError(f"kmer_seed_scan_resolved_packed: unsupported device {words.device}")
    return resolve_pack(tt.sa_full, packed, max_seeds=max_seeds, has_ok=True,
                        occ_budget=occ_budget, pack16=pack16)
