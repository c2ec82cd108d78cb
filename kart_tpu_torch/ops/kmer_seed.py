"""Direct 13-mer lookup seeding (the funnel) on PyTorch tensors.

Counterpart of `kart_tpu/ops/kmer_seed.py` in FastMode: `build_tables`
(numpy, the same arrays and the same `.kmt` index sidecar, so the two
packages share one file), `KmerTablesTensors` (the tables on a torch
device) and `kmer_seed_scan`, which returns the same packed
(B, 2 + 4*max_seeds) int32 array as the JAX function:
[n_seeds | ok | rpos | slen | k0 | freq].  On CPU tensors it runs the plain
PyTorch version below; on CUDA tensors it launches the hand-written kernel
`csrc/kmer_funnel.cu` (kernels.kmer_funnel), which also unpacks the 2-bit
reads itself.

The output depends on how the batch is cut into slabs: every slab of
`slab_rows` reads shares one per-round hit budget H = hit_budget * rows,
and lanes whose hits overrun it are flagged (ok = 0) for the exact FM
re-seed.  Both versions take the slab size and the budget as parameters;
the defaults are kart_tpu's (4096 rows, 2 hits per lane), so that the flags
and hence the resolved stream equal kart_tpu's.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

K = 13
OCC_THR = 50
BITMAP_KS = (12, 11, 10, 9, 8, 7, 6, 5, 4)
SLAB_ROWS = 4096
HIT_BUDGET = 2
IDXB = 20  # idx field width of the packed segment-max words
IDXM = (1 << IDXB) - 1
_M32 = 0xFFFFFFFF
_I32_MIN = -(2**31)


@dataclass
class KmerSeedTables:
    """Host (numpy) tables of the funnel; the same arrays back kart_tpu's
    native C++ engine (NativePostProcessor seed tables)."""

    table_lo_np: np.ndarray  # (4^13 + 1,) int32: SA-interval start per 13-mer
    text_np: np.ndarray  # (2L + seg_pad,) int8 codes, padded with 5
    sa_full_np: np.ndarray  # (2L + 1,) int32
    bitmaps_np: tuple  # per k in BITMAP_KS: (4^k/32,) uint32 presence words
    sub_tbl_np: np.ndarray  # (4^13,) uint16: bit k set iff the k-prefix occurs
    seq_len: int
    max_mult: int  # max 13-mer multiplicity (sizes hit_cap)
    all_short_present: bool  # every 4-mer occurs (sub-13 lengths exact)

    def text_words_np(self) -> np.ndarray:
        """2-bit packed text, 16 bases per uint32, ambiguous and pad bases
        as 0 (kart_tpu's `text_words`)."""
        c = np.where(self.text_np > 3, 0, self.text_np).astype(np.uint32)
        nw = -(-len(c) // 16)
        pad = np.zeros(nw * 16, np.uint32)
        pad[: len(c)] = c
        shifts = (2 * np.arange(16)).astype(np.uint32)
        return (pad.reshape(nw, 16) << shifts).sum(axis=1, dtype=np.uint32)


def build_tables(gidx, seg_pad: int = 1024, cache: bool = True) -> KmerSeedTables:
    """Build the funnel's tables, or load them from the `.kmt` sidecar of
    the index (the file kart_tpu writes and reads)."""
    prefix = getattr(gidx.raw, "prefix", None)
    kmt = prefix + ".kmt" if prefix else None
    if cache and kmt and os.path.exists(kmt):
        try:
            z = np.load(kmt)
            return KmerSeedTables(
                table_lo_np=z["table_lo"],
                text_np=z["text"],
                sa_full_np=gidx.sa_full.astype(np.int32),
                bitmaps_np=tuple(z[f"bm{i}"] for i in range(len(BITMAP_KS))),
                sub_tbl_np=z["subtbl"],
                seq_len=int(z["seq_len"][0]),
                max_mult=int(z["seq_len"][1]),
                all_short_present=bool(z["seq_len"][2]),
            )
        except (OSError, KeyError, ValueError):
            pass  # unreadable or older sidecar: rebuild it
    tb = _build_tables_fresh(gidx, seg_pad)
    if cache and kmt:
        arrs = dict(
            table_lo=tb.table_lo_np,
            text=tb.text_np,
            subtbl=tb.sub_tbl_np,
            seq_len=np.array([tb.seq_len, tb.max_mult, int(tb.all_short_present)], np.int64),
        )
        for i, bm in enumerate(tb.bitmaps_np):
            arrs[f"bm{i}"] = bm
        tmp = kmt + ".tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrs)
            os.replace(tmp, kmt)
        except OSError:
            pass  # read-only index directory: the tables still serve this run
    return tb


def _build_tables_fresh(gidx, seg_pad: int = 1024) -> KmerSeedTables:
    codes = gidx.ref_codes.astype(np.int64)  # (2L,), values 0..3
    seq_len = int(gidx.seq_len)
    sa = gidx.sa_full.astype(np.int64)  # (2L+1,)

    # packed 13-mer at every text position, 0-padded past the end (the
    # short suffixes' bogus entries are filtered at query time)
    padded = np.concatenate([codes, np.zeros(K, np.int64)])
    kmer = np.zeros(seq_len + 1, dtype=np.int64)
    for i in range(K):
        kmer = (kmer << 2) | padded[i : i + seq_len + 1]
    counts = np.bincount(kmer[sa], minlength=4**K)
    table_lo = np.zeros(4**K + 1, dtype=np.int32)
    np.cumsum(counts, out=table_lo[1:])

    bitmaps = []
    all_short = True
    sub_tbl = np.zeros(4**K, dtype=np.uint16)
    all_ids13 = np.arange(4**K, dtype=np.int64)
    for k in BITMAP_KS:
        kk = np.zeros(seq_len - k + 1, dtype=np.int64)
        for i in range(k):
            kk = (kk << 2) | codes[i : i + seq_len - k + 1]
        present = np.zeros(4**k, dtype=bool)
        present[kk] = True
        if k == BITMAP_KS[-1]:
            all_short = bool(present.all())
        sub_tbl |= present[all_ids13 >> (2 * (K - k))].astype(np.uint16) << k
        words = np.packbits(present.reshape(-1, 32), axis=1, bitorder="little")
        bitmaps.append(np.frombuffer(words.tobytes(), dtype="<u4").copy())

    text_padded = np.concatenate([gidx.ref_codes.astype(np.int8), np.full(seg_pad, 5, np.int8)])
    return KmerSeedTables(
        table_lo_np=table_lo,
        text_np=text_padded,
        sa_full_np=gidx.sa_full.astype(np.int32),
        bitmaps_np=tuple(bitmaps),
        sub_tbl_np=sub_tbl,
        seq_len=seq_len,
        max_mult=int(counts.max()),
        all_short_present=all_short,
    )


@dataclass
class KmerTablesTensors:
    """The funnel's tables on one torch device.

    table_lo   (4^13+1,) int32   SA-interval start per 13-mer
    sub_tbl    (4^13,)   int16   uint16 bit patterns: bit k set iff the
                                 13-mer's k-prefix occurs
    sa_full    (2L+1,)   int32   full suffix array
    text_words (nw,)     int32   uint32 bit patterns, 16 text bases each
    """

    table_lo: torch.Tensor
    sub_tbl: torch.Tensor
    sa_full: torch.Tensor
    text_words: torch.Tensor
    seq_len: int
    max_mult: int

    @classmethod
    def from_tables(cls, tb: KmerSeedTables, device) -> KmerTablesTensors:
        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        return cls(
            table_lo=put(tb.table_lo_np.astype(np.int32, copy=False)),
            sub_tbl=put(tb.sub_tbl_np.view(np.int16)),
            sa_full=put(tb.sa_full_np.astype(np.int32, copy=False)),
            text_words=put(tb.text_words_np().view(np.int32)),
            seq_len=int(tb.seq_len),
            max_mult=int(tb.max_mult),
        )


def hit_cap_for(max_mult: int) -> int:
    """kart_tpu's per-lane interval cap: the power of two above max_mult."""
    return int(max(16, 1 << int(np.ceil(np.log2(max_mult + 1)))))


# ---------------------------------------------------------------------------
# Plain version (any device; the CPU path and the kernel's reference)
# ---------------------------------------------------------------------------


def _distance_tables_plain(amb: torch.Tensor, l_max: int):
    """Per (read, p): distance to the first ambiguous base at or after p,
    and to the first non-ambiguous one, both capped at l_max."""
    pos = torch.arange(l_max, dtype=torch.int32, device=amb.device)[None, :]
    big = 2 * l_max + 1

    def rev_cummin(x):
        return torch.cummin(x.flip(1), dim=1).values.flip(1)

    next_amb = rev_cummin(torch.where(amb, pos, big))
    next_base = rev_cummin(torch.where(~amb, pos, big))
    return (next_amb - pos).clamp(max=l_max), (next_base - pos).clamp(max=l_max)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _align_words(w: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """(N, W) uint32 words held in int64 and a bit shift (N, 1) in
    {0, 2, .., 30} -> the (N, W-1) words starting `sh` bits in."""
    hi = torch.where(sh > 0, (w[:, 1:] << (32 - sh)) & _M32, 0)
    return (w[:, :-1] >> sh) | hi


def _slab_plain(tt: KmerTablesTensors, reads, rlens, msl, *, max_seeds, l_max,
                hit_cap, rounds, H, stats=None):
    """One slab of the FastMode funnel: kart_tpu's _kmer_seed_scan_slab.
    `stats`, a list, gets one dict per slab: the rounds run and, per round,
    the 13-mer lookups (`lookups`), the hits handed out (`hits`) and the
    lanes that took the sub-13 path (`sub13`)."""
    B = reads.shape[0]
    dev = reads.device
    i32 = torch.int32
    bidx = torch.arange(B, device=dev)
    last_valid = tt.seq_len - K

    padded = torch.nn.functional.pad(reads, (0, K), value=4)
    kmer = torch.zeros((B, l_max), dtype=i32, device=dev)
    amb_in_win = torch.zeros((B, l_max), dtype=torch.bool, device=dev)
    for i in range(K):
        col = padded[:, i : i + l_max]
        kmer = (kmer << 2) | torch.where(col > 3, 0, col)
        amb_in_win |= col > 3
    amb = reads > 3
    amb_off, nonamb_off = _distance_tables_plain(amb, l_max)
    postab1 = kmer | (amb_in_win.to(i32) << 26)
    postab2 = (nonamb_off.clamp(max=0x7FFF) << 16) | amb_off.clamp(max=0xFFFF)

    W = (l_max + 15) // 16 + 2
    nwr = (l_max + 15) // 16 + W + 1
    rc = torch.where(amb, 0, reads).long()
    rc = torch.nn.functional.pad(rc, (0, nwr * 16 - l_max))
    shifts16 = 2 * torch.arange(16, device=dev)
    rwords = (rc.reshape(B, nwr, 16) << shifts16).sum(dim=2)  # (B, nwr) int64
    jhit = torch.arange(H, dtype=i32, device=dev)
    wr = torch.arange(W, device=dev)
    DB = 10

    p = torch.zeros(B, dtype=i32, device=dev)
    n_seeds = torch.zeros(B, dtype=i32, device=dev)
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    # one dump column past max_seeds takes the dropped records
    rs_b, k0_b, freq_b = (
        torch.zeros((B, max_seeds + 1), dtype=i32, device=dev) for _ in range(3)
    )
    r = 0
    counts = dict(rounds=0, lookups=[], hits=[], sub13=[])
    while r < rounds and bool((p < rlens - msl).any()):
        r += 1
        # bulk-skip ambiguous restart positions
        p_idx = p.clamp(max=l_max - 1)
        p = (p + (postab2[bidx, p_idx] >> 16)).clamp(max=l_max)
        p_idx = p.clamp(max=l_max - 1).long()
        active = p < rlens - msl

        pk1 = postab1[bidx, p_idx]
        aoff = postab2[bidx, p_idx] & 0xFFFF
        km = (pk1 & ((1 << 26) - 1)).long()
        valid13 = active & ((pk1 >> 26) == 0)
        lo = torch.where(valid13, tt.table_lo[km], 0)
        hi = torch.where(valid13, tt.table_lo[km + 1], 0)
        cnt = hi - lo
        over = active & (cnt > hit_cap)
        overflow |= over
        cnt = torch.where(over, 0, cnt)

        # compact (lane, hit) pairs into H rows: hit j belongs to the first
        # lane whose inclusive prefix count exceeds j (the rows past the
        # total are masked, so the repeat's padding never shows)
        cum = torch.cumsum(cnt, 0, dtype=i32)
        start = cum - cnt
        fits = cum <= H
        overflow |= active & (cnt > 0) & ~fits
        total = cum[-1]
        hit_lane = torch.searchsorted(cum, jhit, right=True).to(i32)
        lane_c = hit_lane.clamp(max=B - 1).long()

        damb1 = (torch.minimum(aoff, rlens - p).clamp(max=l_max) - 1).clamp(0, (1 << DB) - 1)
        start_h = start.clamp(max=(1 << (29 - DB)) - 1)[lane_c]
        damb_h = damb1[lane_c] + 1
        fits_h = fits[lane_c]
        a_h = (lo - start)[lane_c]

        valid_hit = (jhit < total) & fits_h
        hit_idx = jhit - start_h
        rows = a_h + jhit
        locs = tt.sa_full[torch.where(valid_hit, rows, 0).long()]
        genuine = valid_hit & (locs <= last_valid)
        bogus = valid_hit & (locs > last_valid)
        locs_s = torch.where(genuine, locs, 0)

        tw = tt.text_words[((locs_s >> 4).long()[:, None] + wr[None, :])].long() & _M32
        t_al = _align_words(tw, ((locs_s & 15) * 2).long()[:, None])  # (H, W-1)
        rw = rwords[bidx[:, None], (p_idx >> 4)[:, None] + wr[None, :]]
        r_al = _align_words(rw, ((p_idx & 15) * 2)[:, None])[lane_c]  # (H, W-1)

        xor = t_al ^ r_al
        iszero = (xor == 0).to(i32)
        prefix_zero = torch.cumprod(iszero, dim=1)
        nzw = prefix_zero.sum(dim=1, dtype=i32)
        anym = nzw < W - 1
        pz_shift = torch.cat([torch.ones_like(prefix_zero[:, :1]), prefix_zero[:, :-1]], dim=1)
        first_mask = (pz_shift == 1) & (iszero == 0)
        xw = torch.where(first_mask, xor, 0).sum(dim=1)
        ctz = _popcount32(((xw & -xw) - 1) & _M32).to(i32)
        lcp = torch.where(anym, nzw * 16 + (ctz >> 1), (W - 1) * 16)
        lcp = torch.minimum(lcp, torch.minimum(damb_h, tt.seq_len - locs_s))
        lcp = lcp.clamp(max=l_max)
        lcp = torch.where(genuine, lcp, -1)

        # per-lane reduction: two packed segment maxima over the hits; an
        # empty segment keeps INT32_MIN, as jax.ops.segment_max gives
        seg = torch.where(valid_hit, hit_lane, B).long()
        idx_c = hit_idx.clamp(0, IDXM)
        lc1 = (lcp + 1) << IDXB
        pack_first = torch.where(genuine, lc1 | (IDXM - idx_c), -1)
        pack_last = torch.where(genuine, lc1 | idx_c, torch.where(bogus, 1 << 30, -1))
        init = torch.full((B + 1,), _I32_MIN, dtype=i32, device=dev)
        A1 = init.clone().scatter_reduce_(0, seg, pack_first.to(i32), "amax")[:B]
        A2 = init.scatter_reduce_(0, seg, pack_last.to(i32), "amax")[:B]
        overflow |= A2 >= (1 << 30)
        best = torch.clamp((A1 >> IDXB) - 1, min=-1)
        first_off = IDXM - (A1 & IDXM)
        freq = torch.where(best >= 0, (A2 & IDXM) - first_off + 1, 0)
        has13 = valid13 & (best >= K)
        row0 = lo + torch.where(freq > 0, first_off, 0)

        # sub-13 restart length: the highest k-prefix bit that the first
        # ambiguous base allows
        msk = tt.sub_tbl[km].to(i32) & 0xFFFF
        allow = msk & ((torch.ones_like(aoff) << (aoff.clamp(max=K) + 1)) - 1)
        sub_len = torch.zeros_like(allow)
        for b in range(K + 1):
            sub_len = torch.where(((allow >> b) & 1) == 1, b, sub_len)
        length = torch.where(has13, best, sub_len)
        if stats is not None:
            counts["rounds"] = r
            counts["lookups"].append(int(valid13.sum()))
            counts["hits"].append(int(valid_hit.sum()))
            counts["sub13"].append(int((active & ~has13).sum()))

        record = active & has13 & (length >= msl) & (freq <= OCC_THR) & (freq > 0)
        slot = torch.where(record, n_seeds, max_seeds).clamp(max=max_seeds).long()
        rs_b[bidx, slot] = (p << 15) | length
        k0_b[bidx, slot] = row0
        freq_b[bidx, slot] = freq
        n_seeds = n_seeds + record.to(i32)
        p = torch.where(active, p + length + 1, p)

    # a lane is clean iff it ran to completion without overflow
    p_idx = p.clamp(max=l_max - 1).long()
    p_final = (p + (postab2[bidx, p_idx] >> 16)).clamp(max=l_max)
    unfinished = p_final < rlens - msl
    ok = ~(overflow | unfinished)
    if stats is not None:
        stats.append(counts)
    rs = rs_b[:, :max_seeds]
    return torch.cat(
        [n_seeds[:, None], ok.to(i32)[:, None], rs >> 15, rs & 0x7FFF,
         k0_b[:, :max_seeds], freq_b[:, :max_seeds]],
        dim=1,
    )


def kmer_seed_scan_plain(tt: KmerTablesTensors, reads, rlens, min_seed_len, *, max_seeds,
                         l_max, hit_cap, rounds, slab_rows=SLAB_ROWS, hit_budget=HIT_BUDGET,
                         stats=None):
    """FastMode funnel over (B, l_max) int32 codes (padded 4) and (B,)
    rlens, slab by slab: a batch of at most `slab_rows` is one slab with
    H = hit_budget * B; a larger one is padded with empty reads to whole
    slabs of `slab_rows`, each with H = hit_budget * slab_rows.  l_max is
    at most 512, as in kart_tpu (the packed field widths).  `stats`, a
    list, gets the work counters of every slab (see _slab_plain)."""
    if l_max > 512:
        raise ValueError(f"kmer_seed_scan: FastMode takes l_max <= 512, got {l_max}")
    reads = reads.to(torch.int32)
    rlens = rlens.to(torch.int32)
    msl = int(min_seed_len)
    kw = dict(max_seeds=max_seeds, l_max=l_max, hit_cap=hit_cap, rounds=rounds, stats=stats)
    B = reads.shape[0]
    if B <= slab_rows:
        return _slab_plain(tt, reads, rlens, msl, H=hit_budget * B, **kw)
    pad = -B % slab_rows
    reads = torch.nn.functional.pad(reads, (0, 0, 0, pad), value=4)
    rlens = torch.nn.functional.pad(rlens, (0, pad))
    outs = [
        _slab_plain(tt, reads[s : s + slab_rows], rlens[s : s + slab_rows], msl,
                    H=hit_budget * slab_rows, **kw)
        for s in range(0, B + pad, slab_rows)
    ]
    return torch.cat(outs)[:B]


def kmer_seed_scan(tt: KmerTablesTensors, reads, rlens, min_seed_len, *, max_seeds, l_max,
                   hit_cap, rounds, sensitive=False, slab_rows=SLAB_ROWS,
                   hit_budget=HIT_BUDGET):
    """Packed FastMode funnel seeds, (B, 2 + 4*max_seeds) int32, for
    (B, l_max) codes.  CPU tensors run the plain version; CUDA tensors the
    kernel (which takes the reads 2-bit packed: ops.pack.pack_codes_2bit)."""
    if sensitive:
        raise NotImplementedError(
            "SensitiveMode funnel (PacBio) is not ported yet (ROADMAP Queue 1 item 7)"
        )
    kw = dict(max_seeds=max_seeds, l_max=l_max, hit_cap=hit_cap, rounds=rounds,
              slab_rows=slab_rows, hit_budget=hit_budget)
    if reads.device.type == "cuda":
        from .pack import pack_codes_2bit

        words, amb_r, amb_p = pack_codes_2bit(reads)
        from ..kernels import kmer_funnel

        return kmer_funnel(tt, words, amb_r, amb_p, rlens.to(torch.int32), int(min_seed_len), **kw)
    if reads.device.type != "cpu":
        raise ValueError(f"kmer_seed_scan: unsupported device {reads.device}")
    return kmer_seed_scan_plain(tt, reads, rlens, min_seed_len, **kw)


def unpack_seed_result(packed, max_seeds: int) -> dict:
    """Split the packed (B, 2 + 4*max_seeds) result into fields."""
    return dict(
        n_seeds=packed[:, 0],
        ok=packed[:, 1] != 0,
        rpos=packed[:, 2 : 2 + max_seeds],
        slen=packed[:, 2 + max_seeds : 2 + 2 * max_seeds],
        k0=packed[:, 2 + 2 * max_seeds : 2 + 3 * max_seeds],
        freq=packed[:, 2 + 3 * max_seeds : 2 + 4 * max_seeds],
    )
