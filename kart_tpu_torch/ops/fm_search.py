"""FM-index seeding and sampled-SA resolution on PyTorch tensors.

Counterpart of `kart_tpu/ops/fm_search.py` (FMIndexArrays, occ4,
_count4_word, bwt_char, inv_psi, seed_scan, sensitive_scan, sa_walk).
`seed_scan` (FastMode, Illumina) and `sensitive_scan` (SensitiveMode,
PacBio) return the same packed (B, 1 + 4*max_seeds) array as the JAX
functions, in the index dtype; `sa_walk` resolves SA rows to text positions
through the sampled SA.  On CPU tensors they run the plain PyTorch versions
below; on CUDA tensors they launch the hand-written kernels of
`csrc/fm_seed_scan.cu` (kernels.fm_seed_scan, kernels.fm_sensitive_scan)
and `csrc/sa_walk.cu` (kernels.sa_walk).  The FastMode scan is a loop of
`seed_scan_step_plain` over occ4 counts (`seed_scan_loop`), which the
sharded index (parallel/sharded_index.py) drives with its own counts and
its step kernel, the step's twin in `csrc/sharded_fm.cu`.

The index dtype is int32 below 2**31 text bases and int64 at human scale
(GenomeIndex.index_dtype): occ_cp, sa_samples, L2, the interval bounds and
the packed seeds carry it.  BWT words are uint32 bit patterns held in int32
tensors; the plain version widens them to int64 and masks with 0xFFFFFFFF
because CPU torch has no uint32 shifts.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

OCC_THR = 50

_M55 = 0x55555555
_M32 = 0xFFFFFFFF


@dataclass
class FMIndexTensors:
    """Device-resident FM-index, flat like kart_tpu's FMIndexArrays.

    occ_cp     (n_blocks*4,) idt    Occ counts at each 128-base checkpoint
    bwt_words  (n_blocks*8,) int32  uint32 BWT words, 16 bases each
    sa_samples (n_sa,)       idt    sampled SA, every 32nd row
    L2         (5,)          idt    cumulative char counts
    primary, seq_len         Python ints
    sa_full    (seq_len+1,)  idt    full SA, or None; it stays on the host
                                    (the mapper uploads it where it is used)
    idt, the index dtype, is int32 or int64 (`index_dtype`).
    """

    occ_cp: torch.Tensor
    bwt_words: torch.Tensor
    sa_samples: torch.Tensor
    L2: torch.Tensor
    primary: int
    seq_len: int
    sa_full: torch.Tensor | None = None

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> FMIndexTensors:
        """From numpy arrays keyed like FMIndexArrays' fields (for example
        `np.asarray` of each field of a kart_tpu FMIndexArrays)."""
        seq_len = int(arrays["seq_len"])

        def put(x, device=device):
            """int32, uint32 bits as int32, or int64 kept as it is."""
            x = np.ascontiguousarray(x).reshape(-1)
            if x.dtype == np.uint32:
                x = x.view(np.int32)
            elif x.dtype != np.int64:
                x = x.astype(np.int32, copy=False)
            return torch.tensor(x, device=device)

        sa_full = arrays.get("sa_full")
        return cls(
            occ_cp=put(arrays["occ_cp"]),
            bwt_words=put(arrays["bwt_words"]),
            sa_samples=put(arrays["sa_samples"]),
            L2=put(arrays["L2"]),
            primary=int(arrays["primary"]),
            seq_len=seq_len,
            sa_full=None if sa_full is None else put(sa_full, "cpu"),
        )

    @classmethod
    def from_genome_index(cls, gidx, device, with_full_sa=None) -> FMIndexTensors:
        """From a loaded GenomeIndex, as FMIndexArrays.from_genome_index
        builds its arrays, in the index's dtype.  with_full_sa=None (auto)
        carries the full SA only below 2**31 text bases (at human scale it
        is 17+ GB); without it gidx.sa_full is never read, so never built."""
        d = gidx.device_arrays
        if with_full_sa is None:
            with_full_sa = gidx.seq_len < 2**31
        return cls.from_numpy(
            dict(
                occ_cp=d["occ_cp"],
                bwt_words=d["bwt_words"],
                sa_samples=d["sa_samples"],
                L2=d["L2"],
                primary=d["primary"],
                seq_len=d["seq_len"],
                sa_full=gidx.sa_full.astype(gidx.index_dtype, copy=False) if with_full_sa else None,
            ),
            device,
        )

    @property
    def index_dtype(self) -> torch.dtype:
        return self.L2.dtype


# ---------------------------------------------------------------------------
# Plain version (any device; the CPU path and the kernel's reference)
# ---------------------------------------------------------------------------


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2**32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _count4_word(w: torch.Tensor) -> torch.Tensor:
    """Per-code occurrence counts in 32-bit BWT words (16 bases each).
    w: int64 holding uint32 bit patterns, any shape -> shape + (4,) int32."""
    nw = ~w & _M32
    hi_n, hi = (nw >> 1), (w >> 1)
    m = torch.stack(
        [hi_n & nw & _M55, hi_n & w & _M55, hi & nw & _M55, hi & w & _M55], dim=-1
    )
    return _popcount32(m).to(torch.int32)


def occ4_from(words: torch.Tensor, base: torch.Tensor, kk: torch.Tensor) -> torch.Tensor:
    """occ4 of rows kk (N,), the primary shift taken off, from their blocks'
    eight BWT words (N, 8) (int64 holding uint32 bit patterns) and
    checkpoint rows (N, 4) -> (N, 4) in the dtype of the checkpoints."""
    dev = kk.device
    jk = ((kk & 0x7F) >> 4).long()
    counts = _count4_word(words)  # (N, 8, 4)
    before = torch.arange(8, device=dev)[None, :] < jk[:, None]
    full = (counts * before[:, :, None]).sum(dim=1, dtype=torch.int32)
    shift = ((~kk & 0xF) << 1).long()
    mask = ~((1 << shift) - 1) & _M32
    partial = _count4_word(words.gather(1, jk[:, None])[:, 0] & mask)
    cnt = base + full + partial
    cnt[:, 0] -= ~kk & 0xF
    return cnt


def occ4(fm: FMIndexTensors, k: torch.Tensor) -> torch.Tensor:
    """bwt_occ4 for each row in k (N,), 0 <= k <= seq_len: counts of each
    code in bwt[0..k] -> (N, 4) in the dtype of occ_cp and k (int32, or int64
    at human scale)."""
    kk = k - (k >= fm.primary).to(k.dtype)
    blk = (kk >> 7).long()
    dev = k.device
    words = fm.bwt_words[blk[:, None] * 8 + torch.arange(8, device=dev)]
    base = fm.occ_cp[blk[:, None] * 4 + torch.arange(4, device=dev)]  # (N, 4)
    return occ4_from(words.long() & _M32, base, kk)


def seed_scan_state(B: int, max_seeds: int, idt, dev):
    """The FastMode scan before its first step: the state (ist (3, B) int32:
    start, n_seeds, active; tst (3, B) of the index dtype: x0, x1, x2), the
    packed seeds (B, 1 + 4*max_seeds), zeros, and the first step's rows
    (2B,), row 0 for every lane (none is active)."""
    return ((torch.zeros((3, B), dtype=torch.int32, device=dev),
             torch.zeros((3, B), dtype=idt, device=dev)),
            torch.zeros((B, 1 + 4 * max_seeds), dtype=idt, device=dev),
            torch.zeros(2 * B, dtype=idt, device=dev))


def seed_scan_step_plain(p: int, cnt, codes_t, rlens, L2, primary: int, min_seed_len: int,
                         max_seeds: int, state, out):
    """One step of kart_tpu's seed_scan_impl for every lane, at read position
    p, from cnt (2B, 4): occ4 of the lanes' rows ka (the first B) and kb.
    codes_t (l_max, B) int32 codes (>3 ambiguous; position l_max is an
    ambiguous column that ends every extension), rlens (B,) int32, state as
    seed_scan_state's.  A seed that ends at p is written into out (B, 1 +
    4*max_seeds), dropped and counted past max_seeds.  Returns the state
    after the step and the next step's rows (2B,): (x1 - 1, x1 - 1 + x2) of
    the active lanes, row 0 of the others."""
    ist, tst = state
    B = ist.shape[1]
    dev = ist.device
    i32 = torch.int32
    start, n_seeds, active = ist[0], ist[1], ist[2] != 0
    x0, x1, x2 = tst[0], tst[1], tst[2]
    c = codes_t[p] if p < codes_t.shape[0] else torch.full((B,), 4, dtype=i32, device=dev)
    amb = c > 3
    cs = c.clamp(max=3).long()
    bidx = torch.arange(B, device=dev)

    # the extension attempt
    tk, tl = cnt[:B], cnt[B:]
    ok_x1 = L2[None, :4] + 1 + tk
    ok_x2 = tl - tk
    s3 = x0 + ((x1 <= primary) & (x1 + x2 - 1 >= primary)).to(x0.dtype)
    s2 = s3 + ok_x2[:, 3]
    s1 = s2 + ok_x2[:, 2]
    s0 = s1 + ok_x2[:, 1]
    ok_x0 = torch.stack([s0, s1, s2, s3], dim=1)
    i = 3 - cs
    nx0, nx1, nx2 = ok_x0[bidx, i], ok_x1[bidx, i], ok_x2[bidx, i]
    ext_fail = amb | (nx2 == 0)

    # seed emission: an active extension ended at p
    length = p - start
    record = active & ext_fail & (length >= min_seed_len) & (x2 <= OCC_THR)
    keep = torch.nonzero(record & (n_seeds < max_seeds)).flatten()
    col = 1 + n_seeds[keep].long()
    for f, v in enumerate((start, length, x0, x2)):
        out[keep, col + f * max_seeds] = v[keep].to(out.dtype)
    n_seeds = n_seeds + record.to(i32)

    # state transition
    can_start = ~active & ~amb & (p < rlens - min_seed_len)
    cont = active & ~ext_fail
    start = torch.where(can_start, p, start)
    x0 = torch.where(cont, nx0, torch.where(can_start, L2[cs] + 1, x0))
    x1 = torch.where(cont, nx1, torch.where(can_start, L2[3 - cs] + 1, x1))
    x2 = torch.where(cont, nx2, torch.where(can_start, L2[cs + 1] - L2[cs], x2))
    active = cont | can_start
    out[:, 0] = n_seeds.to(out.dtype)
    k_next = torch.cat([torch.where(active, x1 - 1, 0), torch.where(active, x1 - 1 + x2, 0)])
    return (torch.stack([start, n_seeds, active.to(i32)]), torch.stack([x0, x1, x2])), k_next


def seed_scan_loop(occ4_rows, step, L2, primary: int, reads, rlens, min_seed_len: int, *,
                   max_seeds: int, l_max: int):
    """The FastMode scan as l_max + 1 uniform steps (the last over the
    ambiguous column that ends every extension): each step looks up occ4 of
    both interval ends of every lane with occ4_rows((2B,) rows) -> (2B, 4),
    then takes `step` (seed_scan_step_plain's signature)."""
    B = reads.shape[0]
    dev = reads.device
    codes_t = reads[:, :l_max].to(torch.int32).t().contiguous()
    rlens = rlens.to(device=dev, dtype=torch.int32)
    state, out, k = seed_scan_state(B, max_seeds, L2.dtype, dev)
    for p in range(l_max + 1):
        state, k = step(p, occ4_rows(k), codes_t, rlens, L2, primary, int(min_seed_len),
                        max_seeds, state, out)
    return out


def seed_scan_plain(fm, reads, rlens, min_seed_len, *, max_seeds, l_max):
    """The FastMode scan of kart_tpu's seed_scan_impl, vectorised over the
    batch: l_max+1 uniform steps, one occ4 lookup of both interval ends per
    step.  reads (B, l_max) int32 codes (>3 ambiguous), rlens (B,) int32;
    the interval bounds and the packed result are in the index dtype."""
    return seed_scan_loop(lambda k: occ4(fm, k), seed_scan_step_plain, fm.L2, fm.primary, reads,
                          rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max)


def seed_scan(fm: FMIndexTensors, reads, rlens, min_seed_len, *, max_seeds, l_max):
    """Packed FastMode seeds [n_seeds | rpos | slen | k0 | freq] per read,
    (B, 1 + 4*max_seeds) in the index dtype.  CPU tensors run the plain
    version, CUDA tensors the kernel."""
    reads = reads.to(torch.int32)
    if reads.device.type == "cuda":
        from ..kernels import fm_seed_scan

        return fm_seed_scan(
            fm, reads, rlens, int(min_seed_len), max_seeds=max_seeds, l_max=l_max
        )
    if reads.device.type != "cpu":
        raise ValueError(f"seed_scan: unsupported device {reads.device}")
    return seed_scan_plain(
        fm, reads, rlens, int(min_seed_len), max_seeds=max_seeds, l_max=l_max
    )


def sensitive_scan_plain(fm, reads, rlens, min_seed_len, *, max_seeds, l_max, stats=None):
    """The SensitiveMode scan of kart_tpu's sensitive_scan_impl, vectorised
    over the batch: a position per lane, one paired occ4 lookup per trip.
    Extensions stop at a 30-base window (stop = min(start + 30, rlen)); a
    recorded seed restarts the next extension at its end, a failed one
    MinSeed past its start, which can lie behind the scan position.  The
    loop is cut at 31 * (l_max // MinSeed + 2) trips, and seeds past
    max_seeds are dropped without being counted.
    reads (B, width) int32 codes (>3 ambiguous), rlens (B,) int32; l_max
    sets only the trip limit, as in the JAX function.  `stats`, a dict,
    gets the work counters: `trips` (B,) trips each lane ran, `steps` (B,)
    those of them that looked the index up, `starts` (B,) the extensions
    each lane started."""
    B = reads.shape[0]
    dev = reads.device
    i32, idt = torch.int32, fm.index_dtype
    msl = int(min_seed_len)
    reads = torch.nn.functional.pad(reads.to(i32), (0, 1), value=4)
    L = reads.shape[1] - 1
    rlens = rlens.to(i32)
    end_pos = rlens - msl
    L2 = fm.L2
    bidx = torch.arange(B, device=dev)
    zero = torch.zeros(B, dtype=i32, device=dev)
    active = torch.zeros(B, dtype=torch.bool, device=dev)
    p, s, n_seeds = (zero.clone() for _ in range(3))
    x0, x2 = (torch.zeros(B, dtype=idt, device=dev) for _ in range(2))
    x1 = torch.ones(B, dtype=idt, device=dev)
    # one dump column past max_seeds takes the dropped records; every field
    # is held in the index dtype, as the packed result is
    fields = torch.zeros((4, B, max_seeds + 1), dtype=idt, device=dev)
    max_trips = 31 * (l_max // max(msl, 1) + 2)
    trips, steps, starts = zero.clone(), zero.clone(), zero.clone()
    for _ in range(max_trips):
        done = ~active & (p >= end_pos)
        if bool(done.all()):
            break
        c = reads[bidx, p.clamp(max=L).long()]
        amb = c > 3
        cs = c.clamp(max=3).long()
        stop = torch.minimum(s + 30, rlens)

        # extension attempt; the rows of inactive lanes are clamped
        x1s = x1.clamp(min=1)
        tk, tl = occ4(fm, x1s - 1), occ4(fm, x1s - 1 + x2.clamp(min=0))
        ok_x1 = L2[None, :4] + 1 + tk
        ok_x2 = tl - tk
        s3 = x0 + ((x1 <= fm.primary) & (x1 + x2 - 1 >= fm.primary)).to(i32)
        s2 = s3 + ok_x2[:, 3]
        s1 = s2 + ok_x2[:, 2]
        s0 = s1 + ok_x2[:, 1]
        ok_x0 = torch.stack([s0, s1, s2, s3], dim=1)
        i = 3 - cs
        nx0, nx1, nx2 = ok_x0[bidx, i], ok_x1[bidx, i], ok_x2[bidx, i]
        ext_fail = active & (amb | (p >= stop) | (nx2 == 0))
        if stats is not None:
            trips += (~done).to(i32)
            steps += (active & ~amb & (p < stop)).to(i32)

        # seed emission: an extension ended at p
        length = p - s
        freq_ok = (length >= msl) & (x2 <= OCC_THR)
        record = ext_fail & freq_ok & (n_seeds < max_seeds)
        slot = torch.where(record, n_seeds, max_seeds).long()
        fields[:, bidx, slot] = torch.stack([s.to(idt), length.to(idt), x0, x2])
        n_seeds = n_seeds + record.to(i32)

        # next state: a lane idle at p (never started, or just ended with
        # a good seed) may start an extension at p in this same trip
        cont = active & ~ext_fail
        fail_restart = ext_fail & ~freq_ok
        startable = ~done & ~cont & ~fail_restart & ~amb & (p < end_pos)
        if stats is not None:
            starts += startable.to(i32)
        x0 = torch.where(cont, nx0, torch.where(startable, L2[cs] + 1, x0))
        x1 = torch.where(cont, nx1, torch.where(startable, L2[3 - cs] + 1, x1))
        x2 = torch.where(cont, nx2, torch.where(startable, L2[cs + 1] - L2[cs], x2))
        new_p = torch.where(fail_restart, s + msl, torch.where(done, p, p + 1))
        s = torch.where(startable, p, s)
        p = new_p
        active = cont | startable
    if stats is not None:
        stats.update(trips=trips, steps=steps, starts=starts)
    f = fields[:, :, :max_seeds]
    return torch.cat([n_seeds[:, None].to(idt), f[0], f[1], f[2], f[3]], dim=1)


def sensitive_scan(fm: FMIndexTensors, reads, rlens, min_seed_len, *, max_seeds, l_max):
    """Packed SensitiveMode seeds [n_seeds | rpos | slen | k0 | freq] per
    read, (B, 1 + 4*max_seeds) in the index dtype.  CPU tensors run the
    plain version, CUDA tensors the kernel."""
    reads = reads.to(torch.int32)
    kw = dict(max_seeds=max_seeds, l_max=l_max)
    if reads.device.type == "cuda":
        from ..kernels import fm_sensitive_scan

        return fm_sensitive_scan(fm, reads, rlens.to(torch.int32), int(min_seed_len), **kw)
    if reads.device.type != "cpu":
        raise ValueError(f"sensitive_scan: unsupported device {reads.device}")
    return sensitive_scan_plain(fm, reads, rlens, int(min_seed_len), **kw)


# ---------------------------------------------------------------------------
# Sampled-SA resolution
# ---------------------------------------------------------------------------

SA_INTV_LOG2 = 5  # the sampled SA keeps every 32nd row (bwt.c:101-123)
SA_WALK_MAX_STEPS = 4096


def bwt_char(fm: FMIndexTensors, x: torch.Tensor) -> torch.Tensor:
    """bwt_B0: the 2-bit code at primary-adjusted rows x (N,) -> (N,) int64."""
    w = fm.bwt_words[((x >> 7) * 8 + ((x & 0x7F) >> 4)).long()].long() & _M32
    return (w >> ((~x & 0xF) << 1).long()) & 3


def inv_psi(fm: FMIndexTensors, k: torch.Tensor) -> torch.Tensor:
    """bwt_invPsi for each row in k (N,): the row of the previous text
    position; the row `primary` maps to row 0."""
    x = k - (k > fm.primary).to(k.dtype)
    c = bwt_char(fm, x)
    nk = fm.L2[c] + occ4(fm, k).gather(1, c[:, None])[:, 0]
    return torch.where(k == fm.primary, 0, nk).to(k.dtype)


def sa_walk_plain(fm: FMIndexTensors, rows: torch.Tensor, *, max_steps: int = SA_WALK_MAX_STEPS,
                  stats: dict | None = None):
    """kart_tpu's sa_walk, vectorised: each row takes inverse-Psi steps until
    it reaches a sampled row (row % 32 == 0) or has taken max_steps steps.
    Returns (pos, done): pos = steps + sa_samples[row >> 5] for every row,
    also where the walk was cut, and done marks the rows that reached a
    sample.  rows (N,) int32 or int64; pos is in the wider of the rows' and
    the index's dtype.  `stats`, a dict, gets `steps` (N,), the steps each
    row took."""
    wt = torch.promote_types(rows.dtype, fm.index_dtype)
    mask = (1 << SA_INTV_LOG2) - 1
    k = rows.to(wt, copy=True)
    add = torch.zeros_like(k)
    for _ in range(max_steps):
        walking = (k & mask) != 0
        if not bool(walking.any()):
            break
        idx = torch.nonzero(walking).flatten()
        k[idx] = inv_psi(fm, k[idx])
        add[idx] += 1
    done = (k & mask) == 0
    if stats is not None:
        stats["steps"] = add.clone()
    return add + fm.sa_samples[(k >> SA_INTV_LOG2).long()].to(wt), done


def sa_walk(fm: FMIndexTensors, rows: torch.Tensor, *, max_steps: int = SA_WALK_MAX_STEPS):
    """(pos, done) of sa_walk_plain.  CPU tensors run the plain version, CUDA
    tensors the kernel."""
    if rows.device.type == "cuda":
        from ..kernels import sa_walk as kernel

        return kernel(fm, rows, max_steps=max_steps)
    if rows.device.type != "cpu":
        raise ValueError(f"sa_walk: unsupported device {rows.device}")
    return sa_walk_plain(fm, rows, max_steps=max_steps)


def unpack_seed_scan(packed, max_seeds: int) -> dict:
    """Split seed_scan's packed (B, 1 + 4*max_seeds) result into fields."""
    return dict(
        n_seeds=packed[:, 0],
        rpos=packed[:, 1 : 1 + max_seeds],
        slen=packed[:, 1 + max_seeds : 1 + 2 * max_seeds],
        k0=packed[:, 1 + 2 * max_seeds : 1 + 3 * max_seeds],
        freq=packed[:, 1 + 3 * max_seeds : 1 + 4 * max_seeds],
    )
