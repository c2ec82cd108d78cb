"""FastMode FM-index seeding on PyTorch tensors.

Counterpart of `kart_tpu/ops/fm_search.py` (FMIndexArrays, occ4,
_count4_word, seed_scan).  `seed_scan` returns the same packed
(B, 1 + 4*max_seeds) int32 array as the JAX function.  On CPU tensors it
runs the plain PyTorch version below; on CUDA tensors it launches the
hand-written kernel `csrc/fm_seed_scan.cu` (kernels.fm_seed_scan).

Only the int32 index (seq_len < 2**31) is supported.  BWT words are uint32
bit patterns held in int32 tensors; the plain version widens them to int64
and masks with 0xFFFFFFFF because CPU torch has no uint32 shifts.
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

    occ_cp     (n_blocks*4,) int32  Occ counts at each 128-base checkpoint
    bwt_words  (n_blocks*8,) int32  uint32 BWT words, 16 bases each
    sa_samples (n_sa,)       int32  sampled SA
    L2         (5,)          int32  cumulative char counts
    primary, seq_len         Python ints
    sa_full    (seq_len+1,)  int32  full SA, or None; it stays on the host
                                    (no device code reads it yet)
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
        _require_int32_index(seq_len)

        def put(x, device=device):
            x = np.ascontiguousarray(x).reshape(-1)
            if x.dtype == np.uint32:
                x = x.view(np.int32)
            return torch.tensor(x.astype(np.int32, copy=False), device=device)

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
    def from_genome_index(cls, gidx, device) -> FMIndexTensors:
        """From a loaded kart_tpu GenomeIndex, as FMIndexArrays.
        from_genome_index builds its arrays (the full SA ships with every
        int32 index)."""
        _require_int32_index(gidx.seq_len)
        d = gidx.device_arrays
        return cls.from_numpy(
            dict(
                occ_cp=d["occ_cp"],
                bwt_words=d["bwt_words"],
                sa_samples=d["sa_samples"],
                L2=d["L2"],
                primary=d["primary"],
                seq_len=d["seq_len"],
                sa_full=gidx.sa_full,
            ),
            device,
        )


def _require_int32_index(seq_len: int) -> None:
    if seq_len >= 2**31:
        raise NotImplementedError(
            "int64 FM-index (seq_len >= 2**31) is not ported yet "
            "(ROADMAP Queue 1 item 8, frugal and human-scale slice)"
        )


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


def occ4(fm: FMIndexTensors, k: torch.Tensor) -> torch.Tensor:
    """bwt_occ4 for each row in k (N,) int32, 0 <= k <= seq_len: counts of
    each code in bwt[0..k] -> (N, 4) int32."""
    kk = k - (k >= fm.primary).to(k.dtype)
    blk = (kk >> 7).long()
    dev = k.device
    words = fm.bwt_words[blk[:, None] * 8 + torch.arange(8, device=dev)]
    words = words.long() & _M32  # (N, 8)
    base = fm.occ_cp[blk[:, None] * 4 + torch.arange(4, device=dev)]  # (N, 4)
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


def seed_scan_plain(fm, reads, rlens, min_seed_len, *, max_seeds, l_max):
    """The FastMode scan of kart_tpu's seed_scan_impl, vectorised over the
    batch: l_max+1 uniform steps, one paired occ4 lookup per step.
    reads (B, l_max) int32 codes (>3 ambiguous), rlens (B,) int32."""
    B = reads.shape[0]
    dev = reads.device
    i32 = torch.int32
    # extra trailing ambiguous column: the last extension of every read
    # ends (and emits) inside the fixed-trip loop
    reads = torch.nn.functional.pad(reads.to(i32), (0, 1), value=4)
    rlens = rlens.to(i32)
    L2 = fm.L2
    bidx = torch.arange(B, device=dev)
    zero = torch.zeros(B, dtype=i32, device=dev)
    active = torch.zeros(B, dtype=torch.bool, device=dev)
    start, x0, x1, x2, n_seeds = (zero.clone() for _ in range(5))
    # one dump column past max_seeds takes the dropped records
    fields = torch.zeros((4, B, max_seeds + 1), dtype=i32, device=dev)
    for p in range(l_max + 1):
        c = reads[:, p]
        amb = c > 3
        cs = c.clamp(max=3).long()

        # extension attempt; inactive lanes look up row 0 (results unused)
        ka = torch.where(active, x1 - 1, zero)
        kb = torch.where(active, x1 - 1 + x2, zero)
        tk, tl = occ4(fm, ka), occ4(fm, kb)
        ok_x1 = L2[None, :4] + 1 + tk
        ok_x2 = tl - tk
        s3 = x0 + ((x1 <= fm.primary) & (x1 + x2 - 1 >= fm.primary)).to(i32)
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
        slot = torch.where(record, n_seeds.clamp(max=max_seeds), max_seeds).long()
        fields[:, bidx, slot] = torch.stack([start, length, x0, x2])
        n_seeds = n_seeds + record.to(i32)

        # state transition
        can_start = ~active & ~amb & (p < rlens - min_seed_len)
        cont = active & ~ext_fail
        start = torch.where(can_start, p, start)
        x0 = torch.where(cont, nx0, torch.where(can_start, L2[cs] + 1, x0))
        x1 = torch.where(cont, nx1, torch.where(can_start, L2[3 - cs] + 1, x1))
        x2 = torch.where(cont, nx2, torch.where(can_start, L2[cs + 1] - L2[cs], x2))
        active = cont | can_start
    f = fields[:, :, :max_seeds]
    return torch.cat([n_seeds[:, None], f[0], f[1], f[2], f[3]], dim=1)


def seed_scan(fm: FMIndexTensors, reads, rlens, min_seed_len, *, max_seeds, l_max):
    """Packed FastMode seeds [n_seeds | rpos | slen | k0 | freq] per read,
    (B, 1 + 4*max_seeds) int32.  CPU tensors run the plain version, CUDA
    tensors the kernel."""
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


def unpack_seed_scan(packed, max_seeds: int) -> dict:
    """Split seed_scan's packed (B, 1 + 4*max_seeds) result into fields."""
    return dict(
        n_seeds=packed[:, 0],
        rpos=packed[:, 1 : 1 + max_seeds],
        slen=packed[:, 1 + max_seeds : 1 + 2 * max_seeds],
        k0=packed[:, 1 + 2 * max_seeds : 1 + 3 * max_seeds],
        freq=packed[:, 1 + 3 * max_seeds : 1 + 4 * max_seeds],
    )
