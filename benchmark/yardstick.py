"""The yardstick of the roofline shares: the card's published peaks and the
least work a group's seeding needs, counted from the group's reads and the
rows of the tables and of the suffix array that its searches touch, so that
it is the same work whatever implements it.

A copy, frozen here, of the arithmetic of `kart_tpu_torch/tools/
bench_kernels.py::bound_ms` and of `chip_smoke.py`'s `*_bound`: bytes by
distinct 32-byte sector, the bound the larger of bytes over the HBM rate
and operations over the 32-bit rate.

The funnel (13-mer table lookups, then extension over the text) must read
the reads (2 bits a base), the sector of the 13-mer interval table holding
each search's 13-mer row and the next one, the text (2 bits a base) under
one occurrence of each seed it hands on, and write those seeds (rpos,
length, row, count: 16 bytes).  The resolver must read those seeds, the
suffix-array sectors of their rows, and write the stream: a count a read
and, an occurrence, its meta and its 4-byte text position, at the stream's
width.  Operations: a compare a base matched and one that ends a search;
one an occurrence.  Sectors are counted once however often they are read.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
OPS_PER_S = 67e12  # float32 rate outside the tensor cores, taken for 32-bit integer work too
PEAK_NOTE = "H100 SXM published peaks: 3.35 TB/s HBM, 67 T 32-bit ops/s"
SECTOR = 32
K = 13  # the funnel's table key length


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take for work that must move n_bytes
    and do n_ops operations, in ms, and which of the two sets it."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def distinct_sectors(first_byte: torch.Tensor, end_byte: torch.Tensor) -> int:
    """Distinct 32-byte sectors under the byte ranges [first, end)."""
    keep = end_byte > first_byte
    s0 = first_byte[keep] // SECTOR
    s1 = (end_byte[keep] - 1) // SECTOR
    if s0.numel() == 0:
        return 0
    n = s1 - s0 + 1
    rep = torch.repeat_interleave(torch.arange(s0.numel(), device=s0.device), n)
    start = torch.cumsum(n, 0) - n
    sec = s0[rep] + torch.arange(rep.numel(), device=s0.device) - start[rep]
    return int(torch.unique(sec).numel())


def _kmer_rows(reads: torch.Tensor, read: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The 13-mer at each (read, pos) as a table row (2 bits a base)."""
    j = torch.arange(K, device=reads.device)
    c = reads[read[:, None], pos[:, None] + j[None, :]].long()
    return (c << (2 * (K - 1 - j))[None, :]).sum(1)


def group_work(reads, rlens, searches: dict, sa: torch.Tensor, stream_bits: int) -> dict:
    """Least bytes and operations of one group's funnel and resolver."""
    e = searches["emitted"].bool()
    n_seeds = int(e.sum())
    lo, hi, ln = searches["lo"][e], searches["hi"][e], searches["length"][e]
    n_occ = int((hi - lo).sum())
    looked = searches["qlen"] >= K
    rows = _kmer_rows(reads, searches["read"][looked], searches["pos"][looked])
    table = distinct_sectors(torch.cat([4 * rows, 4 * rows + 4]), torch.cat([4 * rows + 4,
                                                                             4 * rows + 8]))
    g = sa[lo]
    text = distinct_sectors(g // 4, (g + ln + 3) // 4)
    funnel_bytes = (int(rlens.long().sum()) + 3) // 4 + SECTOR * (table + text) + 16 * n_seeds
    funnel_ops = int((searches["length"] + 1).sum())
    w = stream_bits // 8
    sa_sec = distinct_sectors(4 * lo, 4 * hi)
    resolve_bytes = 16 * n_seeds + SECTOR * sa_sec + w * int(rlens.numel()) + (w + 4) * n_occ
    return dict(funnel_bytes=funnel_bytes, funnel_ops=funnel_ops, resolve_bytes=resolve_bytes,
                resolve_ops=n_occ, seeds=n_seeds, occurrences=n_occ,
                searches=int(searches["read"].numel()))
