"""The block-sharded FM index behind -idx-shards.

Counterpart of kart_tpu/parallel/sharded_index.py.  For genomes whose
Occ/BWT/SA arrays exceed one card's memory, the index is split block-wise
into N slabs, each a set of tensors on its own device.  Exactly one shard
owns each query: block b belongs to shard b // nb_local.  kart_tpu asks
every member of its `idx` mesh axis about every query and sums the masked
answers with a psum; here a lookup picks each query's owner.  The shards may
share a device (default_shard_devices puts contiguous runs of shards on each
card where there are more shards than cards, all N on a one-card machine;
-cpu puts all N on the CPU), and ShardedFM groups them by device
(`shard_groups`).

Each device's shards are read through a shard table (`shard_table`): a row a
shard of the index, the pointers of its slabs where it lies on that device,
nulls elsewhere; made once per ShardedFM and device, a small int64 tensor
there, which each kernel copies into shared memory, and looked up once a
scan or walk.

Where one device holds every shard (the resident path):
  sharded_seed_scan   the whole FastMode scan in one launch, fm_seed_scan.cu's
                      loop through the table (kernels.sharded_seed_scan)
  sharded_sa_walk     the whole sampled-SA walk in one launch, sa_walk.cu's
                      loop through the table, the sample at a walk's end from
                      its owner's slab (kernels.sharded_sa_walk)
  the full-SA resolve resolve_pack.cu's passes reading each position from
                      its owner's full-SA slab through the table
                      (kernels.resolve_stream_table): no gather of its own
Where the shards span several devices, the host steps (the cross-device
path), one launch a device a step, the devices' results gathered on the
first shard's device (in one process, not a torch.distributed collective):
  G1 sharded_occ4     occ4 of (2B,) rows: both interval ends of a scan step,
                      on every device but the stepping one (the first
                      shard's), into a part there
  G2 fused step       on the stepping device, one launch: its own shards'
                      occ4 of the rows, plus the parts, then one FastMode
                      step of every lane (ops/fm_search.py::
                      seed_scan_step_plain); N launches a step for N devices
  G3 sharded_inv_psi  one step of the sampled-SA walk, summed
  G4 table_gather     the full or the sampled SA at rows, one launch a device
                      through its table (the samples at a cross-device walk's
                      end, the full-SA lookup of a cross-device resolve and
                      sharded_sa_gather), summed

Each kernel has its plain version here (CPU tensors): table_occ4_plain,
fused_step_plain, table_inv_psi_plain, table_gather_plain (shard_gather_plain
a shard, summed), and resident_seed_scan_plain, resident_sa_walk_plain and
resident_sa_gather_plain, the cross-device loops and the gather over them
with every shard in one group.  Occurrences are expanded and resolved by
ops/resolve.py's plain version, or on the card by csrc/resolve_pack.cu's
passes: through the table where one device holds every shard's full SA,
else around the sharded lookup (kernels.resolve_stream).  Nothing falls
back to another path, to the replicated index or to the CPU: a kernel
that fails to build or launch, a
shard on an unsupported device and a resident call on shards that are not
all on its device raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from ..ops.fm_search import (
    SA_INTV_LOG2,
    SA_WALK_MAX_STEPS,
    _M32,
    occ4_from,
    seed_scan_state,
    seed_scan_step_plain,
    unpack_seed_scan,
)
from ..ops.resolve import expand_resolve_plain

WALK_CHECK_EVERY = 8  # walk steps between two looks at whether every row is at a sample


@dataclass
class FMShard:
    """One shard's slab, on its device: blocks [index*nb_local, (index+1)*
    nb_local) of occ_cp (four counts a block) and bwt_words (eight uint32
    words a block, held as int32), rows [index*ns_local, ...) of the full SA
    (None in the sampled SA mode) and [index*nsamp_local, ...) of the
    sampled SA, and a copy of L2."""

    index: int
    occ_cp: torch.Tensor
    bwt_words: torch.Tensor
    sa_full: torch.Tensor | None
    sa_samples: torch.Tensor
    L2: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.occ_cp.device


@dataclass
class ShardedFM:
    """The FM index split into len(shards) slabs; the last ones are padded
    with zeros past the index, which own no query.  nb_local blocks,
    ns_local full-SA rows and nsamp_local sampled-SA rows a shard."""

    shards: list[FMShard]
    primary: int
    seq_len: int
    nb_local: int
    ns_local: int
    nsamp_local: int
    # the shard tables, by device and slab pointers (`shard_table`)
    tables: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        """The first shard's device, where the shards' results are summed."""
        return self.shards[0].device

    @property
    def L2(self) -> torch.Tensor:
        return self.shards[0].L2

    @property
    def index_dtype(self) -> torch.dtype:
        return self.L2.dtype

    @property
    def has_full_sa(self) -> bool:
        return self.shards[0].sa_full is not None


def shard_groups(sfm: ShardedFM) -> list[list[FMShard]]:
    """The shards grouped by device, in the order each device first holds a
    shard (so the first group holds shard 0, on sfm.device)."""
    groups: dict = {}
    for s in sfm.shards:
        groups.setdefault(s.device, []).append(s)
    return list(groups.values())


def index_int64(gidx) -> SimpleNamespace:
    """gidx as build_sharded_fm reads it, its arrays widened to int64 (the
    BWT words as they are): how an index below 2**31 text bases runs the
    int64 instances of the kernels."""
    d = gidx.device_arrays
    wide = {k: np.asarray(d[k]).astype(np.int64) for k in ("occ_cp", "sa_samples", "L2",
                                                           "primary", "seq_len")}
    return SimpleNamespace(device_arrays=dict(wide, bwt_words=np.asarray(d["bwt_words"])),
                           sa_full=gidx.sa_full.astype(np.int64), index_dtype=np.int64)


def _slab(a: np.ndarray, s: int, n_local: int, device) -> torch.Tensor:
    """Rows [s*n_local, (s+1)*n_local) of a, padded with zeros past its end,
    as a tensor on device (uint32 bits as int32)."""
    part = a[s * n_local:(s + 1) * n_local]
    if len(part) < n_local:
        part = np.concatenate([part, np.zeros((n_local - len(part),) + a.shape[1:], a.dtype)])
    part = np.ascontiguousarray(part).reshape(-1)
    if part.dtype == np.uint32:
        part = part.view(np.int32)
    return torch.from_numpy(part).to(device)


def build_sharded_fm(gidx, devices, sa_mode: str = "full") -> ShardedFM:
    """Split the index into len(devices) slabs, shard s on devices[s].
    gidx: a GenomeIndex (its device_arrays, in the index dtype).  In the
    sampled SA mode gidx.sa_full is never read, so never built."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n < 1:
        raise ValueError("build_sharded_fm: no shard devices")
    d = gidx.device_arrays
    occ_cp = np.asarray(d["occ_cp"]).reshape(-1, 4)
    bwt_words = np.asarray(d["bwt_words"]).reshape(-1, 8)
    nb = occ_cp.shape[0]
    nb_local = -(-nb // n)
    if sa_mode == "full":
        sa_full = np.asarray(gidx.sa_full.astype(gidx.index_dtype, copy=False))
        ns_local = -(-sa_full.shape[0] // n)
    elif sa_mode == "sampled":
        sa_full, ns_local = None, 0
    else:
        raise ValueError(f"build_sharded_fm: sa_mode {sa_mode!r}, expected full or sampled")
    sa_samples = np.asarray(d["sa_samples"])
    nsamp_local = -(-sa_samples.shape[0] // n)
    L2 = np.asarray(d["L2"])
    shards = [
        FMShard(
            index=s,
            occ_cp=_slab(occ_cp, s, nb_local, dev),
            bwt_words=_slab(bwt_words, s, nb_local, dev),
            sa_full=None if sa_full is None else _slab(sa_full, s, ns_local, dev),
            sa_samples=_slab(sa_samples, s, nsamp_local, dev),
            L2=torch.from_numpy(np.ascontiguousarray(L2)).to(dev),
        )
        for s, dev in enumerate(devices)
    ]
    return ShardedFM(shards=shards, primary=int(d["primary"]), seq_len=int(d["seq_len"]),
                     nb_local=nb_local, ns_local=ns_local, nsamp_local=nsamp_local)


def default_shard_devices(n_shards: int, device) -> list[torch.device]:
    """The shards' devices on a CUDA device: one shard a card, cuda:0 ..
    cuda:N-1, where there are as many cards as shards; with more shards than
    cards, contiguous runs of shards on each card (shard s on card s * C //
    N of C), where kart_tpu refuses more shards than devices.  All N on the
    CPU otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_shards
    have = torch.cuda.device_count()
    if have < 1:
        raise RuntimeError(f"idx_shards={n_shards} but no CUDA devices")
    return [torch.device("cuda", s * min(have, n_shards) // n_shards) for s in range(n_shards)]


# ---------------------------------------------------------------------------
# The owner-select lookups: plain versions (CPU tensors) and their dispatch
# ---------------------------------------------------------------------------


def _owner(sfm: ShardedFM, k: torch.Tensor):
    """(kk, the owner shard, the block's place in the owner's slab) of rows
    k."""
    kk = k - (k >= sfm.primary).to(k.dtype)
    blk = kk >> 7
    own = blk // sfm.nb_local
    return kk, own, blk - own * sfm.nb_local


def _block(shard: FMShard, rc: torch.Tensor):
    dev = rc.device
    words = shard.bwt_words[rc[:, None] * 8 + torch.arange(8, device=dev)].long() & _M32
    base = shard.occ_cp[rc[:, None] * 4 + torch.arange(4, device=dev)]
    return words, base


def _rows_of(shard: FMShard, own: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(own == shard.index).flatten()


def table_occ4_plain(sfm: ShardedFM, shards: list[FMShard], k: torch.Tensor) -> torch.Tensor:
    """G1's plain version: occ4 (n, 4) of the rows k (n,), each from its
    owner's block where the owner is one of `shards`, zeros elsewhere."""
    kk, own, local = _owner(sfm, k)
    out = torch.zeros((k.shape[0], 4), dtype=sfm.index_dtype, device=k.device)
    for s in shards:
        idx = _rows_of(s, own)
        words, base = _block(s, local[idx].long())
        out[idx] = occ4_from(words, base, kk[idx])
    return out


def _inv_psi_rows(sfm: ShardedFM, shard: FMShard, k, kk, local):
    """bwt_invPsi of rows k (n,) whose blocks (kk's, at `local` of the
    shard's slab) the shard owns; row `primary` maps to 0."""
    words, base = _block(shard, local.long())
    cnt = occ4_from(words, base, kk)
    # x == kk for every k != primary, so x's word is in the block
    x = k - (k > sfm.primary).to(k.dtype)
    w = words.gather(1, ((x & 0x7F) >> 4).long()[:, None])[:, 0]
    c = (w >> ((~x & 0xF) << 1).long()) & 3
    nk = shard.L2[c] + cnt.gather(1, c[:, None])[:, 0]
    return torch.where(k == sfm.primary, 0, nk).to(k.dtype)


def fused_step_plain(sfm: ShardedFM, shards: list[FMShard], k: torch.Tensor, parts, p: int,
                     codes_t, rlens, min_seed_len: int, max_seeds: int, state, out):
    """The fused step's plain version: occ4 of the rows k (2B,) from
    `shards` (table_occ4_plain), plus the other groups' parts ((2B, 4) each,
    on k's device), then seed_scan_step_plain on the sums.  Returns its
    (state, next rows)."""
    cnt = table_occ4_plain(sfm, shards, k)
    for part in parts:
        cnt = cnt + part
    return seed_scan_step_plain(p, cnt, codes_t, rlens, sfm.L2, sfm.primary, min_seed_len,
                                max_seeds, state, out)


def table_inv_psi_plain(sfm: ShardedFM, shards: list[FMShard], k: torch.Tensor, add=None):
    """G3's plain version: one walk step of the rows k (n,) whose owner is
    one of `shards` (a row at a sample stays, others take bwt_invPsi), zeros
    for the other rows.  add (n,) int32, where given, gets one more step for
    every row not at a sample."""
    at_sample = (k & ((1 << SA_INTV_LOG2) - 1)) == 0
    if add is not None:
        add += (~at_sample).to(add.dtype)
    kk, own, local = _owner(sfm, k)
    out = torch.zeros_like(k)
    for s in shards:
        idx = _rows_of(s, own)
        ki = k[idx]
        out[idx] = torch.where(at_sample[idx], ki, _inv_psi_rows(sfm, s, ki, kk[idx], local[idx]))
    return out


def shard_gather_plain(slab: torch.Tensor, lo: int, rows: torch.Tensor, shift: int = 0):
    """One shard's part of G4's plain version: slab[(rows >> shift) - lo]
    where the slab holds the row, else 0."""
    r = (rows >> shift) - lo
    mine = (r >= 0) & (r < slab.shape[0])
    return torch.where(mine, slab[r.clamp(0, slab.shape[0] - 1).long()], 0)


def _gather_slabs(sfm: ShardedFM, shards: list[FMShard], shift: int):
    """(slab, first row) of each of `shards` for the full SA (shift 0) or
    the sampled SA (shift 5)."""
    if shift == 0:
        return [(s.sa_full, s.index * sfm.ns_local) for s in shards]
    return [(s.sa_samples, s.index * sfm.nsamp_local) for s in shards]


def table_gather_plain(sfm: ShardedFM, shards: list[FMShard], rows: torch.Tensor,
                       shift: int = 0):
    """G4's plain version: the full SA at rows (shift 0) or the sampled SA
    at rows >> 5 (shift 5) where the row's owner is one of `shards`, else 0:
    shard_gather_plain of each, summed."""
    return combine([shard_gather_plain(slab, lo, rows, shift)
                    for slab, lo in _gather_slabs(sfm, shards, shift)], rows.device)


def resident_sa_gather_plain(sfm: ShardedFM, rows: torch.Tensor):
    """The plain version of the full-SA lookup that the resident resolve
    makes through the table: sa_full[rows], every shard in one group."""
    return table_gather_plain(sfm, sfm.shards, rows, 0)


def resident_seed_scan_plain(sfm: ShardedFM, reads, rlens, min_seed_len, *, max_seeds: int,
                             l_max: int):
    """The resident scan's plain version: the cross-device loop's plain
    version with every shard in one group."""
    return _stepwise_seed_scan(sfm, reads, rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max,
                               groups=[sfm.shards], plain=True)


def resident_sa_walk_plain(sfm: ShardedFM, rows: torch.Tensor, *,
                           max_steps: int = SA_WALK_MAX_STEPS):
    """The resident walk's plain version, with fm_search.sa_walk_plain's
    contract (pos, done) in the index dtype: the cross-device walk's plain
    version with every shard in one group."""
    return _stepwise_sa_walk(sfm, rows, max_steps=max_steps, groups=[sfm.shards], plain=True)


def _on(dev: torch.device) -> str:
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"sharded index: unsupported device {dev}")
    return dev.type


def shard_table(sfm: ShardedFM, shards: list[FMShard]) -> torch.Tensor:
    """The shard table of `shards`, which lie on one device: (N, 4) int64
    there, row s the data pointers of shard s's occ_cp, bwt_words,
    sa_samples and sa_full slabs (sa_full 0 in the sampled SA mode) where
    shard s is one of `shards`, zeros elsewhere.  Made once per ShardedFM,
    device and set of slabs; its `every_shard` says whether it holds every
    shard of the index, which the resident kernels ask of the table they
    read, and `has_full_sa` whether its rows hold the full SA's slabs."""
    dev = shards[0].device
    for s in shards:
        if s.device != dev:
            raise ValueError(f"shard table: shard {s.index} on {s.device}, the table's on {dev}")
    ptrs = {s.index: (s.occ_cp.data_ptr(), s.bwt_words.data_ptr(), s.sa_samples.data_ptr(),
                      0 if s.sa_full is None else s.sa_full.data_ptr())
            for s in shards}
    key = (dev, tuple(sorted(ptrs.items())))
    if key not in sfm.tables:
        rows = [ptrs.get(i, (0, 0, 0, 0)) for i in range(len(sfm.shards))]
        table = torch.tensor(rows, dtype=torch.int64).to(dev)
        table.every_shard = len(ptrs) == len(sfm.shards)
        table.has_full_sa = all(s.sa_full is not None for s in shards)
        sfm.tables[key] = table
    return sfm.tables[key]


def _group_tables(sfm: ShardedFM, groups, plain: bool = False) -> list:
    """(group, its shard table) for each group of shards, made once for a
    whole loop; None for the table where the plain version answers for the
    group (CPU tensors, or `plain`)."""
    return [(g, None if plain or _on(g[0].device) == "cpu" else shard_table(sfm, g))
            for g in groups]


def _occ4_of(sfm: ShardedFM, shards: list[FMShard], table, k: torch.Tensor, out=None):
    """G1 on the device of `shards`: the kernel through `table`, or the
    plain version where table is None; into `out` where given (the kernel
    writes it directly where it lies on that device)."""
    k = k.to(shards[0].device)
    if table is None:
        got = table_occ4_plain(sfm, shards, k)
    else:
        from .. import kernels

        here = out is not None and out.device == k.device
        got = kernels.sharded_occ4(table, sfm.nb_local, shards[0].L2, sfm.primary, sfm.seq_len, k,
                                   out=out if here else None)
    return got if out is None or got is out else out.copy_(got)


def _inv_psi_of(sfm: ShardedFM, shards: list[FMShard], table, k: torch.Tensor, add=None):
    """G3 on the device of `shards` (add there too, or None), as _occ4_of."""
    k = k.to(shards[0].device)
    if table is None:
        return table_inv_psi_plain(sfm, shards, k, add)
    from .. import kernels

    return kernels.sharded_inv_psi(table, sfm.nb_local, shards[0].L2, sfm.primary, sfm.seq_len,
                                   k, add)


def table_occ4(sfm: ShardedFM, shards: list[FMShard], k: torch.Tensor) -> torch.Tensor:
    """G1 on the device of `shards`: the kernel through their table on a CUDA
    device, else the plain version."""
    (_, table), = _group_tables(sfm, [shards])
    return _occ4_of(sfm, shards, table, k)


def table_inv_psi(sfm: ShardedFM, shards: list[FMShard], k: torch.Tensor, add=None):
    """G3 on the device of `shards` (add there too, or None)."""
    (_, table), = _group_tables(sfm, [shards])
    return _inv_psi_of(sfm, shards, table, k, add)


def _gather_of(sfm: ShardedFM, shards: list[FMShard], table, rows: torch.Tensor, shift: int):
    """G4 on the device of `shards`, as _occ4_of: the kernel through `table`
    (one launch for the group), or the plain version where table is None;
    rows in the index dtype."""
    rows = rows.to(device=shards[0].device, dtype=sfm.index_dtype)
    if table is None:
        return table_gather_plain(sfm, shards, rows, shift)
    from .. import kernels

    return kernels.sharded_gather(table, sfm.ns_local if shift == 0 else sfm.nsamp_local, rows,
                                  shift)


def table_gather(sfm: ShardedFM, shards: list[FMShard], rows: torch.Tensor, shift: int = 0):
    """G4 on the device of `shards`: the full SA at rows (shift 0) or the
    sampled SA at rows >> 5 (shift 5) where the row's owner is one of
    `shards`, else 0; the kernel through their table on a CUDA device, else
    the plain version.  Where one device holds every shard, `combine` of
    its one part is that part: no sum, no copy."""
    (_, table), = _group_tables(sfm, [shards])
    return _gather_of(sfm, shards, table, rows, shift)


def combine(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of the devices' results on `device` (the first shard's, where
    parts[0] already lies): one owner a query, so the sum is its answer."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part.to(device)
    return acc


def _resident_table(sfm: ShardedFM):
    """The shard table of every shard on sfm.device for a resident call
    there, or None on the CPU (the plain version); raises where a shard lies
    on another device."""
    dev = sfm.device
    away = [s.index for s in sfm.shards if s.device != dev]
    if away:
        raise ValueError(f"sharded index: a resident call on {dev}, but shards {away} lie"
                         f" elsewhere")
    (_, table), = _group_tables(sfm, [sfm.shards])
    return table


def resident_seed_scan(sfm: ShardedFM, reads, rlens, min_seed_len, *, max_seeds: int, l_max: int):
    """The resident scan, every shard on sfm.device: one launch on a CUDA
    device, else the plain version."""
    dev = sfm.device
    table = _resident_table(sfm)
    reads, rlens = reads.to(dev), rlens.to(dev)
    if table is None:
        return resident_seed_scan_plain(sfm, reads, rlens, min_seed_len, max_seeds=max_seeds,
                                        l_max=l_max)
    from .. import kernels

    return kernels.sharded_seed_scan(
        table, sfm.nb_local, sfm.L2, sfm.primary, sfm.seq_len,
        reads.to(torch.int32).contiguous(), rlens.to(torch.int32).contiguous(),
        int(min_seed_len), max_seeds=max_seeds, l_max=l_max)


def resident_sa_walk(sfm: ShardedFM, rows: torch.Tensor, *, max_steps: int = SA_WALK_MAX_STEPS):
    """The resident walk, every shard on sfm.device: one launch on a CUDA
    device, else the plain version."""
    dev = sfm.device
    table = _resident_table(sfm)
    if table is None:
        return resident_sa_walk_plain(sfm, rows.to(dev), max_steps=max_steps)
    from .. import kernels

    k = rows.to(device=dev, dtype=sfm.index_dtype).contiguous()
    return kernels.sharded_sa_walk(table, sfm.nb_local, sfm.nsamp_local, sfm.L2, sfm.primary,
                                   sfm.seq_len, k, max_steps=max_steps)


# ---------------------------------------------------------------------------
# The sharded lookups, the scan and the walk, kart_tpu's names
# ---------------------------------------------------------------------------


def _occ4_sum(sfm: ShardedFM, tables, k: torch.Tensor) -> torch.Tensor:
    return combine([_occ4_of(sfm, g, t, k) for g, t in tables], sfm.device)


def _inv_psi_sum(sfm: ShardedFM, tables, k: torch.Tensor, add=None) -> torch.Tensor:
    return combine([_inv_psi_of(sfm, g, t, k, add if i == 0 else None)
                    for i, (g, t) in enumerate(tables)], sfm.device)


def sharded_occ4_batch(sfm: ShardedFM, k: torch.Tensor, groups=None) -> torch.Tensor:
    """occ4 (B, 4) of the rows k (B,) against the sharded index, on
    sfm.device: one G1 a group of shards (by default a device's), summed."""
    return _occ4_sum(sfm, _group_tables(sfm, shard_groups(sfm) if groups is None else groups), k)


def sharded_occ4_pair(sfm: ShardedFM, ka: torch.Tensor, kb: torch.Tensor):
    """Both occ4 lookups of a scan step as one (2B,) lookup."""
    cnt = sharded_occ4_batch(sfm, torch.cat([ka, kb]))
    return cnt[: ka.shape[0]], cnt[ka.shape[0]:]


def _gather_sum(sfm: ShardedFM, tables, rows: torch.Tensor, shift: int) -> torch.Tensor:
    return combine([_gather_of(sfm, g, t, rows, shift) for g, t in tables], sfm.device)


def sharded_sa_gather(sfm: ShardedFM, rows: torch.Tensor, groups=None) -> torch.Tensor:
    """sa_full[rows] with the full SA split over the shards, on sfm.device:
    one G4 a group of shards (by default a device's), summed; one launch
    and no sum where one device holds every shard."""
    if not sfm.has_full_sa:
        raise ValueError("sharded_sa_gather: the index was split without its full SA")
    tables = _group_tables(sfm, shard_groups(sfm) if groups is None else groups)
    return _gather_sum(sfm, tables, rows, 0)


def sharded_inv_psi_batch(sfm: ShardedFM, k: torch.Tensor, add=None, groups=None) -> torch.Tensor:
    """One step of the sampled-SA walk of the rows k (N,): bwt_invPsi, as
    kart_tpu's sharded_inv_psi_batch, for the rows not at a sample; a row at
    a sample stays.  One G3 a group of shards (by default a device's),
    summed; add (N,) int32 on sfm.device, where given, gets one more step
    for every row not at a sample (counted by the first group's)."""
    tables = _group_tables(sfm, shard_groups(sfm) if groups is None else groups)
    return _inv_psi_sum(sfm, tables, k, add)


def _stepwise_sa_walk(sfm: ShardedFM, rows: torch.Tensor, *, max_steps: int, groups,
                      plain: bool = False):
    """The cross-device walk: the host steps every group of shards (G3 a
    group a step, summed on sfm.device), looks at the rows every
    WALK_CHECK_EVERY steps (a row at a sample keeps its row), stops after
    max_steps steps exactly, and gathers each row's sample (G4 a group,
    summed).  `plain`: the plain versions on whatever device the shards
    lie."""
    dev = sfm.device
    tables = _group_tables(sfm, groups, plain)
    k = rows.to(device=dev, dtype=sfm.index_dtype)
    add = torch.zeros(k.shape[0], dtype=torch.int32, device=dev)
    mask = (1 << SA_INTV_LOG2) - 1
    for it in range(max_steps):
        if it % WALK_CHECK_EVERY == 0 and not bool(((k & mask) != 0).any()):
            break
        k = _inv_psi_sum(sfm, tables, k, add)
    samp = _gather_sum(sfm, tables, k, SA_INTV_LOG2)
    return add.to(k.dtype) + samp, (k & mask) == 0


def sharded_sa_walk(sfm: ShardedFM, rows: torch.Tensor, *, max_steps: int = SA_WALK_MAX_STEPS):
    """Sampled-SA resolution of the rows (N,) over the sharded index, with
    fm_search.sa_walk's contract (pos, done), on sfm.device: the resident
    walk where one device holds every shard, else the cross-device walk."""
    groups = shard_groups(sfm)
    if len(groups) == 1:
        return resident_sa_walk(sfm, rows, max_steps=max_steps)
    return _stepwise_sa_walk(sfm, rows, max_steps=max_steps, groups=groups)


def _stepping_group(sfm: ShardedFM, tables):
    """((group, table) that steps the scan: the first on sfm.device, the
    others' (group, table) pairs)."""
    for i, (g, t) in enumerate(tables):
        if g[0].device == sfm.device:
            return tables[i], tables[:i] + tables[i + 1:]
    raise ValueError(f"sharded scan: no group of shards on {sfm.device}, where the scan steps")


def _stepwise_seed_scan(sfm: ShardedFM, reads, rlens, min_seed_len, *, max_seeds: int, l_max: int,
                        groups, plain: bool = False):
    """The cross-device scan, stepped on sfm.device: each of the l_max + 1
    steps is one G1 lookup on every other group of both interval ends of
    every lane, into a part there, and the fused step (the stepping group's
    own lookup, the parts' sum, the step).  The parts and two sets of state
    and rows are made once for the whole scan; the step writes one set from
    the other.  `plain`: the plain versions on whatever device the shards
    lie."""
    dev = sfm.device
    (own, table), others = _stepping_group(sfm, _group_tables(sfm, groups, plain))
    B = reads.shape[0]
    codes_t = reads.to(dev)[:, :l_max].to(torch.int32).t().contiguous()
    rlens = rlens.to(device=dev, dtype=torch.int32)
    msl = int(min_seed_len)
    state, out, k = seed_scan_state(B, max_seeds, sfm.index_dtype, dev)
    parts = [torch.empty((2 * B, 4), dtype=sfm.index_dtype, device=dev) for _ in others]
    if table is None:
        for p in range(l_max + 1):
            for part, (g, t) in zip(parts, others):
                _occ4_of(sfm, g, t, k, out=part)
            state, k = fused_step_plain(sfm, own, k, parts, p, codes_t, rlens, msl, max_seeds,
                                        state, out)
        return out
    from .. import kernels

    ptrs = kernels.part_pointers(parts)
    nxt = (tuple(torch.empty_like(x) for x in state), torch.empty_like(k))
    for p in range(l_max + 1):
        for part, (g, t) in zip(parts, others):
            _occ4_of(sfm, g, t, k, out=part)
        kernels.sharded_fused_step(table, sfm.nb_local, sfm.L2, sfm.primary, sfm.seq_len, k,
                                   parts, ptrs, p, codes_t, rlens, msl, max_seeds, state, nxt[0],
                                   out, nxt[1])
        (state, k), nxt = nxt, (state, k)
    return out


def sharded_seed_scan(sfm: ShardedFM, reads, rlens, min_seed_len, *, max_seeds: int, l_max: int):
    """FastMode seeding against the sharded index: the same packed (B, 1 +
    4*max_seeds) array as ops/fm_search.seed_scan on the replicated index,
    on sfm.device: the resident scan where one device holds every shard,
    else the cross-device scan."""
    groups = shard_groups(sfm)
    if len(groups) == 1:
        return resident_seed_scan(sfm, reads, rlens, min_seed_len, max_seeds=max_seeds,
                                  l_max=l_max)
    return _stepwise_seed_scan(sfm, reads, rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max,
                               groups=groups)


def sharded_lookup(sfm: ShardedFM, max_steps: int = SA_WALK_MAX_STEPS):
    """rows -> (text positions, resolved): the sharded full-SA gather, or in
    the sampled SA mode the sharded walk."""
    if sfm.has_full_sa:
        return lambda rows: (sharded_sa_gather(sfm, rows), torch.ones_like(rows, dtype=torch.bool))
    return lambda rows: sharded_sa_walk(sfm, rows, max_steps=max_steps)


def sharded_seed_scan_resolved(sfm: ShardedFM, reads, rlens, min_seed_len, *, max_seeds: int,
                               l_max: int, occ_budget: int):
    """Sharded seeding, then occurrence expansion and SA resolution through
    the sharded index (the full-SA gather, or the walk in the sampled SA
    mode, where no shard and not the host holds the full SA): the resolved
    stream (cnts, meta, gpos) of ops/resolve.py, on sfm.device.  Where one
    CUDA device holds every shard's full SA, resolve_pack.cu reads the
    positions through its shard table (kernels.resolve_stream_table), with
    no gather, sum or copy of its own."""
    packed = sharded_seed_scan(sfm, reads, rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max)
    lookup = sharded_lookup(sfm)
    if _on(sfm.device) == "cuda":
        from .. import kernels

        if sfm.has_full_sa and len(shard_groups(sfm)) == 1:
            return kernels.resolve_stream_table(_resident_table(sfm), sfm.ns_local, packed,
                                                max_seeds=max_seeds, occ_budget=occ_budget)

        def fill(rows, gpos, done):
            pos, ok = lookup(rows)
            gpos.copy_(pos)
            done.copy_(ok)

        return kernels.resolve_stream(packed, fill, max_seeds=max_seeds, occ_budget=occ_budget)
    out = unpack_seed_scan(packed, max_seeds)
    ok_in = torch.ones(packed.shape[0], dtype=torch.bool, device=packed.device)
    return expand_resolve_plain(lookup, out["n_seeds"], out["rpos"], out["slen"], out["k0"],
                                out["freq"], ok_in, occ_budget=occ_budget)
