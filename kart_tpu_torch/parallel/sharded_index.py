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
Where the shards span several devices, the host steps (the cross-device
path), one launch a device a step and the devices' results summed on the
first shard's device (a sum in one process, not a torch.distributed
collective):
  G1 sharded_occ4     occ4 of (2B,) rows: both interval ends of a scan step
  G2 scan step        one FastMode step of every lane from the summed counts
                      (ops/fm_search.py::seed_scan_step_plain)
  G3 sharded_inv_psi  one step of the sampled-SA walk
  G4 shard_gather     masked gather from a slab of the full or the sampled SA
                      (also the full-SA gather of the resident path)

Each kernel has its plain version here (CPU tensors): table_occ4_plain,
table_inv_psi_plain, shard_gather_plain, and resident_seed_scan_plain and
resident_sa_walk_plain, the cross-device loops over them with every shard
in one group.  Occurrences are
expanded and resolved by ops/resolve.py's plain version, or on the card by
csrc/resolve_pack.cu's passes around the sharded lookup
(kernels.resolve_stream).  Nothing falls back to another path, to the
replicated index or to the CPU: a kernel that fails to build or launch, a
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
    seed_scan_loop,
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
    """G4's plain version: slab[(rows >> shift) - lo] where the slab holds
    the row, else 0."""
    r = (rows >> shift) - lo
    mine = (r >= 0) & (r < slab.shape[0])
    return torch.where(mine, slab[r.clamp(0, slab.shape[0] - 1).long()], 0)


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
    """The shard table of `shards`, which lie on one device: (N, 3) int64
    there, row s the data pointers of shard s's occ_cp, bwt_words and
    sa_samples slabs where shard s is one of `shards`, zeros elsewhere.
    Made once per ShardedFM, device and set of slabs; its `every_shard` says
    whether it holds every shard of the index, which the resident kernels
    ask of the table they read."""
    dev = shards[0].device
    for s in shards:
        if s.device != dev:
            raise ValueError(f"shard table: shard {s.index} on {s.device}, the table's on {dev}")
    ptrs = {s.index: (s.occ_cp.data_ptr(), s.bwt_words.data_ptr(), s.sa_samples.data_ptr())
            for s in shards}
    key = (dev, tuple(sorted(ptrs.items())))
    if key not in sfm.tables:
        rows = [ptrs.get(i, (0, 0, 0)) for i in range(len(sfm.shards))]
        table = torch.tensor(rows, dtype=torch.int64).to(dev)
        table.every_shard = len(ptrs) == len(sfm.shards)
        sfm.tables[key] = table
    return sfm.tables[key]


def _group_tables(sfm: ShardedFM, groups, plain: bool = False) -> list:
    """(group, its shard table) for each group of shards, made once for a
    whole loop; None for the table where the plain version answers for the
    group (CPU tensors, or `plain`)."""
    return [(g, None if plain or _on(g[0].device) == "cpu" else shard_table(sfm, g))
            for g in groups]


def _occ4_of(sfm: ShardedFM, shards: list[FMShard], table, k: torch.Tensor) -> torch.Tensor:
    """G1 on the device of `shards`: the kernel through `table`, or the
    plain version where table is None."""
    k = k.to(shards[0].device)
    if table is None:
        return table_occ4_plain(sfm, shards, k)
    from .. import kernels

    return kernels.sharded_occ4(table, sfm.nb_local, shards[0].L2, sfm.primary, sfm.seq_len, k)


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


def shard_gather(slab: torch.Tensor, lo: int, rows: torch.Tensor, shift: int = 0):
    """G4 on the slab's device."""
    rows = rows.to(slab.device)
    if _on(slab.device) == "cuda":
        from .. import kernels

        return kernels.sharded_gather(slab, lo, rows, shift)
    return shard_gather_plain(slab, lo, rows, shift)


def scan_step(p, cnt, codes_t, rlens, L2, primary, min_seed_len, max_seeds, state, out):
    """G2 (seed_scan_step_plain's arguments and result): the kernel on CUDA
    tensors, else the plain version."""
    if _on(cnt.device) == "cuda":
        from .. import kernels

        return kernels.sharded_scan_step(p, cnt, codes_t, rlens, L2, primary, min_seed_len,
                                         max_seeds, state, out)
    return seed_scan_step_plain(p, cnt, codes_t, rlens, L2, primary, min_seed_len, max_seeds,
                                state, out)


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


def sharded_sa_gather(sfm: ShardedFM, rows: torch.Tensor) -> torch.Tensor:
    """sa_full[rows] with the full SA split over the shards."""
    if not sfm.has_full_sa:
        raise ValueError("sharded_sa_gather: the index was split without its full SA")
    return combine([shard_gather(s.sa_full, s.index * sfm.ns_local, rows) for s in sfm.shards],
                   sfm.device)


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
    max_steps steps exactly, and gathers each row's sample (G4 a shard).
    `plain`: the plain versions on whatever device the shards lie."""
    dev = sfm.device
    tables = _group_tables(sfm, groups, plain)
    gather = shard_gather_plain if plain else shard_gather
    k = rows.to(device=dev, dtype=sfm.index_dtype)
    add = torch.zeros(k.shape[0], dtype=torch.int32, device=dev)
    mask = (1 << SA_INTV_LOG2) - 1
    for it in range(max_steps):
        if it % WALK_CHECK_EVERY == 0 and not bool(((k & mask) != 0).any()):
            break
        k = _inv_psi_sum(sfm, tables, k, add)
    samp = combine([gather(s.sa_samples, s.index * sfm.nsamp_local, k.to(s.device), SA_INTV_LOG2)
                    for s in sfm.shards], dev)
    return add.to(k.dtype) + samp, (k & mask) == 0


def sharded_sa_walk(sfm: ShardedFM, rows: torch.Tensor, *, max_steps: int = SA_WALK_MAX_STEPS):
    """Sampled-SA resolution of the rows (N,) over the sharded index, with
    fm_search.sa_walk's contract (pos, done), on sfm.device: the resident
    walk where one device holds every shard, else the cross-device walk."""
    groups = shard_groups(sfm)
    if len(groups) == 1:
        return resident_sa_walk(sfm, rows, max_steps=max_steps)
    return _stepwise_sa_walk(sfm, rows, max_steps=max_steps, groups=groups)


def _stepwise_seed_scan(sfm: ShardedFM, reads, rlens, min_seed_len, *, max_seeds: int, l_max: int,
                        groups, plain: bool = False):
    """The cross-device scan: each of the l_max + 1 steps is one G1 lookup a
    group of shards of both interval ends of every lane, their sum, and one
    G2 step, on sfm.device.  `plain`: the plain versions on whatever device
    the shards lie."""
    dev = sfm.device
    tables = _group_tables(sfm, groups, plain)
    return seed_scan_loop(lambda k: _occ4_sum(sfm, tables, k),
                          seed_scan_step_plain if plain else scan_step, sfm.L2, sfm.primary,
                          reads.to(dev), rlens.to(dev), min_seed_len, max_seeds=max_seeds,
                          l_max=l_max)


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
    stream (cnts, meta, gpos) of ops/resolve.py, on sfm.device."""
    packed = sharded_seed_scan(sfm, reads, rlens, min_seed_len, max_seeds=max_seeds, l_max=l_max)
    lookup = sharded_lookup(sfm)
    if _on(sfm.device) == "cuda":
        from .. import kernels

        def fill(rows, gpos, done):
            pos, ok = lookup(rows)
            gpos.copy_(pos)
            done.copy_(ok)

        return kernels.resolve_stream(packed, fill, max_seeds=max_seeds, occ_budget=occ_budget)
    out = unpack_seed_scan(packed, max_seeds)
    ok_in = torch.ones(packed.shape[0], dtype=torch.bool, device=packed.device)
    return expand_resolve_plain(lookup, out["n_seeds"], out["rpos"], out["slen"], out["k0"],
                                out["freq"], ok_in, occ_budget=occ_budget)
