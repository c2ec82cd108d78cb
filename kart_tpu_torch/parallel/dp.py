"""The multi-device mapping step: data-parallel reads x an optionally sharded
index.

Counterpart of kart_tpu/parallel/dp.py (the same names).  kart_tpu runs its
step as one shard_map over a jax Mesh: reads split along the `data` axis,
the FM index replicated or block-sharded along an `idx` axis, the seed
total a psum over `data`.  The port runs the same step in one process over
a `DataMesh`, an (n_data, n_idx) grid of torch devices: the batch is cut
into n_data contiguous blocks (as P("data") cuts it), block r runs on data
row r (the replicated index on the row's first device, or the index split
into n_idx slabs over the row's devices, parallel/sharded_index.py), and
the blocks' outputs are concatenated in block order on the first row's
first device; the total is their int32 sum.  Positions of a mesh may share
one device (the tests put all of them on the CPU, chip_smoke.py on one
card): that holds the path, it does not scale it.

kart_tpu's `ShardedFMSpecs` has no counterpart: it only describes the JAX
PartitionSpecs of a ShardedFM, and the port's ShardedFM carries each
shard's device itself (`place_sharded_fm`).

`_sorted_occurrences`, the PosDiff sort of the front half, is a kernel:
`csrc/sorted_occ.cu` on CUDA tensors (kernels.sorted_occurrences), its plain
version `sorted_occurrences_plain` on CPU tensors.  So is the rest of the
front half after it, `_candidate_tail` (clustering, the candidate glue of a
scatter-min and a few elementwise ops, and mating): one launch of
`csrc/cluster.cu`'s tail on CUDA tensors (kernels.candidate_tail), its plain
version `candidate_tail_plain` on CPU tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.cluster import cluster_illumina_plain
from ..ops.fm_search import FMIndexTensors, seed_scan
from ..ops.int32 import check_int32_index
from ..ops.pairing import pair_candidates_plain
from ..ops.resolve import resolve_pack
from .sharded_index import (
    FMShard,
    ShardedFM,
    build_sharded_fm,
    sharded_sa_gather,
    sharded_seed_scan,
    sharded_seed_scan_resolved,
)

_BIG32 = 2**31 - 1


@dataclass(frozen=True)
class DataMesh:
    """An (n_data, n_idx) grid of devices: `devices[r]` is data row r's n_idx
    devices.  axis_names ("data",) or ("data", "idx"), and `shape` keyed by
    them, as kart_tpu's Mesh has them."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        sizes = (len(self.devices), len(self.devices[0]))
        return dict(zip(self.axis_names, sizes))


def make_data_mesh(n_data: int, n_idx: int = 1, devices=None) -> DataMesh:
    """A (data[, idx]) mesh over the first n_data*n_idx of `devices`, or
    with devices None over cuda:0 .. cuda:need-1, which raises past
    torch.cuda.device_count() (kart_tpu fails with too few devices).  A
    device may be given more than once: [cuda:0] * 4 puts four positions on
    one card."""
    need = n_data * n_idx
    if devices is None:
        have = torch.cuda.device_count()
        if need > have:
            raise RuntimeError(f"a {n_data} x {n_idx} mesh needs {need} devices, only {have}"
                               f" CUDA devices")
        devices = [torch.device("cuda", i) for i in range(need)]
    devs = [torch.device(d) for d in devices[:need]]
    if len(devs) < need:
        raise ValueError(f"a {n_data} x {n_idx} mesh needs {need} devices, got {len(devs)}")
    rows = tuple(tuple(devs[r * n_idx:(r + 1) * n_idx]) for r in range(n_data))
    return DataMesh(rows, ("data",) if n_idx == 1 else ("data", "idx"))


def place_sharded_fm(sfm: ShardedFM, devices) -> ShardedFM:
    """sfm with shard s on devices[s]; a tensor already there is not
    copied."""
    devices = [torch.device(d) for d in devices]
    if len(devices) != len(sfm.shards):
        raise ValueError(f"place_sharded_fm: {len(sfm.shards)} shards, {len(devices)} devices")

    def put(t, d):
        return None if t is None else t.to(d)

    shards = [FMShard(index=s.index, occ_cp=put(s.occ_cp, d), bwt_words=put(s.bwt_words, d),
                      sa_full=put(s.sa_full, d), sa_samples=put(s.sa_samples, d),
                      L2=put(s.L2, d))
              for s, d in zip(sfm.shards, devices)]
    return dataclasses.replace(sfm, shards=shards)


# ---------------------------------------------------------------------------
# The index on each data row, and the batch cut into the rows' blocks
# ---------------------------------------------------------------------------


def _check_idx_axis(mesh: DataMesh, idx_axis) -> None:
    if idx_axis is not None and idx_axis not in mesh.axis_names[1:]:
        raise ValueError(f"idx_axis {idx_axis!r} is not an index axis of {mesh.axis_names}")


def _replicated(gidx, mesh: DataMesh, with_full_sa: bool) -> list[FMIndexTensors]:
    """The replicated index on each data row's first device (one copy a
    device), its full SA there too where asked for."""
    by_dev: dict = {}
    out = []
    for row in mesh.devices:
        dev = row[0]
        if dev not in by_dev:
            fm = FMIndexTensors.from_genome_index(gidx, dev, with_full_sa=with_full_sa)
            if fm.sa_full is not None:
                fm = dataclasses.replace(fm, sa_full=fm.sa_full.to(dev))
            by_dev[dev] = fm
        out.append(by_dev[dev])
    return out


def _sharded(gidx, mesh: DataMesh, sa_mode: str) -> list[ShardedFM]:
    """The index split over each data row's devices: built once, placed on
    every row."""
    sfm = build_sharded_fm(gidx, mesh.devices[0], sa_mode)
    return [sfm] + [place_sharded_fm(sfm, row) for row in mesh.devices[1:]]


def _place_reads(mesh: DataMesh):
    """place_reads(reads, rlens) -> (reads blocks, rlens blocks): the batch
    cut into n_data contiguous blocks, block r on data row r's first device.
    Blocks from an earlier place_reads pass through."""
    n = len(mesh.devices)

    def place_reads(reads, rlens):
        if isinstance(reads, list):
            return reads, rlens
        reads, rlens = torch.as_tensor(reads), torch.as_tensor(rlens)
        B = reads.shape[0]
        if B % n:
            raise ValueError(f"a batch of {B} reads does not split over {n} data rows")
        b = B // n
        return ([reads[r * b:(r + 1) * b].to(row[0]) for r, row in enumerate(mesh.devices)],
                [rlens[r * b:(r + 1) * b].to(row[0]) for r, row in enumerate(mesh.devices)])

    return place_reads


def _concat(parts, dev) -> torch.Tensor:
    return torch.cat([p.to(dev) for p in parts])


# ---------------------------------------------------------------------------
# The seeding step
# ---------------------------------------------------------------------------


def make_mapping_step(mesh: DataMesh, gidx, *, idx_axis: str | None = None, min_seed_len: int,
                      max_seeds: int, l_max: int):
    """The device mapping step over `mesh`: (step, place_reads) where

      step(reads, rlens) -> (packed_seeds, locs, total_seeds)
        packed_seeds (B, 1+4*max_seeds)  seed blocks per read, index dtype
        locs         (B, max_seeds)      text position of each seed's first
                                         occurrence (SA-resolved)
        total_seeds  ()           int32  the seed count of the whole batch
      place_reads(reads, rlens) cuts a host batch into the data rows' blocks.

    The replicated index seeds with ops/fm_search.seed_scan and gathers
    sa_full[k0]; with idx_axis the index is split over each row's devices
    and seeds with sharded_seed_scan, then sharded_sa_gather."""
    _check_idx_axis(mesh, idx_axis)
    msl = int(min_seed_len)
    kw = dict(max_seeds=max_seeds, l_max=l_max)
    c0 = 1 + 2 * max_seeds
    if idx_axis is None:
        fms = _replicated(gidx, mesh, with_full_sa=True)

        def local(r, reads, rlens):
            fm = fms[r]
            packed = seed_scan(fm, reads, rlens, msl, **kw)
            return packed, fm.sa_full[packed[:, c0:c0 + max_seeds].long()]
    else:
        sfms = _sharded(gidx, mesh, "full")

        def local(r, reads, rlens):
            packed = sharded_seed_scan(sfms[r], reads, rlens, msl, **kw)
            k0 = packed[:, c0:c0 + max_seeds]
            return packed, sharded_sa_gather(sfms[r], k0.reshape(-1)).reshape(k0.shape)

    place_reads = _place_reads(mesh)
    out_dev = mesh.devices[0][0]

    def step(reads, rlens):
        outs = [local(r, rd, rl) for r, (rd, rl) in enumerate(zip(*place_reads(reads, rlens)))]
        packed = _concat([o[0] for o in outs], out_dev)
        locs = _concat([o[1] for o in outs], out_dev)
        return packed, locs, packed[:, 0].sum(dtype=torch.int32)

    return step, place_reads


# ---------------------------------------------------------------------------
# F: the PosDiff sort of the resolved stream
# ---------------------------------------------------------------------------


def sorted_occurrences_plain(cnts, meta, gpos, B: int, s_occ: int):
    """kart_tpu's _sorted_occurrences in torch ops: the flat resolved stream
    cnts (B,) int32, meta (H,) int32, gpos (H,) int32 or int64 scattered back
    to (B, s_occ) slots a read (read b takes the entries from the exclusive
    prefix sum of max(cnts, 0), at most s_occ of them; an entry is valid when
    its slen field is not 0xFFFF), each read's slots sorted by (posdiff,
    rpos) with two composed stable argsorts.  -> (n_occ (B,) int32, rp (B,
    s_occ) int32 (fill 2**31-1), ln int32 (fill 0), gp in gpos's dtype (fill
    0), pd int32 (gpos - rp narrowed after the sort; the fill, gpos's
    largest value, narrows to its low 32 bits), present bool (pd below the
    fill, taken before the narrowing))."""
    dev = meta.device
    H = meta.shape[0]
    idt = gpos.dtype
    big = torch.iinfo(idt).max
    i32 = torch.int32
    tot = cnts.clamp(min=0)
    cum = torch.cumsum(tot, 0, dtype=i32)
    offs = cum - tot
    jh = torch.arange(H, dtype=i32, device=dev)
    lane = torch.searchsorted(cum, jh, right=True).to(i32)
    lane_c = lane.clamp(max=B - 1).long()
    slot = jh - offs[lane_c]
    # meta holds rpos | slen << 16: a slen of 32768 sets the sign bit, so
    # validity is the slen field against the -1 fill, never meta >= 0
    ln = (meta >> 16) & 0xFFFF
    valid = (ln != 0xFFFF) & (slot < s_occ) & (lane < B)
    rp = meta & 0xFFFF
    pd = gpos - rp.to(idt)
    col = torch.where(valid, slot, s_occ).long()  # column s_occ takes what is dropped

    def scat(vals, fill, dt):
        out = torch.full((B, s_occ + 1), fill, dtype=dt, device=dev)
        out[lane_c, col] = torch.where(valid, vals, fill).to(dt)
        return out[:, :s_occ]

    pd_b = scat(pd, big, idt)
    rp_b = scat(rp, _BIG32, i32)
    ln_b = scat(ln, 0, i32)
    gp_b = scat(gpos, 0, idt)
    # lexicographic (posdiff, rpos, slot): torch's argsort is stable only when asked
    o1 = torch.argsort(rp_b, dim=1, stable=True)
    o2 = torch.argsort(pd_b.gather(1, o1), dim=1, stable=True)
    order = o1.gather(1, o2)
    pd_s = pd_b.gather(1, order)
    present = pd_s < big
    return (present.sum(dim=1, dtype=i32), rp_b.gather(1, order), ln_b.gather(1, order),
            gp_b.gather(1, order), pd_s.to(i32), present)


def _sorted_occurrences(cnts, meta, gpos, B: int, s_occ: int):
    """sorted_occurrences_plain's six outputs: the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if meta.device.type == "cuda":
        from .. import kernels

        return kernels.sorted_occurrences(cnts, meta, gpos, B, s_occ)
    if meta.device.type != "cpu":
        raise ValueError(f"_sorted_occurrences: unsupported device {meta.device}")
    return sorted_occurrences_plain(cnts, meta, gpos, B, s_occ)


# ---------------------------------------------------------------------------
# H: clustering, the candidate glue and mating
# ---------------------------------------------------------------------------


def candidate_tail_plain(keys, n_occ, ln_s, gp_s, pd_s, present, rlens, max_gaps: int,
                         est_distance: int):
    """kart_tpu's front half after the PosDiff sort, in torch ops: F's
    outputs of a block of B reads (B even; rows 2p and 2p + 1 are pair p),
    rlens (B,) and the chromosome keys (K,) int32 -> ((cluster_id, accept,
    scores) (B, s_occ), (paired1, paired2) (B/2, s_occ) and pairing (B/2,)).
    The threshold min(rlen * 2 // 10, 50), cluster_illumina_plain on the
    padded posdiffs, each candidate's posdiff the least of its member seeds'
    (clamped at 0) and its score where accepted, else 0, then
    pair_candidates_plain over the (even, odd) rows."""
    B, s_occ = pd_s.shape
    dev = pd_s.device
    thr0 = ((rlens.to(device=dev, dtype=torch.int32) * 2) // 10).clamp(max=50)
    pd_in = torch.where(present, pd_s, _BIG32)
    cid, accept, scores = cluster_illumina_plain(keys, pd_in, gp_s.to(torch.int32), ln_s, n_occ,
                                                 thr0, int(max_gaps), max_seeds=s_occ)
    # a candidate's posdiff: the least of its member seeds' (the first, as the
    # seeds are PosDiff-sorted), clamped at 0; column s_occ takes the seeds of
    # no cluster
    first_pd = torch.full((B, s_occ + 1), _BIG32, dtype=torch.int32, device=dev)
    first_pd.scatter_reduce_(1, torch.where(cid >= 0, cid, s_occ).long(), pd_in, "amin")
    cand_pd = torch.where(accept, first_pd[:, :s_occ], 0).clamp(min=0)
    cand_sc = torch.where(accept, scores, 0)
    pairs = pair_candidates_plain(cand_sc[0::2].contiguous(), cand_pd[0::2].contiguous(),
                                  cand_sc[1::2].contiguous(), cand_pd[1::2].contiguous(),
                                  int(est_distance))
    return (cid, accept, scores), pairs


def _candidate_tail(keys, n_occ, ln_s, gp_s, pd_s, present, rlens, max_gaps: int,
                    est_distance: int):
    """candidate_tail_plain's outputs: the kernel (one launch) on CUDA
    tensors, the plain version on CPU tensors."""
    if pd_s.device.type == "cuda":
        from .. import kernels

        return kernels.candidate_tail(keys, n_occ, ln_s, gp_s, pd_s, present, rlens, max_gaps,
                                      est_distance)
    if pd_s.device.type != "cpu":
        raise ValueError(f"_candidate_tail: unsupported device {pd_s.device}")
    return candidate_tail_plain(keys, n_occ, ln_s, gp_s, pd_s, present, rlens, max_gaps,
                                est_distance)


# ---------------------------------------------------------------------------
# The whole front half
# ---------------------------------------------------------------------------


def front_tail(cnts, meta, gpos, rlens, keys, B: int, s_occ: int, max_gaps: int,
               est_distance: int):
    """The front half of a block after the resolve: F (`_sorted_occurrences`)
    then H (`_candidate_tail`), two launches on the card.  -> ((cluster_id,
    accept, scores), (paired1, paired2, pairing))."""
    n_occ, _, ln_s, gp_s, pd_s, present = _sorted_occurrences(cnts, meta, gpos, B, s_occ)
    return _candidate_tail(keys, n_occ, ln_s, gp_s, pd_s, present, rlens, max_gaps,
                           est_distance)


def make_full_mapping_step(mesh: DataMesh, gidx, *, idx_axis: str | None = None,
                           min_seed_len: int, max_seeds: int, l_max: int, s_occ: int = 16,
                           max_gaps: int = 5, est_distance: int = 1500, sa_mode: str = "full"):
    """The whole device mapping front half over `mesh`, on each data row's
    block: FastMode seeding -> occurrence expansion and SA resolution (the
    full SA, or with sa_mode "sampled" the walk; through the sharded index
    with idx_axis) -> the PosDiff sort (F) -> candidate clustering
    (ops/cluster.py) -> paired-end mating (ops/pairing.py).  Consecutive
    (even, odd) rows of a block are a pair.

    step(reads, rlens) ->
      (cnts, meta, gpos)            resolved occurrence stream (a block's
                                    budget: 4 * B_local), blocks in order
      (cluster_id, accept, scores)  per-read clustering
      (paired1, paired2, pairing)   PE mating of accepted clusters

    CONTRACT: cnts[i] < 0 flags read i as overflowing its block's occurrence
    budget, and because the budget check is a prefix sum, every read after
    the first overflow in the block is flagged too.  A flagged read's
    clustering and pairing outputs are computed from zero occurrences and
    are not valid: callers check (cnts < 0).any() and re-seed flagged reads
    (graft_entry.dryrun_multichip asserts there are none at its shapes).
    Positions are int32, as kart_tpu's clustering and mating take them: an
    index of 2**31 text bases or more is refused."""
    check_int32_index(gidx, "make_full_mapping_step")
    if sa_mode not in ("full", "sampled"):
        raise ValueError(f"make_full_mapping_step: sa_mode {sa_mode!r}, expected full or sampled")
    _check_idx_axis(mesh, idx_axis)
    msl = int(min_seed_len)
    kw = dict(max_seeds=max_seeds, l_max=l_max)
    if idx_axis is None:
        fms = _replicated(gidx, mesh, with_full_sa=sa_mode == "full")

        def resolved(r, reads, rlens, budget):
            fm = fms[r]
            packed = seed_scan(fm, reads, rlens, msl, **kw)
            out = resolve_pack(fm.sa_full, packed, max_seeds=max_seeds, has_ok=False,
                               occ_budget=budget, pack16=False, fm=fm)
            if isinstance(out, tuple):
                return out
            B = packed.shape[0]
            return out[:B], out[B:B + budget], out[B + budget:]
    else:
        sfms = _sharded(gidx, mesh, sa_mode)

        def resolved(r, reads, rlens, budget):
            return sharded_seed_scan_resolved(sfms[r], reads, rlens, msl, occ_budget=budget, **kw)

    keys = np.ascontiguousarray(gidx.chr_map[0].astype(np.int32))
    keys_on: dict = {}

    def front_half(r, reads, rlens):
        B = reads.shape[0]
        if B % 2:
            raise ValueError(f"make_full_mapping_step: a block of {B} reads; mates are (even,"
                             f" odd) rows, so a block's batch must be even")
        cnts, meta, gpos = resolved(r, reads, rlens, 4 * B)
        dev = cnts.device
        if dev not in keys_on:
            keys_on[dev] = torch.from_numpy(keys).to(dev)
        clusters, pairs = front_tail(cnts, meta, gpos, rlens.to(device=dev, dtype=torch.int32),
                                     keys_on[dev], B, s_occ, max_gaps, est_distance)
        return (cnts, meta, gpos), clusters, pairs

    place_reads = _place_reads(mesh)
    out_dev = mesh.devices[0][0]

    def step(reads, rlens):
        outs = [front_half(r, rd, rl)
                for r, (rd, rl) in enumerate(zip(*place_reads(reads, rlens)))]
        return tuple(tuple(_concat([o[g][i] for o in outs], out_dev) for i in range(3))
                     for g in range(3))

    return step, place_reads


def per_read_entries(stream, n_blocks: int, keep=None):
    """Each read's entries of the resolved stream of a step over n_blocks
    data blocks (each block compacts its own stream of len(meta) / n_blocks
    entries), in read order: (counts (B,), meta, gpos), counts the reads'
    entry counts where `keep` (default: the reads not flagged) and 0
    elsewhere, meta and gpos the kept reads' entries one after another.  A
    read's entries start after those of every earlier read of its block,
    flagged ones included (a flagged count is -tot-1), so two steps over
    different meshes give each read the same entries when these are equal."""
    cnts, meta, gpos = stream
    dev = cnts.device
    if keep is None:
        keep = cnts >= 0
    tot = torch.where(cnts >= 0, cnts, -cnts - 1).long().view(n_blocks, -1)
    H = meta.numel() // n_blocks
    start = (torch.cumsum(tot, 1) - tot + H * torch.arange(n_blocks, device=dev)[:, None]).reshape(-1)
    take = torch.where(keep, tot.reshape(-1), 0)
    first = torch.cumsum(take, 0) - take
    n = int(take.sum())
    idx = torch.repeat_interleave(start - first, take) + torch.arange(n, device=dev)
    return take.to(cnts.dtype), meta[idx], gpos[idx]
