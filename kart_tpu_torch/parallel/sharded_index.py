"""The block-sharded FM index behind -idx-shards.

Counterpart of kart_tpu/parallel/sharded_index.py.  For genomes whose
Occ/BWT/SA arrays exceed one card's memory, the index is split block-wise
into N slabs, each a set of tensors on its own device, and every Occ/SA
lookup is answered by each shard for the queries its slab holds (zeros for
the others), then the shards' results are summed on the first shard's
device.  Exactly one shard owns each query, so the sum is exact.  That sum is
what kart_tpu's psum over its `idx` mesh axis does, in one process: it is not
a torch.distributed collective.  The shards may share a device (the tests put
all N on the CPU; chip_smoke.py puts all N on one card).

Each shard's lookup is one of four kernels (csrc/sharded_fm.cu, bound in
kernels.py) on a CUDA tensor, or its plain version here on a CPU tensor:

  G1 shard_occ4       masked occ4 of (2B,) rows: both interval ends of a scan step
  G2 scan step        one FastMode step of every lane from the combined counts
                      (ops/fm_search.py::seed_scan_step_plain)
  G3 shard_inv_psi    one step of the sampled-SA walk, masked
  G4 shard_gather     masked gather from a slab of the full or the sampled SA

Occurrences are expanded and resolved by ops/resolve.py's plain version, or
on the card by csrc/resolve_pack.cu's passes around the sharded lookup
(kernels.resolve_stream).  Nothing falls back to the replicated index or to
the CPU: a kernel that fails to build or launch raises.
"""

from __future__ import annotations

from dataclasses import dataclass
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
    """The shards' devices: cuda:0 .. cuda:N-1 on a CUDA device (more shards
    than cards raises, as kart_tpu refuses more shards than devices), all N
    on the CPU otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_shards
    have = torch.cuda.device_count()
    if n_shards > have:
        raise RuntimeError(f"idx_shards={n_shards} but only {have} devices")
    return [torch.device("cuda", i) for i in range(n_shards)]


# ---------------------------------------------------------------------------
# One shard's lookups: the plain versions (CPU tensors) and their dispatch
# ---------------------------------------------------------------------------


def _owned(sfm: ShardedFM, shard: FMShard, k: torch.Tensor):
    """(kk, local block clamped into the slab, whether the shard owns it) of
    rows k."""
    kk = k - (k >= sfm.primary).to(k.dtype)
    row = (kk >> 7) - shard.index * sfm.nb_local
    mine = (row >= 0) & (row < sfm.nb_local)
    return kk, row.clamp(0, sfm.nb_local - 1).long(), mine


def _block(shard: FMShard, rc: torch.Tensor):
    dev = rc.device
    words = shard.bwt_words[rc[:, None] * 8 + torch.arange(8, device=dev)].long() & _M32
    base = shard.occ_cp[rc[:, None] * 4 + torch.arange(4, device=dev)]
    return words, base


def shard_occ4_plain(sfm: ShardedFM, shard: FMShard, k: torch.Tensor) -> torch.Tensor:
    """G1's plain version: occ4 (n, 4) of the rows k (n,) whose block the
    shard holds, zeros elsewhere."""
    kk, rc, mine = _owned(sfm, shard, k)
    words, base = _block(shard, rc)
    return torch.where(mine[:, None], occ4_from(words, base, kk), 0)


def shard_inv_psi_plain(sfm: ShardedFM, shard: FMShard, k: torch.Tensor, add=None):
    """G3's plain version: one walk step of the rows k (n,) the shard owns (a
    row at a sample stays, others take bwt_invPsi; the row `primary` maps to
    0), zeros elsewhere.  add (n,) int32, where given, gets one more step for
    every row not at a sample."""
    at_sample = (k & ((1 << SA_INTV_LOG2) - 1)) == 0
    if add is not None:
        add += (~at_sample).to(add.dtype)
    kk, rc, mine = _owned(sfm, shard, k)
    words, base = _block(shard, rc)
    cnt = occ4_from(words, base, kk)
    # x == kk for every k != primary, so x's word is in the block
    x = k - (k > sfm.primary).to(k.dtype)
    w = words.gather(1, ((x & 0x7F) >> 4).long()[:, None])[:, 0]
    c = (w >> ((~x & 0xF) << 1).long()) & 3
    nk = shard.L2[c] + cnt.gather(1, c[:, None])[:, 0]
    nk = torch.where(k == sfm.primary, 0, nk).to(k.dtype)
    return torch.where(mine, torch.where(at_sample, k, nk), 0)


def shard_gather_plain(slab: torch.Tensor, lo: int, rows: torch.Tensor, shift: int = 0):
    """G4's plain version: slab[(rows >> shift) - lo] where the slab holds
    the row, else 0."""
    r = (rows >> shift) - lo
    mine = (r >= 0) & (r < slab.shape[0])
    return torch.where(mine, slab[r.clamp(0, slab.shape[0] - 1).long()], 0)


def _on(dev: torch.device) -> str:
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"sharded index: unsupported device {dev}")
    return dev.type


def shard_occ4(sfm: ShardedFM, shard: FMShard, k: torch.Tensor) -> torch.Tensor:
    """G1 on the shard's device: the kernel on a CUDA shard, else the plain
    version."""
    k = k.to(shard.device)
    if _on(shard.device) == "cuda":
        from .. import kernels

        return kernels.sharded_occ4(shard.occ_cp, shard.bwt_words, sfm.primary,
                                    shard.index * sfm.nb_local, sfm.nb_local, k)
    return shard_occ4_plain(sfm, shard, k)


def shard_inv_psi(sfm: ShardedFM, shard: FMShard, k: torch.Tensor, add=None) -> torch.Tensor:
    """G3 on the shard's device (add on the same device, or None)."""
    k = k.to(shard.device)
    if _on(shard.device) == "cuda":
        from .. import kernels

        return kernels.sharded_inv_psi(shard.occ_cp, shard.bwt_words, shard.L2, sfm.primary,
                                       shard.index * sfm.nb_local, sfm.nb_local, k, add)
    return shard_inv_psi_plain(sfm, shard, k, add)


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
    """The sum of the shards' results on `device` (the first shard's, where
    parts[0] already lies): one owner a query, so the sum is its answer."""
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part.to(device)
    return acc


# ---------------------------------------------------------------------------
# The sharded lookups and the scan, kart_tpu's names
# ---------------------------------------------------------------------------


def sharded_occ4_batch(sfm: ShardedFM, k: torch.Tensor) -> torch.Tensor:
    """occ4 (B, 4) of the rows k (B,) against the sharded index, on
    sfm.device."""
    return combine([shard_occ4(sfm, s, k) for s in sfm.shards], sfm.device)


def sharded_occ4_pair(sfm: ShardedFM, ka: torch.Tensor, kb: torch.Tensor):
    """Both occ4 lookups of a scan step as one (2B,) lookup a shard and one
    sum."""
    cnt = sharded_occ4_batch(sfm, torch.cat([ka, kb]))
    return cnt[: ka.shape[0]], cnt[ka.shape[0]:]


def sharded_sa_gather(sfm: ShardedFM, rows: torch.Tensor) -> torch.Tensor:
    """sa_full[rows] with the full SA split over the shards."""
    if not sfm.has_full_sa:
        raise ValueError("sharded_sa_gather: the index was split without its full SA")
    return combine([shard_gather(s.sa_full, s.index * sfm.ns_local, rows) for s in sfm.shards],
                   sfm.device)


def sharded_inv_psi_batch(sfm: ShardedFM, k: torch.Tensor, add=None) -> torch.Tensor:
    """One step of the sampled-SA walk of the rows k (N,): bwt_invPsi, as
    kart_tpu's sharded_inv_psi_batch, for the rows not at a sample; a row at
    a sample stays.  add (N,) int32 on sfm.device, where given, gets one
    more step for every row not at a sample."""
    return combine([shard_inv_psi(sfm, s, k, add if s.index == 0 else None)
                    for s in sfm.shards], sfm.device)


def sharded_sa_walk(sfm: ShardedFM, rows: torch.Tensor, *, max_steps: int = SA_WALK_MAX_STEPS):
    """Sampled-SA resolution of the rows (N,) over the sharded index, with
    fm_search.sa_walk's contract (pos, done): walk steps until every row is
    at a sample or max_steps steps are taken, then the sample of each row's
    end from the sharded sampled SA, plus the steps.  The loop runs on the
    host and every shard takes each step; a row at a sample keeps its row, so
    the rows are looked at only every WALK_CHECK_EVERY steps, and the walk
    stops after max_steps steps exactly."""
    dev = sfm.device
    k = rows.to(device=dev, dtype=sfm.index_dtype)
    add = torch.zeros(k.shape[0], dtype=torch.int32, device=dev)
    mask = (1 << SA_INTV_LOG2) - 1
    for it in range(max_steps):
        if it % WALK_CHECK_EVERY == 0 and not bool(((k & mask) != 0).any()):
            break
        k = sharded_inv_psi_batch(sfm, k, add)
    samp = combine([shard_gather(s.sa_samples, s.index * sfm.nsamp_local, k, SA_INTV_LOG2)
                    for s in sfm.shards], dev)
    return add.to(k.dtype) + samp, (k & mask) == 0


def sharded_seed_scan(sfm: ShardedFM, reads, rlens, min_seed_len, *, max_seeds: int, l_max: int):
    """FastMode seeding against the sharded index: the same packed (B, 1 +
    4*max_seeds) array as ops/fm_search.seed_scan on the replicated index,
    on sfm.device.  Each of the l_max + 1 steps is one G1 lookup a shard of
    both interval ends of every lane, their sum, and one G2 step."""
    dev = sfm.device
    return seed_scan_loop(lambda k: sharded_occ4_batch(sfm, k), scan_step, sfm.L2, sfm.primary,
                          reads.to(dev), rlens.to(dev), min_seed_len, max_seeds=max_seeds,
                          l_max=l_max)


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
