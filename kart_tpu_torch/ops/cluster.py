"""Batched candidate clustering (the divide stage's entry) on PyTorch tensors.

Counterpart of `kart_tpu/ops/cluster.py`, the device recast of
GenerateAlignmentCandidateForIlluminaSeq (reference:
src/AlignmentCandidates.cpp:82-130).  PosDiff-sorted seeds are grouped into
clusters slot by slot: a cluster opens at the first valid seed, where a
seed's gPos passes the chromosome end of the seed that opened the cluster
(a left search over the ChrLocMap keys, GetAlignmentBoundary,
src/tools.cpp:399), or where its PosDiff is more than MaxGaps past the
previous valid seed's.  A cluster's score is the sum of its seeds' lengths,
and the reference's rising threshold (thr -> score - 50 on accept) runs over
the cluster slots.  `cluster_illumina` returns the same three (B, S) arrays
as the JAX function; on CPU tensors it runs the plain version below, on
CUDA tensors the hand-written kernel `csrc/cluster.cu`
(kernels.cluster_illumina).  `cluster_batch_to_candidates` builds the host
Candidate lists from them, as kart_tpu's wrapper does.

Positions are int32, as kart_tpu has them (`ops/int32.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from .int32 import int32_array

_BIG = 2**31 - 1  # the chromosome end past the last key, and the pad posdiff


def cluster_illumina_plain(chr_keys, pd, gp, ln, n_seeds, thr0, max_gaps, *, max_seeds: int):
    """kart_tpu's cluster_illumina with a loop over the S seed slots and
    tensor operations over the B reads.  chr_keys (K,) int32 sorted, pd, gp,
    ln (B, S) int32 (pd padded with _BIG), n_seeds and thr0 (B,) int32,
    max_gaps an int.  -> (cluster_id (B, S) int32, -1 for none; accept
    (B, S) bool per cluster slot; scores (B, S) int32 per cluster slot)."""
    B, S = pd.shape
    if S != max_seeds:
        raise ValueError(f"cluster_illumina: {S} seed slots, max_seeds {max_seeds}")
    dev = pd.device
    i32 = torch.int32
    valid = (torch.arange(S, device=dev)[None, :] < n_seeds[:, None]) & (pd >= 0)
    K = chr_keys.shape[0]
    if K:
        lb = torch.searchsorted(chr_keys, gp.contiguous(), side="left")
        ends = torch.where(lb < K, chr_keys[lb.clamp(max=K - 1)], _BIG)
    else:
        ends = torch.full((B, S), _BIG, dtype=i32, device=dev)
    gend = torch.zeros(B, dtype=i32, device=dev)
    prev_pd = torch.zeros(B, dtype=i32, device=dev)
    started = torch.zeros(B, dtype=torch.bool, device=dev)
    cid = torch.full((B,), -1, dtype=i32, device=dev)
    cluster_id = torch.full((B, S), -1, dtype=i32, device=dev)
    for t in range(S):
        v = valid[:, t]
        brk = ~started | (gp[:, t] > gend) | (pd[:, t] - prev_pd > max_gaps)
        is_new = v & brk
        gend = torch.where(is_new, ends[:, t], gend)
        started |= v
        cid += is_new.to(i32)
        cluster_id[:, t] = torch.where(v, cid, -1)
        prev_pd = torch.where(v, pd[:, t], prev_pd)
    # per-cluster scores; the ids of invalid seeds go to a dropped column
    slot = torch.where(cluster_id >= 0, cluster_id, S).long()
    scores = torch.zeros((B, S + 1), dtype=i32, device=dev).scatter_add_(
        1, slot, torch.where(valid, ln, 0))[:, :S].contiguous()
    thr = thr0.clone()
    accept = torch.zeros((B, S), dtype=torch.bool, device=dev)
    for c in range(S):
        s = scores[:, c]
        a = s > thr
        thr = torch.where(a & (s - 50 > thr), s - 50, thr)
        accept[:, c] = a
    return cluster_id, accept, scores


def cluster_illumina(chr_keys, pd, gp, ln, n_seeds, thr0, max_gaps, *, max_seeds: int):
    """(cluster_id, accept, scores) of cluster_illumina_plain.  CPU tensors run
    the plain version, CUDA tensors the kernel."""
    if pd.device.type == "cuda":
        from ..kernels import cluster_illumina as kernel

        return kernel(chr_keys, pd, gp, ln, n_seeds, thr0, int(max_gaps), max_seeds=max_seeds)
    if pd.device.type != "cpu":
        raise ValueError(f"cluster_illumina: unsupported device {pd.device}")
    return cluster_illumina_plain(chr_keys, pd, gp, ln, n_seeds, thr0, int(max_gaps),
                                  max_seeds=max_seeds)


def cluster_batch_to_candidates(gidx, seeds_lists, rlens, max_gaps: int, *, device):
    """Cluster a batch of PosDiff-sorted seed lists on `device` and build the
    host Candidate lists: each accepted cluster's seeds copied and re-sorted
    by gPos, exactly as the host path (gen_candidates_illumina) builds them."""
    from ..pipeline.candidates import Candidate, Seed, sort_by_gpos

    B = len(seeds_lists)
    n = np.array([len(s) for s in seeds_lists], dtype=np.int64)
    S = max(1, int(n.max()) if B else 1)
    pd = np.full((B, S), _BIG, np.int32)
    gp = np.zeros((B, S), np.int32)
    ln = np.zeros((B, S), np.int32)
    flat = [s for seeds in seeds_lists for s in seeds]
    if flat:
        rows = np.repeat(np.arange(B), n)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(n) - n, n)
        pd[rows, cols] = int32_array([s.posdiff for s in flat], "seed posdiff")
        gp[rows, cols] = int32_array([s.gpos for s in flat], "seed gpos")
        ln[rows, cols] = int32_array([s.rlen for s in flat], "seed length")
    thr0 = np.minimum((np.asarray(rlens, dtype=np.float64) * 0.2).astype(np.int32), 50)
    keys = gidx.chr_map[0].astype(np.int32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    cid, accept, scores = (
        x.cpu().numpy()
        for x in cluster_illumina(put(keys), put(pd), put(gp), put(ln), put(n), put(thr0),
                                  int(max_gaps), max_seeds=S)
    )
    out_all = []
    for b, seeds in enumerate(seeds_lists):
        members: dict[int, list] = {}
        for t, s in enumerate(seeds):
            c = int(cid[b, t])
            if c >= 0:
                members.setdefault(c, []).append(s)
        cands = []
        for c in sorted(members):
            if not accept[b, c]:
                continue
            cand = Candidate(score=int(scores[b, c]), posdiff=0)
            cand.seeds = [Seed(s.simple, s.rpos, s.gpos, s.rlen, s.glen, s.posdiff)
                          for s in members[c]]
            cand.posdiff = max(cand.seeds[0].posdiff, 0)
            sort_by_gpos(cand.seeds)
            cands.append(cand)
        out_all.append(cands)
    return out_all
