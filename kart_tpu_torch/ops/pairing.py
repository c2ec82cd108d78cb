"""Batched paired-end candidate mating on PyTorch tensors.

Counterpart of `kart_tpu/ops/pairing.py`, the device recast of
CheckPairedAlignmentCandidates (reference: src/Mapping.cpp:348-400) over all
read pairs of a chunk.  Each read-1 candidate i, in order, takes the read-2
candidate j with the unique best score among those with score > 0, posdiff
at or past its own and less than `est` past it (a tie gives no mate).  It
takes j if j is free, or steals j from its owner if its own score is
strictly greater than the owner's; the owner is then left without a mate.
Slots of score 0 are absent.  A pair is `pairing` where a slot took a mate,
and, as kart_tpu's carry starts, where its first read-1 score is negative.
`pair_candidates` returns the same arrays as the JAX function; on CPU
tensors it runs the plain version below, on CUDA tensors the hand-written
kernel `csrc/pairing.cu` (kernels.pair_candidates).
`pair_chunk_on_device` writes the mates back into the Candidate objects, as
kart_tpu's wrapper does.  (`pipeline/pairing.py` is the host version of the
same step.)
"""

from __future__ import annotations

import numpy as np
import torch

from .int32 import int32_array


def pair_candidates_plain(score1, pd1, score2, pd2, est):
    """kart_tpu's pair_candidates with a loop over the C1 read-1 slots and
    tensor operations over the P pairs.  score1/pd1 (P, C1) int32,
    score2/pd2 (P, C2) int32, est an int -> (paired1 (P, C1) int32,
    paired2 (P, C2) int32, the mate's index or -1; pairing (P,) bool)."""
    P, C1 = score1.shape
    C2 = score2.shape[1]
    dev = score1.device
    i32 = torch.int32
    paired1 = torch.full((P, C1), -1, dtype=i32, device=dev)
    paired2 = torch.full((P, C2), -1, dtype=i32, device=dev)
    # kart_tpu's carry starts as score1[:, 0] < 0: a pair whose first read-1
    # score is negative is `pairing` whether or not a slot takes a mate
    pairing = score1[:, 0] < 0 if C1 else torch.zeros(P, dtype=torch.bool, device=dev)
    if P == 0 or C2 == 0:
        return paired1, paired2, pairing
    ar = torch.arange(P, device=dev)
    for i in range(C1):
        pd_i = pd1[:, i : i + 1]
        m = (score2 > 0) & (pd2 >= pd_i) & ((pd2 - pd_i) < est)
        sc = torch.where(m, score2, 0)
        s = sc.max(dim=1).values
        nmax = ((sc == s[:, None]) & (s[:, None] > 0)).sum(dim=1)
        j = torch.argmax(sc, dim=1)  # the first maximum
        ok = (score1[:, i] > 0) & (s > 0) & (nmax == 1)
        pj = paired2[ar, j]  # the mate's current owner, or -1
        owner_score = score1[ar, pj.clamp(min=0).long()]
        steal = (pj >= 0) & (score1[:, i] > owner_score)
        do = ok & ((pj < 0) | steal)
        stolen = do & steal
        paired1[ar[stolen], pj[stolen].long()] = -1
        paired1[:, i] = torch.where(do, j.to(i32), paired1[:, i])
        paired2[ar[do], j[do]] = i
        pairing |= do
    return paired1, paired2, pairing


def pair_candidates(score1, pd1, score2, pd2, est):
    """(paired1, paired2, pairing) of pair_candidates_plain.  CPU tensors run
    the plain version, CUDA tensors the kernel."""
    if score1.device.type == "cuda":
        from ..kernels import pair_candidates as kernel

        return kernel(score1, pd1, score2, pd2, int(est))
    if score1.device.type != "cpu":
        raise ValueError(f"pair_candidates: unsupported device {score1.device}")
    return pair_candidates_plain(score1, pd1, score2, pd2, int(est))


def _slots(cands_lists, width: int):
    """(scores, posdiffs) (P, width) int32 of P candidate lists, 0 past each list."""
    P = len(cands_lists)
    n = np.array([len(c) for c in cands_lists], dtype=np.int64)
    score = np.zeros((P, width), np.int32)
    pd = np.zeros((P, width), np.int32)
    flat = [c for cands in cands_lists for c in cands]
    if flat:
        rows = np.repeat(np.arange(P), n)
        cols = np.arange(len(flat)) - np.repeat(np.cumsum(n) - n, n)
        score[rows, cols] = int32_array([c.score for c in flat], "candidate score")
        pd[rows, cols] = int32_array([c.posdiff for c in flat], "candidate posdiff")
    return score, pd


def pair_chunk_on_device(est_distance: int, pairs, *, device):
    """pairs: (cands1, cands2) Candidate lists of a chunk's read pairs, already
    through the reference's >1000 pre-prune.  Mates them all on `device`,
    writes paired_idx back into every Candidate and returns the pairs'
    `pairing` flags."""
    P = len(pairs)
    if P == 0:
        return []
    C1 = max(1, max(len(a) for a, _ in pairs))
    C2 = max(1, max(len(b) for _, b in pairs))
    s1, d1 = _slots([a for a, _ in pairs], C1)
    s2, d2 = _slots([b for _, b in pairs], C2)

    def put(a):
        return torch.from_numpy(a).to(device)

    p1, p2, flag = (x.cpu().numpy() for x in pair_candidates(put(s1), put(d1), put(s2),
                                                             put(d2), int(est_distance)))
    out = []
    for p, (a, b) in enumerate(pairs):
        for i, c in enumerate(a):
            c.paired_idx = int(p1[p, i])
        for j, c in enumerate(b):
            c.paired_idx = int(p2[p, j])
        out.append(bool(flag[p]))
    return out
