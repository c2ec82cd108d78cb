"""Batched Needleman-Wunsch decision planes on PyTorch tensors.

Counterpart of `kart_tpu/ops/nw.py`.  `nw_batch_planes` does the work of
both of its Pallas kernels (`_nw_kernel` for 16/32 tiles and
`_nw_kernel_wave` for 64/128 tiles): the 3-matrix affine-gap DP of the
reference (src/nw_alignment.cpp:18-80) over a padded (lm x lm) tile per
fragment pair, emitting (lm+1, lm+1) uint8 decision bits per pair (bit0:
s==r, bit1: s==t).  The backtrace stays on the host (`nw_backtrace`).

Scores are doubled integers (+3/-3 substitution, -3 new gap, -1 extend,
-2 open, MAX_PENALTY -131072): every float32 value of the reference DP is
a multiple of 0.5 well below 2**17 in magnitude, so the doubled int32 DP is
exact and its ties, hence its bits, are the reference's.

On CPU tensors the plain version below runs; on CUDA tensors the
hand-written kernel `csrc/nw.cu` (kernels.nw_planes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.format import NT4_TABLE

from ..pipeline.conquer import nw_alignment

# doubled reference scores (pipeline/conquer.py: -65536, -1, -0.5, -1.5, +-1.5)
MAX_PENALTY = -131072
OPEN_GAP = -2
EXTEND_GAP = -1
NEW_GAP = -3
MATCH, MISMATCH = 3, -3

_TILES = (16, 32, 64, 128)  # beyond the largest: host DP

# device-vs-host fragment coverage (observability; reset at will)
nw_stats = {"device": 0, "host": 0}


def nw_batch_planes_plain(c1: torch.Tensor, c2: torch.Tensor, *, lm: int) -> torch.Tensor:
    """Plain version: anti-diagonal sweep vectorised over the batch.
    c1, c2 (N, lm) int8 codes -> (N, lm+1, lm+1) uint8 planes."""
    n = c1.shape[0]
    lp = lm + 1
    dev = c1.device
    i32 = torch.int32
    gap = OPEN_GAP + EXTEND_GAP * torch.arange(lp, dtype=i32, device=dev)
    r = torch.full((n, lp, lp), MAX_PENALTY, dtype=i32, device=dev)
    t = torch.full((n, lp, lp), MAX_PENALTY, dtype=i32, device=dev)
    s = torch.zeros((n, lp, lp), dtype=i32, device=dev)
    r[:, 0, :] = gap
    t[:, :, 0] = gap
    s[:, 0, :] = gap
    s[:, :, 0] = gap
    r[:, 0, 0] = t[:, 0, 0] = s[:, 0, 0] = 0
    # sub[i-1, j-1]: code equality (N == N matches; the two pads differ)
    eq = c1.to(i32)[:, :, None] == c2.to(i32)[:, None, :]
    sub = torch.where(eq, MATCH, MISMATCH).to(i32)
    for d in range(2, 2 * lm + 1):
        i = torch.arange(max(1, d - lm), min(lm, d - 1) + 1, device=dev)
        j = d - i
        rv = torch.maximum(r[:, i, j - 1] + EXTEND_GAP, s[:, i, j - 1] + NEW_GAP)
        tv = torch.maximum(t[:, i - 1, j] + EXTEND_GAP, s[:, i - 1, j] + NEW_GAP)
        sv = torch.maximum(torch.maximum(s[:, i - 1, j - 1] + sub[:, i - 1, j - 1], rv), tv)
        r[:, i, j] = rv
        t[:, i, j] = tv
        s[:, i, j] = sv
    return ((s == r).to(torch.uint8) | ((s == t).to(torch.uint8) << 1)).contiguous()


def nw_batch_planes(c1: torch.Tensor, c2: torch.Tensor, *, lm: int) -> torch.Tensor:
    """DP decision planes for a batch of fragment pairs.

    c1, c2: (N, lm) int8 codes padded with 4 / 5 (pads differ so padding
    never matches), real ambiguous bases as 6.  Returns (N, lm+1, lm+1)
    uint8.  lm is one of 16, 32, 64, 128."""
    if lm not in _TILES:
        raise ValueError(f"nw_batch_planes: lm={lm} not in {_TILES}")
    if c1.device.type == "cuda":
        from ..kernels import nw_planes

        return nw_planes(c1, c2, lm=lm)
    if c1.device.type != "cpu":
        raise ValueError(f"nw_batch_planes: unsupported device {c1.device}")
    return nw_batch_planes_plain(c1, c2, lm=lm)


def nw_backtrace(eq: np.ndarray, s1: bytes, s2: bytes) -> tuple[bytes, bytes]:
    """Reconstruct the gapped strings from one pair's decision bitplane,
    walking exactly like the reference backtrace (r first, then t;
    boundary cells: j>0&i==0 -> r-move, i>0&j==0 -> t-move, which the
    boundary init guarantees via s==r / s==t there)."""
    i, j = len(s1), len(s2)
    out1 = bytearray()
    out2 = bytearray()
    while i > 0 or j > 0:
        b = eq[i, j]
        if b & 1:
            out1.append(0x2D)
            out2.append(s2[j - 1])
            j -= 1
        elif b & 2:
            out1.append(s1[i - 1])
            out2.append(0x2D)
            i -= 1
        else:
            out1.append(s1[i - 1])
            out2.append(s2[j - 1])
            i -= 1
            j -= 1
    out1.reverse()
    out2.reverse()
    return bytes(out1), bytes(out2)


def encode_tile(pairs, lm: int) -> tuple[np.ndarray, np.ndarray]:
    """(s1, s2) ASCII pairs -> (N, lm) int8 code arrays, padded with 4 (c1)
    and 5 (c2); real ambiguous bases share code 6 so N == N matches as in
    the reference's nst_nt4 comparison, while padding never matches."""
    n = len(pairs)
    c1 = np.full((n, lm), 4, np.int8)
    c2 = np.full((n, lm), 5, np.int8)
    for k, (a, b) in enumerate(pairs):
        ca = NT4_TABLE[np.frombuffer(a, np.uint8)].astype(np.int8)
        cb = NT4_TABLE[np.frombuffer(b, np.uint8)].astype(np.int8)
        ca[ca == 4] = 6
        cb[cb == 4] = 6
        c1[k, : len(a)] = ca
        c2[k, : len(b)] = cb
    return c1, c2


def _nw_tile_batch(pairs, lm: int, device) -> list[tuple[bytes, bytes]]:
    c1, c2 = encode_tile(pairs, lm)
    eq = nw_batch_planes(
        torch.from_numpy(c1).to(device), torch.from_numpy(c2).to(device), lm=lm
    ).cpu().numpy()
    return [nw_backtrace(eq[k], a, b) for k, (a, b) in enumerate(pairs)]


def nw_align_batch(pairs: list[tuple[bytes, bytes]], *, device) -> list[tuple[bytes, bytes]]:
    """Align a batch of (s1, s2) ASCII fragment pairs on `device`; returns
    gapped (a1, a2) pairs, each identical to the host DP's
    nw_alignment(s1, s2).

    Pairs are grouped into the smallest tile (16, 32, 64, 128) that holds
    both strings; pairs longer than 128 run the host DP."""
    if not pairs:
        return []
    buckets: dict[int, list[int]] = {}
    host_idx = []
    for k, (a, b) in enumerate(pairs):
        m = max(len(a), len(b))
        t = next((t for t in _TILES if t >= m), None)
        if t is None:
            host_idx.append(k)
        else:
            buckets.setdefault(t, []).append(k)
    out: list = [None] * len(pairs)
    for t, idxs in sorted(buckets.items()):
        res = _nw_tile_batch([pairs[k] for k in idxs], t, device)
        for k, r in zip(idxs, res):
            out[k] = r
        nw_stats["device"] += len(idxs)
    for k in host_idx:
        out[k] = nw_alignment(*pairs[k])
    nw_stats["host"] += len(host_idx)
    return out
