"""Occurrence expansion, SA resolution and stream packing on PyTorch
tensors.

Counterpart of `kart_tpu/ops/resolve.py` (`expand_resolve`,
`decode_resolved_counts`), of `_resolver` and of `_pack_stream` in
`kart_tpu/ops/pack.py`.  `resolve_pack` turns a packed seed array (the
funnel's (B, 2 + 4*S) or the FM stepper's (B, 1 + 4*S)) into the stream the
host downloads, resolving each occurrence's SA row through the full SA
(one gather) or, where the full SA is absent, through the sampled SA
(`fm_search.sa_walk`).  On CPU tensors it composes the plain versions
below; on CUDA tensors it launches the hand-written kernel
`csrc/resolve_pack.cu` (kernels.resolve_pack).

The stream (see kart_tpu's expand_resolve): per-read counts `cnts` (B,),
`tot` when the read's occurrences are in the stream and `-tot-1` when it
must be re-seeded (over the budget, flagged by the seeder, or a walk cut at
max_steps); `meta` (H,) = rpos | slen << 16 per occurrence and `gpos` (H,)
its text position in the lookup's dtype, both -1 past the last occurrence.
A read fits the budget H whole or not at all, so the reads that do not fit
are a suffix of the batch.  With int32 positions the three are one int32
array; int64 positions leave as the tuple (cnts, meta, gpos).
"""

from __future__ import annotations

import numpy as np
import torch

from .fm_search import SA_WALK_MAX_STEPS, sa_walk


def decode_resolved_counts(cnts: np.ndarray):
    """Host side: decode the cnts encoding -> (ok (B,) bool, tot (B,)
    int32, offs (B+1,) int64 stream offsets)."""
    ok = cnts >= 0
    tot = np.where(ok, cnts, -cnts - 1).astype(np.int64)
    offs = np.zeros(len(tot) + 1, dtype=np.int64)
    np.cumsum(tot, out=offs[1:])
    return ok, tot.astype(np.int32), offs


def full_lookup(sa_full: torch.Tensor):
    """The full-SA lookup: rows -> (sa_full[rows], all done)."""
    return lambda rows: (sa_full[rows.long()], torch.ones_like(rows, dtype=torch.bool))


def sampled_lookup(fm, max_steps: int = SA_WALK_MAX_STEPS):
    """The sampled-SA lookup: rows -> sa_walk's (pos, done)."""
    return lambda rows: sa_walk(fm, rows, max_steps=max_steps)


def expand_resolve_plain(lookup, n_seeds, rpos, slen, k0, freq, ok_in, *, occ_budget):
    """Flat resolved occurrence stream (cnts, meta, gpos) from per-read seed
    blocks: n_seeds (B,), rpos/slen/k0/freq (B, S), ok_in (B,) bool; lookup
    maps SA rows (in k0's dtype) to (pos, done).  cnts and meta are int32,
    gpos in the lookup's dtype.  A read any of whose walks is not done is
    flagged.  Occurrence order: seed emission order, then SA-row order."""
    B, S = rpos.shape
    H = int(occ_budget)
    dev = rpos.device
    i32 = torch.int32
    sidx = torch.arange(S, device=dev)[None, :] < n_seeds[:, None]
    f = torch.where(sidx, freq, 0).to(i32)
    tot = f.sum(dim=1, dtype=i32)
    f_flat = f.reshape(-1)
    cum = torch.cumsum(f_flat, 0, dtype=i32)
    start = cum - f_flat
    total = cum[-1]
    fits = torch.cumsum(tot, 0, dtype=i32) <= H

    # slot of occurrence j: the first (read, seed) whose inclusive prefix
    # count exceeds j (the stream past the total is masked below)
    jh = torch.arange(H, dtype=i32, device=dev)
    slot_c = torch.searchsorted(cum, jh, right=True).clamp(max=B * S - 1)
    lane = slot_c // S
    valid = (jh < total) & fits[lane]
    off = jh - start[slot_c]
    rows = k0.reshape(-1)[slot_c] + off.to(k0.dtype)
    gpos, done = lookup(torch.where(valid, rows, 1).to(k0.dtype))
    # an unresolved walk (max_steps cut) invalidates its whole read
    undone = torch.zeros(B, dtype=i32, device=dev)
    undone.scatter_reduce_(0, lane.long(), (valid & ~done).to(i32), "amax")
    ok = ok_in & fits & (undone == 0)
    meta = rpos.reshape(-1)[slot_c].to(i32) | (slen.reshape(-1)[slot_c].to(i32) << 16)
    meta = torch.where(valid, meta, -1)
    gpos = torch.where(valid, gpos, -1).to(gpos.dtype)
    cnts = torch.where(ok, tot, -tot - 1).to(i32)
    return cnts, meta, gpos


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def pack_stream_plain(cnts, meta, gpos, pack16: bool = False):
    """kart_tpu's _pack_stream: for int32 gpos one (B + 2H,) int32 array,
    or with pack16 (B/2 + H/2 + H,): cnts as int16 pairs, meta as 16-bit
    rpos | (slen-1) << 8 pairs, then gpos.  pack16 wraps cnts to 16 bits
    and turns meta's -1 fill into 0xFEFF, as kart_tpu does.  int64 gpos
    leaves as the (cnts, meta, gpos) tuple, whatever pack16 says."""
    if gpos.dtype != torch.int32:
        return cnts, meta, gpos
    if not pack16:
        return torch.cat([cnts, meta, gpos])
    B, H = cnts.shape[0], meta.shape[0]
    if B % 2 or H % 2:
        raise ValueError(f"pack16 needs an even batch and budget, got B={B} H={H}")
    c16 = cnts.long() & 0xFFFF
    cw = _wrap_i32(c16[0::2] | (c16[1::2] << 16))
    m = meta.long()
    m16 = ((m & 0xFF) | ((((m >> 16) & 0xFFFF) - 1) << 8)) & 0xFFFF
    mw = _wrap_i32(m16[0::2] | (m16[1::2] << 16))
    return torch.cat([cw, mw, gpos])


def seed_fields(packed: torch.Tensor, max_seeds: int, has_ok: bool) -> dict:
    """Fields of a packed seed array: the funnel's (has_ok: an `ok` column
    after n_seeds) or the FM stepper's (no such column, every read ok)."""
    c = 2 if has_ok else 1
    S = max_seeds
    n = packed.shape[0]
    ok = packed[:, 1] != 0 if has_ok else torch.ones(n, dtype=torch.bool, device=packed.device)
    return dict(
        n_seeds=packed[:, 0], ok=ok,
        rpos=packed[:, c : c + S], slen=packed[:, c + S : c + 2 * S],
        k0=packed[:, c + 2 * S : c + 3 * S], freq=packed[:, c + 3 * S : c + 4 * S],
    )


def resolve_pack_plain(sa_full, packed, *, max_seeds, has_ok, occ_budget, pack16, fm=None,
                       max_steps=SA_WALK_MAX_STEPS):
    """expand_resolve_plain, then pack_stream_plain, of a packed seed array;
    sa_full None resolves through fm's sampled SA, walks cut at max_steps."""
    o = seed_fields(packed, max_seeds, has_ok)
    lookup = full_lookup(sa_full) if sa_full is not None else sampled_lookup(fm, max_steps)
    return pack_stream_plain(
        *expand_resolve_plain(lookup, o["n_seeds"], o["rpos"], o["slen"], o["k0"], o["freq"],
                              o["ok"], occ_budget=occ_budget),
        pack16=pack16,
    )


def resolve_pack(sa_full, packed, *, max_seeds, has_ok, occ_budget, pack16, fm=None,
                 max_steps=SA_WALK_MAX_STEPS):
    """The resolved stream of a packed seed array: through the full SA
    sa_full, or with sa_full None through the sampled SA of fm (walks cut at
    max_steps flag their reads).  CPU tensors run the plain composition,
    CUDA tensors the kernel."""
    if sa_full is None and fm is None:
        raise ValueError("resolve_pack: neither a full SA nor an FM index to walk")
    kw = dict(max_seeds=max_seeds, has_ok=has_ok, occ_budget=int(occ_budget), pack16=pack16,
              fm=fm, max_steps=max_steps)
    if packed.device.type == "cuda":
        from ..kernels import resolve_pack as kernel

        return kernel(sa_full, packed, **kw)
    if packed.device.type != "cpu":
        raise ValueError(f"resolve_pack: unsupported device {packed.device}")
    return resolve_pack_plain(sa_full, packed, **kw)
